"""Multisplice TDNN acoustic model as an nn.Module.

Counterpart of kaldi_tpu/nnet/tdnn.py `Tdnn.apply` (ref: the nnet2 online
multisplice system, steps/nnet2/train_multisplice_accel2.sh). Weights keep
the JAX layout, [in, out], so a params pytree converts leaf for leaf
(kaldi_tpu_torch.params). Weights are never initialised here from a random
generator: they come from the JAX tree or from the caller.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from kaldi_tpu_torch.nnet.components import (ACTIVATIONS, normalize, pnorm,
                                             splice, splice_valid)


@dataclasses.dataclass(frozen=True)
class TdnnConfig:
    feat_dim: int = 40
    num_pdfs: int = 2000
    # per-layer splice offsets (nnet2 multisplice notation)
    splice_indexes: tuple = ((-2, -1, 0, 1, 2), (-1, 2), (-3, 3), (-7, 2), (0,))
    hidden_dim: int = 2048        # pnorm input dim
    pnorm_output_dim: int = 256   # pnorm output dim (group 8 by default)
    nonlinearity: str = "pnorm"   # pnorm | relu
    final_hidden: int | None = None

    @property
    def left_context(self) -> int:
        return -sum(min(c) for c in self.splice_indexes if min(c) < 0)

    @property
    def right_context(self) -> int:
        return sum(max(c) for c in self.splice_indexes if max(c) > 0)


class Affine(nn.Module):
    """y = x @ w + b with w [in, out] (the JAX layout)."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim, device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(out_dim, device=device),
                              requires_grad=False)


class Tdnn(nn.Module):
    """forward(feats [..., T, D]) -> log posteriors [..., T(out), num_pdfs]."""

    def __init__(self, config: TdnnConfig, device="cpu"):
        super().__init__()
        self.config = config
        in_dim = config.feat_dim
        layers = []
        for ctx in config.splice_indexes:
            layers.append(Affine(in_dim * len(ctx), config.hidden_dim, device))
            in_dim = (config.pnorm_output_dim if config.nonlinearity == "pnorm"
                      else config.hidden_dim)
        self.layers = nn.ModuleList(layers)
        self.final = Affine(in_dim, config.num_pdfs, device)

    def load_jax_params(self, tree) -> "Tdnn":
        """Copy a kaldi_tpu `Tdnn` params pytree (numpy leaves) in place."""
        from kaldi_tpu_torch.params import tdnn_params_from_jax
        self.load_state_dict(tdnn_params_from_jax(tree))
        return self

    def _nonlin(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.nonlinearity == "pnorm":
            x = pnorm(x, cfg.pnorm_output_dim)
        else:
            x = ACTIVATIONS["relu"](x)
        return normalize(x)

    def forward(self, feats: torch.Tensor, pad_context: bool = True,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """pad_context=True clamps at utterance edges (output T == input T);
        False uses valid frames only.

        compute_dtype=torch.bfloat16 is the serving path: each layer's
        splice is folded into one bf16 matmul per offset, the partial
        products are summed in bf16 (as the JAX code's bf16 `acc + part`
        does), then cast to f32 for the bias. Activations, normalize and
        log-softmax stay f32."""
        cfg = self.config
        x = feats
        if compute_dtype is None:
            sp = splice if pad_context else splice_valid
            for ctx, layer in zip(cfg.splice_indexes, self.layers):
                x = torch.matmul(sp(x, ctx), layer.w) + layer.b
                x = self._nonlin(x)
            logits = torch.matmul(x, self.final.w) + self.final.b
            return torch.log_softmax(logits, dim=-1)
        for ctx, layer in zip(cfg.splice_indexes, self.layers):
            w = layer.w.to(compute_dtype)
            xc = x.to(compute_dtype)
            lo, hi = min(ctx), max(ctx)
            D = xc.shape[-1]
            T = xc.shape[-2]
            if pad_context:
                # edge-clamped splice == edge-replicated pad + slices
                t = torch.arange(-lo + T + hi, device=xc.device) + lo
                xp = xc.index_select(-2, torch.clamp(t, 0, T - 1))
                Tout = T
            else:
                xp = xc
                Tout = T - (hi - lo)
            acc = None
            for k, off in enumerate(ctx):
                part = torch.matmul(xp.narrow(-2, off - lo, Tout),
                                    w[k * D:(k + 1) * D])
                acc = part if acc is None else acc + part
            x = self._nonlin(acc.to(torch.float32) + layer.b)
        logits = torch.matmul(x.to(compute_dtype),
                              self.final.w.to(compute_dtype)
                              ).to(torch.float32) + self.final.b
        return torch.log_softmax(logits, dim=-1)
