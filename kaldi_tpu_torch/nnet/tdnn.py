"""Multisplice TDNN acoustic model as an nn.Module.

Counterpart of kaldi_tpu/nnet/tdnn.py `Tdnn` (ref: the nnet2 online
multisplice system, steps/nnet2/train_multisplice_accel2.sh). Weights keep
the JAX layout, [in, out], so a params pytree converts leaf for leaf
(kaldi_tpu_torch.params). They come from the JAX tree, from the caller, or
from `init`, which draws them with torch's generator (the stddevs of the
JAX init, not its draws).

The parameters do not require gradients: inference builds no autograd
graph. Training is functional (nnet/train.py): it passes a params dict,
named as `state_dict()` names it, through `torch.func.functional_call`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from kaldi_tpu_torch.nnet.components import (ACTIVATIONS, affine_init,
                                             normalize, pnorm, splice,
                                             splice_valid)


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

    def __init__(self, config: TdnnConfig, device=None):
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

    @classmethod
    def from_params(cls, config: TdnnConfig, params: dict,
                    device=None) -> "Tdnn":
        """A Tdnn shaped by a params dict (named as `state_dict()` names
        it) and holding it: the input, hidden and output widths and the
        number of hidden layers come from the params, the rest from
        `config`, as JAX's `apply` reads the widths from its params (after
        `surgery.widen`, `replace_last_layers` or a mixup)."""
        n = len({k.split(".")[1] for k in params if k.startswith("layers.")})
        w0 = params["layers.0.w"]
        cfg = dataclasses.replace(
            config, splice_indexes=tuple(config.splice_indexes[:n]),
            feat_dim=w0.shape[0] // len(config.splice_indexes[0]),
            hidden_dim=w0.shape[1], num_pdfs=params["final.w"].shape[1])
        model = cls(cfg, device=device)
        model.load_state_dict(params)
        return model

    def params(self) -> dict[str, torch.Tensor]:
        """A copy of the weights as a params dict, named as `state_dict()`
        names them (what the train step takes)."""
        return {k: v.detach().clone() for k, v in self.state_dict().items()}

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None
             ) -> dict[str, torch.Tensor]:
        """Draw the weights in place, as `Tdnn.init` does in JAX: hidden
        layers with `affine_init`'s stddevs, the final affine all zeros.
        -> `params()`."""
        dev = self.final.w.device
        for layer in self.layers:
            new = affine_init(generator, *layer.w.shape, device=dev)
            layer.w.copy_(new["w"])
            layer.b.copy_(new["b"])
        self.final.w.zero_()
        self.final.b.zero_()
        return self.params()

    def context_of(self, num_layers: int) -> tuple[int, int]:
        """(left, right) context of the first `num_layers` layers."""
        sp = self.config.splice_indexes[:num_layers]
        lc = -sum(min(c) for c in sp if min(c) < 0)
        rc = sum(max(c) for c in sp if max(c) > 0)
        return lc, rc

    def num_params(self, params: dict | None = None) -> int:
        """Parameter count of `params` (default: the module's own)."""
        leaves = (params.values() if params is not None
                  else self.parameters())
        return sum(p.numel() for p in leaves)

    def _nonlin(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.nonlinearity == "pnorm":
            x = pnorm(x, cfg.pnorm_output_dim)
        else:
            x = ACTIVATIONS["relu"](x)
        return normalize(x)

    def forward(self, feats: torch.Tensor, pad_context: bool = True,
                compute_dtype: torch.dtype | None = None,
                num_layers: int | None = None) -> torch.Tensor:
        """pad_context=True clamps at utterance edges (output T == input T);
        False uses valid frames only.

        compute_dtype=torch.bfloat16 is the serving and training fast path:
        each layer's splice is folded into one bf16 matmul per offset, the
        partial products are summed in bf16 (as the JAX code's bf16
        `acc + part` does), then cast to f32 for the bias. Activations,
        normalize and log-softmax stay f32. Under autograd the gradients
        flow back through the same bf16 products and are cast to f32 at
        the weights' `.to`, as JAX's `astype` does.

        num_layers runs only the first k hidden layers before the final
        affine (layer-wise pretraining, `train_progressive`)."""
        cfg = self.config
        ctxs = cfg.splice_indexes[:num_layers]
        layers = list(self.layers)[:num_layers]
        x = feats
        if compute_dtype is None:
            sp = splice if pad_context else splice_valid
            for ctx, layer in zip(ctxs, layers):
                x = self._nonlin(torch.matmul(sp(x, ctx), layer.w) + layer.b)
            logits = torch.matmul(x, self.final.w) + self.final.b
            return torch.log_softmax(logits, dim=-1)
        for ctx, layer in zip(ctxs, layers):
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

    def apply_logits(self, feats: torch.Tensor,
                     pad_context: bool = True) -> torch.Tensor:
        """The f32 net without the log-softmax: [..., T(out), num_pdfs]."""
        sp = splice if pad_context else splice_valid
        x = feats
        for ctx, layer in zip(self.config.splice_indexes, self.layers):
            x = self._nonlin(torch.matmul(sp(x, ctx), layer.w) + layer.b)
        return torch.matmul(x, self.final.w) + self.final.b

    def hidden_mean_abs(self, feats: torch.Tensor,
                        pad_context: bool = True) -> list[torch.Tensor]:
        """Per-layer mean |activation| of each hidden unit: of the affine
        output before a pnorm, of the relu output before normalize (the
        statistic nnet-am-fix thresholds; ref: nnet2/nnet-fix.h FixNnet).
        -> list of [hidden_dim] tensors, one per hidden layer."""
        cfg = self.config
        sp = splice if pad_context else splice_valid
        x = feats
        stats = []
        for ctx, layer in zip(cfg.splice_indexes, self.layers):
            x = torch.matmul(sp(x, ctx), layer.w) + layer.b
            if cfg.nonlinearity == "pnorm":
                stats.append(x.abs().reshape(-1, x.shape[-1]).mean(dim=0))
                x = pnorm(x, cfg.pnorm_output_dim)
            else:
                x = ACTIVATIONS["relu"](x)
                stats.append(x.abs().reshape(-1, x.shape[-1]).mean(dim=0))
            x = normalize(x)
        return stats
