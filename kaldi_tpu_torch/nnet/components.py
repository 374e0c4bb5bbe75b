"""Neural-net building blocks on tensors.

Counterpart of kaldi_tpu/nnet/components.py (ref: nnet2/nnet-component.h
PnormComponent :514, NormalizeComponent :555, SpliceComponent :1092).
Splicing over time offsets is a clamped gather along T.
"""

from __future__ import annotations

import torch


def splice(x: torch.Tensor, context: tuple[int, ...]) -> torch.Tensor:
    """x [..., T, D] -> [..., T, D*len(context)], clamped at edges."""
    T = x.shape[-2]
    t = torch.arange(T, device=x.device)
    outs = [x.index_select(-2, torch.clamp(t + off, 0, T - 1))
            for off in context]
    return torch.cat(outs, dim=-1)


def splice_valid(x: torch.Tensor, context: tuple[int, ...]) -> torch.Tensor:
    """Valid-only splice: output T' = T - (max(ctx) - min(ctx))."""
    lo, hi = min(context), max(context)
    Tout = x.shape[-2] - (hi - lo)
    outs = [x.narrow(-2, off - lo, Tout) for off in context]
    return torch.cat(outs, dim=-1)


def pnorm(x: torch.Tensor, output_dim: int, p: float = 2.0) -> torch.Tensor:
    """Group p-norm: [..., D] -> [..., output_dim], D % output_dim == 0."""
    D = x.shape[-1]
    assert D % output_dim == 0, (D, output_dim)
    xg = x.reshape(x.shape[:-1] + (output_dim, D // output_dim))
    if p == 2.0:
        return torch.sqrt(torch.sum(xg * xg, dim=-1) + 1e-20)
    return torch.pow(torch.sum(torch.pow(torch.abs(xg), p), dim=-1) + 1e-20,
                     1.0 / p)


def normalize(x: torch.Tensor, target_rms: float = 1.0) -> torch.Tensor:
    """Renormalize rows to unit RMS."""
    scale = target_rms * torch.rsqrt(
        torch.mean(torch.square(x), dim=-1, keepdim=True) + 1e-20)
    return x * scale


ACTIVATIONS = {
    "relu": torch.relu,                   # RectifiedLinearComponent
}
