"""Neural-net building blocks on tensors.

Counterpart of kaldi_tpu/nnet/components.py (ref: nnet2/nnet-component.h
PnormComponent :514, NormalizeComponent :555, SpliceComponent :1092,
MaxoutComponent, DropoutComponent, FixedAffineComponent).
Splicing over time offsets is a clamped gather along T.

A random draw (dropout's keep mask) comes from a `torch.Generator`
through its own helper, and the component takes the drawn mask: JAX draws
from a `jax.random` key, which torch cannot reproduce, so a test hands
the component JAX's draw.
"""

from __future__ import annotations

import math

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


def affine_init(generator: torch.Generator | None, in_dim: int, out_dim: int,
                param_stddev: float | None = None, bias_stddev: float = 1.0,
                device=None) -> dict[str, torch.Tensor]:
    """{"w": [in, out], "b": [out]} drawn from N(0, stddev^2) on the
    generator's device, then moved to `device` (ref: nnet2
    AffineComponent init: weight stddev 1/sqrt(in_dim), bias stddev 1).
    The draws are torch's, not jax.random's: only the stddevs match."""
    if param_stddev is None:
        param_stddev = 1.0 / math.sqrt(in_dim)
    gdev = generator.device if generator is not None else None
    w = torch.randn(in_dim, out_dim, generator=generator, device=gdev)
    b = torch.randn(out_dim, generator=generator, device=gdev)
    return {"w": (param_stddev * w).to(device or w.device),
            "b": (bias_stddev * b).to(device or b.device)}


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


def maxout(x: torch.Tensor, output_dim: int) -> torch.Tensor:
    """Group max: [..., D] -> [..., output_dim] over contiguous groups of
    D // output_dim (ref: nnet2 MaxoutComponent)."""
    g = x.shape[-1] // output_dim
    return torch.amax(x.reshape(x.shape[:-1] + (output_dim, g)), dim=-1)


def bernoulli_mask(generator: torch.Generator | None, keep: float, shape,
                   device=None) -> torch.Tensor:
    """A bool mask, True with probability `keep`, drawn on the generator's
    device and moved to `device`."""
    gdev = generator.device if generator is not None else None
    u = torch.rand(shape, generator=generator, device=gdev)
    return (u < keep).to(device or u.device)


def dropout_masked(x: torch.Tensor, mask: torch.Tensor,
                   proportion: float) -> torch.Tensor:
    """Scale-preserving dropout with a given keep mask: x / keep where the
    mask holds, else 0."""
    keep = 1.0 - proportion
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


def dropout(generator: torch.Generator | None, x: torch.Tensor,
            proportion: float) -> torch.Tensor:
    """(ref: nnet2 DropoutComponent, scale-preserving) The keep mask is
    drawn by `bernoulli_mask`; `dropout_masked` applies it."""
    mask = bernoulli_mask(generator, 1.0 - proportion, x.shape, x.device)
    return dropout_masked(x, mask, proportion)


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1 + torch.abs(x))


ACTIVATIONS = {
    "relu": torch.relu,                   # RectifiedLinearComponent
    "sigmoid": torch.sigmoid,             # SigmoidComponent
    "tanh": torch.tanh,                   # TanhComponent
    "softsign": softsign,
}


def fixed_affine(x: torch.Tensor, mat: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ mat (+ bias) (ref: nnet2 FixedAffineComponent, e.g. an LDA-like
    input transform)."""
    y = torch.matmul(x, mat)
    return y + bias if bias is not None else y
