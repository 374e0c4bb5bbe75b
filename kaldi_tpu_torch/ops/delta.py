"""Deltas, splicing, shifted-delta cepstra and sliding-window CMVN on tensors.

Counterpart of kaldi_tpu/ops/delta.py (ref: feat/feature-functions.cc:214-343
DeltaFeatures / SpliceFrames / SlidingWindowCmnInternal :436-520): deltas
are a weighted sum of edge-clamped time shifts (an index_select per tap),
sliding CMVN is cumulative sums plus per-frame window bounds computed on
the host. Everything runs on the features' device, in their dtype; the
sliding CMVN sums in f32, as the JAX code does without x64.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeltaOpts:
    """(ref: feat/feature-functions.h:192-211 DeltaFeaturesOptions)"""

    order: int = 2
    window: int = 2  # actual window size is 2*window+1


@functools.lru_cache(maxsize=None)
def _delta_scales_np(order: int, window: int) -> tuple[np.ndarray, ...]:
    """Per-order regression coefficient windows (ref: feature-functions.cc:214-245)."""
    scales = [np.array([1.0], dtype=np.float64)]
    for i in range(1, order + 1):
        prev = scales[i - 1]
        prev_offset = (len(prev) - 1) // 2
        cur_offset = prev_offset + window
        cur = np.zeros(len(prev) + 2 * window, dtype=np.float64)
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        cur /= normalizer
        scales.append(cur)
    return tuple(s.astype(np.float32) for s in scales)


def _shifted(feats: torch.Tensor, shift: int) -> torch.Tensor:
    """feats[..., clip(t + shift, 0, T-1), :]."""
    T = feats.shape[-2]
    idx = torch.clamp(torch.arange(T, device=feats.device) + shift, 0, T - 1)
    return feats.index_select(-2, idx)


def add_deltas(feats: torch.Tensor, order: int = 2,
               window: int = 2) -> torch.Tensor:
    """[..., T, D] -> [..., T, D*(order+1)] with edge-clamped regression deltas."""
    outs = []
    for scale in _delta_scales_np(order, window):
        offset = (len(scale) - 1) // 2
        acc = torch.zeros_like(feats)
        for j, w in enumerate(scale):
            if w == 0.0:
                continue
            acc = acc + float(w) * _shifted(feats, j - offset)
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def splice_frames(feats: torch.Tensor, left_context: int,
                  right_context: int) -> torch.Tensor:
    """[..., T, D] -> [..., T, D*(l+r+1)], clamped at the edges.

    (ref: feature-functions.cc:389-411 SpliceFrames)
    """
    return torch.cat([_shifted(feats, off)
                      for off in range(-left_context, right_context + 1)],
                     dim=-1)


def shifted_delta(feats: torch.Tensor, order: int = 1, window: int = 1,
                  block_shift: int = 3, num_blocks: int = 7) -> torch.Tensor:
    """Shifted delta cepstra for language-ID (ref: feature-functions.cc:247-285).

    Output dim = D * (1 + num_blocks): static coefficients followed by
    num_blocks delta blocks taken at t, t+P, t+2P, ...; each regression
    tap's index t + b*P + j clamps to [0, T-1] on its own (ref:
    feature-functions.cc:301-313).
    """
    scale = _delta_scales_np(order, window)[order]
    offset = (len(scale) - 1) // 2
    outs = [feats]
    for b in range(num_blocks):
        d = None
        for j, w in enumerate(scale):
            if w == 0.0:
                continue
            term = float(w) * _shifted(feats, b * block_shift + (j - offset))
            d = term if d is None else d + term
        outs.append(d if d is not None else torch.zeros_like(feats))
    return torch.cat(outs, dim=-1)


@dataclasses.dataclass(frozen=True)
class SlidingCmvnOpts:
    """(ref: feat/feature-functions.h:311-343 SlidingWindowCmnOptions)"""

    cmn_window: int = 600
    min_window: int = 100
    normalize_mean: bool = True
    normalize_variance: bool = False
    center: bool = False


def _window_bounds(T: int, opts: SlidingCmvnOpts):
    """Per-frame [start, end) of the CMVN window (ref:
    feature-functions.cc:445-467), host numpy."""
    t = np.arange(T)
    if opts.center:
        start = t - opts.cmn_window // 2
        end = start + opts.cmn_window
    else:
        start = t - opts.cmn_window
        end = t + 1
    end = np.where(start < 0, end - start, end)
    start = np.maximum(start, 0)
    if not opts.center:
        end = np.where(end > t, np.maximum(t + 1, opts.min_window), end)
    start = np.where(end > T, np.maximum(start - (end - T), 0), start)
    end = np.minimum(end, T)
    return start, end


def sliding_cmvn(feats: torch.Tensor,
                 opts: SlidingCmvnOpts = SlidingCmvnOpts()) -> torch.Tensor:
    """Per-frame sliding-window mean(/variance) normalization, [..., T, D],
    from cumulative sums in f32."""
    T = feats.shape[-2]
    dev = feats.device
    x = feats.to(torch.float32)
    s, e = _window_bounds(T, opts)
    start = torch.as_tensor(s, device=dev)
    end = torch.as_tensor(e, device=dev)
    zero = torch.zeros_like(x[..., :1, :])
    csum = torch.cat([zero, torch.cumsum(x, dim=-2)], dim=-2)
    win_sum = csum.index_select(-2, end) - csum.index_select(-2, start)
    n = torch.as_tensor(e - s, dtype=torch.float32, device=dev)[:, None]
    mean = win_sum / n
    out = x - mean if opts.normalize_mean else x
    if opts.normalize_variance:
        csumsq = torch.cat([zero, torch.cumsum(torch.square(x), dim=-2)],
                           dim=-2)
        win_sumsq = (csumsq.index_select(-2, end)
                     - csumsq.index_select(-2, start))
        var = torch.clamp(win_sumsq / n - torch.square(mean), min=1.0e-10)
        out = torch.where(n > 1, out * torch.rsqrt(var), torch.zeros_like(out))
    return out.to(feats.dtype)
