"""Frame extraction and windowing on tensors.

Counterpart of kaldi_tpu/ops/window.py (ref: feat/feature-functions.cc:30-170
NumFrames / Dither / Preemphasize / FeatureWindowFunction / ExtractWindow):
all frames of a batch of utterances come from one gather plus fused
elementwise ops, with no per-frame loop.

Conventions: waveforms are float32 at int16 scale, shape [S] or [B, S];
frame matrices are [F, W] or [B, F, W] with W the padded window size.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

M_2PI = 2.0 * math.pi


def round_up_to_power_of_two(n: int) -> int:
    assert n > 0
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class FrameOpts:
    """Frame extraction options (ref: feat/feature-functions.h FrameExtractionOptions)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular
    round_to_power_of_two: bool = True
    snip_edges: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return round_up_to_power_of_two(self.window_size)
        return self.window_size


def num_frames(num_samples: int, opts: FrameOpts) -> int:
    """Number of frames for an utterance (ref: feature-functions.cc:30 NumFrames)."""
    shift, length = opts.window_shift, opts.window_size
    if opts.snip_edges:
        if num_samples < length:
            return 0
        return 1 + (num_samples - length) // shift
    return int(num_samples * 1.0 / shift + 0.5)


@functools.lru_cache(maxsize=None)
def _window_np(window_type: str, frame_length: int) -> np.ndarray:
    i = np.arange(frame_length, dtype=np.float64)
    cos_term = np.cos(M_2PI * i / (frame_length - 1))
    if window_type == "hanning":
        w = 0.5 - 0.5 * cos_term
    elif window_type == "hamming":
        w = 0.54 - 0.46 * cos_term
    elif window_type == "povey":
        # like hamming but goes to zero at edges (ref: feature-functions.cc:80)
        w = (0.5 - 0.5 * cos_term) ** 0.85
    elif window_type == "rectangular":
        w = np.ones(frame_length)
    else:
        raise ValueError(f"invalid window type {window_type!r}")
    return w.astype(np.float32)


def feature_window(opts: FrameOpts, device=None) -> torch.Tensor:
    """The tapering window vector, shape [window_size]."""
    return torch.as_tensor(_window_np(opts.window_type, opts.window_size),
                           device=device)


def _frame_index_matrix(n_samp: int, n_frames: int, opts: FrameOpts) -> np.ndarray:
    """[F, window_size] int32 sample indices for each frame (host-side, static)."""
    shift, length = opts.window_shift, opts.window_size
    offs = np.arange(length, dtype=np.int64)
    if opts.snip_edges:
        starts = np.arange(n_frames, dtype=np.int64) * shift
        idx = starts[:, None] + offs[None, :]
    else:
        # center frame f at shift*(f+0.5); reflect indices off the edges
        # (ref: feature-functions.cc:106-141)
        mids = (np.arange(n_frames, dtype=np.int64) * shift
                + shift // 2)  # int(shift*(f+0.5)) with integer shift
        begins = mids - length // 2
        idx = begins[:, None] + offs[None, :]
        # reflect: i<0 -> (-i) % n ; i>=n -> n-1-((i-n) % n). This matches
        # THIS reference exactly (feature-functions.cc:123-136 uses
        # reflected_f = -f, i.e. -1 -> 1) — note modern upstream Kaldi's
        # feature-window.cc instead reflects -f-1; do not "fix" to that.
        neg = idx < 0
        idx = np.where(neg, (-idx) % max(n_samp, 1), idx)
        over = idx >= n_samp
        idx = np.where(over, n_samp - 1 - ((idx - n_samp) % max(n_samp, 1)), idx)
    return idx.astype(np.int32)


def frame_signal(wave: torch.Tensor, opts: FrameOpts) -> torch.Tensor:
    """Slice a waveform [S] or [B, S] into frames [F, L] / [B, F, L] (no windowing)."""
    n_samp = wave.shape[-1]
    n_frames = num_frames(n_samp, opts)
    idx = torch.as_tensor(_frame_index_matrix(n_samp, n_frames, opts),
                          device=wave.device).long()
    return wave[..., idx]


def _process_window(frames: torch.Tensor, opts: FrameOpts,
                    window_fn: torch.Tensor,
                    generator: torch.Generator | None,
                    want_raw_energy: bool):
    """Dither / DC-remove / raw-energy / preemphasis / taper.

    frames: [..., F, L]. Returns (windowed [..., F, L], log_raw_energy [..., F]).
    (ref: feature-functions.cc:95-170 ExtractWindow)
    """
    x = frames.to(torch.float32)
    if opts.dither != 0.0 and generator is not None:
        x = x + opts.dither * torch.randn(x.shape, generator=generator,
                                          device=x.device, dtype=torch.float32)
    if opts.remove_dc_offset:
        x = x - torch.mean(x, dim=-1, keepdim=True)
    log_energy = None
    if want_raw_energy:
        e = torch.clamp(torch.sum(x * x, dim=-1),
                        min=torch.finfo(torch.float32).tiny)
        log_energy = torch.log(e)
    if opts.preemph_coeff != 0.0:
        prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        x = x - opts.preemph_coeff * prev
    x = x * window_fn
    return x, log_energy


def extract_windows(wave: torch.Tensor, opts: FrameOpts,
                    generator: torch.Generator | None = None,
                    want_raw_energy: bool = False):
    """Full framing pipeline: wave [..., S] -> (windows [..., F, P], log_raw_energy).

    P = padded window size. Dither is applied only when a generator is given
    (the JAX code dithers only when given a dither key).
    """
    frames = frame_signal(wave, opts)
    windowed, log_energy = _process_window(
        frames, opts, feature_window(opts, wave.device), generator,
        want_raw_energy)
    pad = opts.padded_window_size - opts.window_size
    if pad > 0:
        windowed = torch.nn.functional.pad(windowed, (0, pad))
    return windowed, log_energy
