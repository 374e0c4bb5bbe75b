"""Mel filterbank as a dense [num_bins, num_fft_bins] matrix -> one matmul.

Counterpart of kaldi_tpu/ops/mel.py (ref: feat/mel-computations.cc:33-140,
VTLN warp :144-216). The bank matrix is built once on the host in numpy;
the JAX module imports jax.numpy, so its numpy code is carried here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from kaldi_tpu_torch.ops.window import FrameOpts


@dataclasses.dataclass(frozen=True)
class MelOpts:
    """(ref: feat/mel-computations.h MelBanksOptions)"""

    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 means nyquist + high_freq
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    htk_mode: bool = False


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def _vtln_warp_freq(vtln_low, vtln_high, low_freq, high_freq, warp, freq):
    """Piecewise-linear VTLN warp (ref: mel-computations.cc:144-211)."""
    if freq < low_freq or freq > high_freq:
        return freq
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    scale = 1.0 / warp
    Fl = scale * l
    Fh = scale * h
    assert l > low_freq and h < high_freq
    scale_left = (Fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - Fh) / (high_freq - h)
    if freq < l:
        return low_freq + scale_left * (freq - low_freq)
    elif freq < h:
        return scale * freq
    else:
        return high_freq + scale_right * (freq - high_freq)


def _vtln_warp_mel_freq(vtln_low, vtln_high, low_freq, high_freq, warp, mel):
    return mel_scale(
        _vtln_warp_freq(
            vtln_low, vtln_high, low_freq, high_freq, warp, inverse_mel_scale(mel)
        )
    )


@functools.lru_cache(maxsize=None)
def _mel_banks_np(
    opts: MelOpts, frame_opts: FrameOpts, vtln_warp: float
) -> np.ndarray:
    num_bins = opts.num_bins
    if num_bins < 3:
        raise ValueError("must have at least 3 mel bins")
    sample_freq = frame_opts.samp_freq
    window_length_padded = frame_opts.padded_window_size
    assert window_length_padded % 2 == 0
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq

    low_freq = opts.low_freq
    high_freq = opts.high_freq if opts.high_freq > 0.0 else nyquist + opts.high_freq
    if not (0.0 <= low_freq < nyquist and 0.0 < high_freq <= nyquist
            and low_freq < high_freq):
        raise ValueError(f"bad low/high freq {low_freq}/{high_freq} vs nyquist {nyquist}")

    fft_bin_width = sample_freq / window_length_padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    vtln_low = opts.vtln_low
    vtln_high = opts.vtln_high
    if vtln_high < 0.0:
        vtln_high += nyquist

    bin_mels = mel_scale(fft_bin_width * np.arange(num_fft_bins))
    banks = np.zeros((num_bins, num_fft_bins), dtype=np.float32)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        if vtln_warp != 1.0:
            left = _vtln_warp_mel_freq(vtln_low, vtln_high, low_freq, high_freq,
                                       vtln_warp, left)
            center = _vtln_warp_mel_freq(vtln_low, vtln_high, low_freq, high_freq,
                                         vtln_warp, center)
            right = _vtln_warp_mel_freq(vtln_low, vtln_high, low_freq, high_freq,
                                        vtln_warp, right)
        up = (bin_mels - left) / (center - left)
        down = (right - bin_mels) / (right - center)
        w = np.where(bin_mels <= center, up, down)
        w = np.where((bin_mels > left) & (bin_mels < right), w, 0.0)
        if not np.any(w > 0):
            raise ValueError("empty mel bin: --num-mel-bins too large?")
        banks[b] = w.astype(np.float32)
        # HTK bug replication for fixture testing (ref: mel-computations.cc:133)
        if opts.htk_mode and b == 0 and mel_low != 0.0:
            nz = np.nonzero(banks[b])[0]
            if len(nz):
                banks[b, nz[0]] = 0.0
    return banks


def mel_banks(opts: MelOpts, frame_opts: FrameOpts, vtln_warp: float = 1.0,
              device=None) -> torch.Tensor:
    """[num_bins, num_fft_bins] dense filterbank matrix (num_fft_bins = P/2).

    Like the reference, bin num_fft_bins (nyquist) is excluded; callers
    matmul this against power_spectrum[..., :P//2].
    """
    return torch.as_tensor(_mel_banks_np(opts, frame_opts, float(vtln_warp)),
                           device=device)


def center_freqs(opts: MelOpts, frame_opts: FrameOpts, vtln_warp: float = 1.0):
    """Center frequencies of each mel bin (used by PLP equal-loudness)."""
    num_bins = opts.num_bins
    nyquist = 0.5 * frame_opts.samp_freq
    low_freq = opts.low_freq
    high_freq = opts.high_freq if opts.high_freq > 0.0 else nyquist + opts.high_freq
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    vtln_low = opts.vtln_low
    vtln_high = opts.vtln_high + (nyquist if opts.vtln_high < 0 else 0.0)
    out = np.zeros(num_bins, dtype=np.float64)
    for b in range(num_bins):
        center = mel_low + (b + 1) * mel_delta
        if vtln_warp != 1.0:
            center = _vtln_warp_mel_freq(vtln_low, vtln_high, low_freq, high_freq,
                                         vtln_warp, center)
        out[b] = inverse_mel_scale(center)
    return out
