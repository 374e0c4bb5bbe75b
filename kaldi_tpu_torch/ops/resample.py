"""Sample-rate conversion with windowed-sinc filters.

(ref: feat/resample.h:95 LinearResample (rational-ratio streaming-capable),
 :147 ArbitraryResample.) The polyphase filter bank is a host-built
constant; applying it is a gather + matmul, so batched resampling runs as
one tensor program.

The port's counterpart of kaldi_tpu/ops/resample.py: the filters are
built on the host as in JAX (copied verbatim); applying them is an f64
gather-and-dot over every output sample at once on a device (the card by
default), returned as float32 as JAX returns it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device


def _hanning_sinc(t, cutoff, window_width):
    """Windowed sinc at offsets t (seconds), lowpass `cutoff` Hz."""
    t = np.asarray(t, np.float64)
    win = np.where(
        np.abs(t) < window_width,
        0.5 * (1 + np.cos(math.pi * t / window_width)),
        0.0,
    )
    sinc = np.where(t == 0.0, 2 * cutoff,
                    np.sin(2 * math.pi * cutoff * np.where(t == 0, 1.0, t))
                    / (math.pi * np.where(t == 0, 1.0, t)))
    return win * sinc


class LinearResample:
    """Rational-ratio resampler (ref: resample.h:95)."""

    def __init__(self, samp_rate_in: float, samp_rate_out: float,
                 filter_cutoff: float | None = None,
                 num_zeros: int = 6):
        self.rate_in = float(samp_rate_in)
        self.rate_out = float(samp_rate_out)
        if filter_cutoff is None:
            filter_cutoff = 0.99 * 0.5 * min(samp_rate_in, samp_rate_out)
        self.cutoff = filter_cutoff
        g = math.gcd(int(samp_rate_in), int(samp_rate_out))
        self.in_step = int(samp_rate_in) // g    # input samples per block
        self.out_step = int(samp_rate_out) // g  # output samples per block
        window_width = num_zeros / (2.0 * filter_cutoff)
        self.half_width = int(math.ceil(window_width * samp_rate_in))
        # per-phase filters: output sample k (mod out_step) sits at input
        # time (k * rate_in / rate_out)
        filt = np.zeros((self.out_step, 2 * self.half_width + 1))
        self.first_index = np.zeros(self.out_step, np.int64)
        for phase in range(self.out_step):
            t_out = phase / self.rate_out
            center = t_out * self.rate_in  # in input samples
            c0 = int(math.floor(center)) - self.half_width
            self.first_index[phase] = c0
            idx = np.arange(2 * self.half_width + 1) + c0
            t = idx / self.rate_in - t_out
            filt[phase] = _hanning_sinc(t, self.cutoff, window_width) \
                / self.rate_in
        self.filters = filt

    def resample_tensor(self, wave: torch.Tensor) -> torch.Tensor:
        """[S] or [B, S] f64 tensor -> the resampled f64 tensor on its
        device: one gather of every output sample's window, dotted with
        its phase's filter."""
        wave = wave.double()
        single = wave.ndim == 1
        if single:
            wave = wave[None]
        B, S = wave.shape
        # number of output samples with t_k = k/rate_out strictly inside
        # [0, S/rate_in): exact integer arithmetic, equivalent to the
        # tick-based count in GetNumOutputSamples(flush=true)
        # (ref: resample.cc:58-101) — plain int() truncation is one short
        # for non-divisible lengths (e.g. S=239 at 16k->8k: 120, not 119)
        prod = S * int(round(self.rate_out))
        den = int(round(self.rate_in))
        n_out = prod // den + (1 if prod % den else 0)
        pad = self.half_width + self.in_step + 1
        padded = torch.nn.functional.pad(wave, (pad, pad))
        dev = wave.device
        L = self.filters.shape[1]
        k = torch.arange(n_out, device=dev)
        phase = k % self.out_step
        starts = (k // self.out_step) * self.in_step + pad + torch.as_tensor(
            self.first_index, device=dev)[phase]
        gather = padded[:, starts[:, None] + torch.arange(L, device=dev)]
        filt = torch.as_tensor(self.filters, device=dev)[phase]
        out = torch.einsum("bnl,nl->bn", gather, filt)
        return out[0] if single else out

    def resample(self, wave: np.ndarray, device="cuda") -> np.ndarray:
        """[S] or [B, S] -> resampled, computed on `device`."""
        x = torch.as_tensor(np.asarray(wave, np.float64),
                            device=resolve_device(device))
        return self.resample_tensor(x).cpu().numpy().astype(np.float32)


class ArbitraryResample:
    """Evaluate the signal at arbitrary time points (ref: resample.h:147)."""

    def __init__(self, num_samples_in: int, samp_rate_in: float,
                 filter_cutoff: float, sample_points: np.ndarray,
                 num_zeros: int = 6):
        self.rate_in = samp_rate_in
        window_width = num_zeros / (2.0 * filter_cutoff)
        half = int(math.ceil(window_width * samp_rate_in))
        self.indices = []
        self.weights = []
        for t in np.asarray(sample_points, np.float64):
            center = t * samp_rate_in
            c0 = int(math.floor(center)) - half
            idx = np.arange(2 * half + 1) + c0
            tt = idx / samp_rate_in - t
            w = _hanning_sinc(tt, filter_cutoff, window_width) / samp_rate_in
            ok = (idx >= 0) & (idx < num_samples_in)
            self.indices.append(np.where(ok, idx, 0))
            self.weights.append(np.where(ok, w, 0.0))
        self.indices = np.stack(self.indices)
        self.weights = np.stack(self.weights)

    def resample(self, wave: np.ndarray, device="cuda") -> np.ndarray:
        dev = resolve_device(device)
        wave = torch.as_tensor(np.asarray(wave, np.float64), device=dev)
        single = wave.ndim == 1
        if single:
            wave = wave[None]
        out = torch.einsum("bnl,nl->bn",
                           wave[:, torch.as_tensor(self.indices, device=dev)],
                           torch.as_tensor(self.weights, device=dev))
        out = out.cpu().numpy().astype(np.float32)
        return out[0] if single else out


def resample_waveform(wave, rate_in: float, rate_out: float,
                      device="cuda") -> np.ndarray:
    return LinearResample(rate_in, rate_out).resample(wave, device=device)
