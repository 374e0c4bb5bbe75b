"""Signal processing: FFT convolution, reverberation.

(ref: feat/signal.h:30-44 ConvolveSignals / FFTbasedBlockConvolveSignals,
 featbin/wav-reverberate.cc.)

The port's counterpart of kaldi_tpu/ops/signal.py. The convolution is an
f64 `torch.fft.rfft` / `irfft` product at JAX's power-of-two `nfft` on a
device (the card by default); `reverberate` is JAX's host code around it,
drawing its noise from the caller's numpy `RandomState` as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device


def fft_convolve(x: torch.Tensor, h: torch.Tensor, n_out: int) -> torch.Tensor:
    """f64 linear convolution of x [..., S] with h [K] by one rfft product
    at the power of two above S + K - 1 (JAX's nfft), cut to n_out
    samples: a tensor on x's device."""
    n = x.shape[-1] + h.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    spec = torch.fft.rfft(x.double(), nfft) * torch.fft.rfft(h.double(), nfft)
    return torch.fft.irfft(spec, nfft)[..., :n_out]


def convolve_signals(signal: np.ndarray, filt: np.ndarray,
                     device="cuda") -> np.ndarray:
    """Full FFT-based convolution, output length = len(signal)
    (matching the reference's in-place semantics); computed in f64 on
    `device`, returned as float32 as JAX returns it."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(signal, np.float64), device=dev)
    h = torch.as_tensor(np.asarray(filt, np.float64), device=dev)
    out = fft_convolve(x, h, len(signal))
    return out.cpu().numpy().astype(np.float32)


def reverberate(wave: np.ndarray, rir: np.ndarray,
                snr_db: float | None = None,
                noise: np.ndarray | None = None,
                rng=None, device="cuda") -> np.ndarray:
    """Convolve with a room impulse response, optionally add noise at a
    target SNR (ref: featbin/wav-reverberate.cc)."""
    out = convolve_signals(wave, rir, device=device)
    # energy-normalize to the dry signal
    e_dry = float(np.mean(np.square(wave))) + 1e-10
    e_wet = float(np.mean(np.square(out))) + 1e-10
    out = out * np.sqrt(e_dry / e_wet)
    if snr_db is not None:
        rng = rng or np.random.RandomState(0)
        if noise is None:
            noise = rng.randn(len(out)).astype(np.float32)
        e_sig = float(np.mean(np.square(out))) + 1e-10
        e_noise = float(np.mean(np.square(noise))) + 1e-10
        scale = np.sqrt(e_sig / (e_noise * 10 ** (snr_db / 10.0)))
        out = out + scale * noise[: len(out)]
    return out.astype(np.float32)
