"""Sinusoid detection in waveforms (DTMF/tone detection support).

(ref: feat/sinusoid-detection.h — SinusoidDetector fits the two dominant
 sinusoids per frame by FFT peak + quadratic interpolation and iterative
 residual subtraction; MultiSinusoidDetector streams frames. One rfft per
 frame block, vectorized over frames.)

The port's copy of kaldi_tpu/ops/sinusoid.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Sinusoid:
    freq: float
    amplitude: float
    phase: float


def _fit_one(frame: np.ndarray, samp_freq: float):
    """Dominant sinusoid of `frame` via rfft peak + parabolic refinement,
    then least-squares amplitude/phase at the refined frequency."""
    n = len(frame)
    win = np.hanning(n)
    spec = np.fft.rfft(frame * win)
    mag = np.abs(spec)
    k = int(np.argmax(mag[1:-1])) + 1
    # parabolic interpolation on log-magnitude
    a, b, c = np.log(mag[k - 1] + 1e-10), np.log(mag[k] + 1e-10), \
        np.log(mag[k + 1] + 1e-10)
    delta = 0.5 * (a - c) / (a - 2 * b + c + 1e-20)
    freq = (k + delta) * samp_freq / n
    # least-squares fit of A cos(wt) + B sin(wt)
    t = np.arange(n) / samp_freq
    w = 2 * np.pi * freq
    basis = np.stack([np.cos(w * t), np.sin(w * t)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, frame, rcond=None)
    amp = float(np.hypot(coef[0], coef[1]))
    phase = float(np.arctan2(-coef[1], coef[0]))
    return Sinusoid(float(freq), amp, phase), basis @ coef


def detect_sinusoids(frame: np.ndarray, samp_freq: float,
                     max_sinusoids: int = 2,
                     min_energy_ratio: float = 0.02):
    """-> list of Sinusoid, strongest first (residual-subtraction greedy,
    the SinusoidDetector strategy)."""
    x = np.asarray(frame, np.float64).copy()
    total = float(np.sum(x * x)) + 1e-20
    out = []
    for _ in range(max_sinusoids):
        s, fit = _fit_one(x, samp_freq)
        energy = float(np.sum(fit * fit))
        if energy / total < min_energy_ratio:
            break
        out.append(s)
        x = x - fit
    return out


def detect_tones(wave: np.ndarray, samp_freq: float,
                 frame_length: float = 0.025, frame_shift: float = 0.01,
                 max_sinusoids: int = 2):
    """Per-frame sinusoid tracks: [(t_seconds, [Sinusoid, ...])]."""
    n = int(frame_length * samp_freq)
    step = int(frame_shift * samp_freq)
    out = []
    for lo in range(0, len(wave) - n + 1, step):
        out.append((lo / samp_freq,
                    detect_sinusoids(wave[lo: lo + n], samp_freq,
                                     max_sinusoids)))
    return out
