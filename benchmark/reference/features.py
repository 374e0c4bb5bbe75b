"""Plain reference features: Kaldi's fbank and MFCC, deltas, per-utterance
CMVN and energy VAD, written from Kaldi's definitions
(feat/feature-functions.cc, feat/mel-computations.cc,
feat/feature-mfcc.cc, feat/feature-fbank.cc, ivector/voice-activity-
detection.cc) in plain PyTorch. Nothing of the program is imported.

`precision` selects the arithmetic: "f64" is the reference; "tf32" is
one step below the f32 with TF32 off that the configurations state, the
mel and DCT products on TF32; "bf16" is one step below f32 for the rest
(framing, FFT, energies, logs): every intermediate rounded to bfloat16,
the products on bf16 inputs.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def matmul_precision(precision: str):
    """torch's TF32 switch set for `precision` ("tf32" on, else off) and
    put back on exit."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "f64" else torch.float32


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x rounded to bfloat16 (kept in f32) under "bf16", else x."""
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_banks(num_bins: int, samp_freq: float, n_fft: int, low_freq: float,
              high_freq: float) -> np.ndarray:
    """[num_bins, n_fft // 2] triangular filters, equally spaced in mel
    between low_freq and high_freq (high_freq <= 0 counts from Nyquist)."""
    nyq = 0.5 * samp_freq
    hi = high_freq if high_freq > 0 else nyq + high_freq
    ml, mh = _mel(low_freq), _mel(hi)
    delta = (mh - ml) / (num_bins + 1)
    bin_mel = _mel(samp_freq / n_fft * np.arange(n_fft // 2))
    banks = np.zeros((num_bins, n_fft // 2))
    for b in range(num_bins):
        left, center, right = ml + b * delta, ml + (b + 1) * delta, \
            ml + (b + 2) * delta
        up = (bin_mel - left) / (center - left)
        down = (right - bin_mel) / (right - center)
        w = np.where(bin_mel <= center, up, down)
        banks[b] = np.where((bin_mel > left) & (bin_mel < right), w, 0.0)
    return banks


def _frames(wave: torch.Tensor, samp_freq: float, frame_length_ms: float,
            frame_shift_ms: float, precision: str = "f64"):
    """snip-edges framing, DC removal, raw log energy, pre-emphasis 0.97,
    the povey window, zero padding to a power of two -> (windows [F, N],
    log raw energy [F])."""
    length = int(samp_freq * 0.001 * frame_length_ms)
    shift = int(samp_freq * 0.001 * frame_shift_ms)
    x = wave.unfold(0, length, shift)
    x = rounded(x - x.mean(dim=1, keepdim=True), precision)
    tiny = torch.finfo(torch.float32).tiny
    log_e = rounded(torch.log(torch.clamp(
        rounded((x * x).sum(dim=1), precision), min=tiny)), precision)
    x = rounded(x - 0.97 * torch.cat([x[:, :1], x[:, :-1]], dim=1),
                precision)
    i = torch.arange(length, dtype=x.dtype, device=x.device)
    win = (0.5 - 0.5 * torch.cos(2 * math.pi * i / (length - 1))) ** 0.85
    x = rounded(x * rounded(win, precision), precision)
    n_fft = 1 << (length - 1).bit_length()
    return torch.nn.functional.pad(x, (0, n_fft - length)), log_e


def _log_mel(wave, samp_freq, frame_length_ms, frame_shift_ms, num_bins,
             low_freq, high_freq, precision):
    dt = dtype_of(precision)
    win, log_e = _frames(wave.to(dt), samp_freq, frame_length_ms,
                         frame_shift_ms, precision)
    n_fft = win.shape[1]
    spec = torch.fft.rfft(win, dim=1)
    power = rounded((rounded(spec.real, precision) ** 2
                     + rounded(spec.imag, precision) ** 2)[:, : n_fft // 2],
                    precision)
    banks = rounded(torch.as_tensor(
        mel_banks(num_bins, samp_freq, n_fft, low_freq, high_freq),
        dtype=dt, device=wave.device), precision)
    with matmul_precision(precision):
        mel = rounded(power @ banks.T, precision)
    tiny = torch.finfo(torch.float32).tiny
    return rounded(torch.log(torch.clamp(mel, min=tiny)), precision), log_e


def fbank(wave: torch.Tensor, samp_freq: float = 16000.0,
          num_bins: int = 40, low_freq: float = 20.0, high_freq: float = 0.0,
          frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
          precision: str = "f64") -> torch.Tensor:
    """wave [S] -> log mel filterbank [F, num_bins] (no energy)."""
    return _log_mel(wave, samp_freq, frame_length_ms, frame_shift_ms,
                    num_bins, low_freq, high_freq, precision)[0]


def mfcc(wave: torch.Tensor, samp_freq: float, num_bins: int,
         low_freq: float, high_freq: float, num_ceps: int,
         cepstral_lifter: float, frame_length_ms: float = 25.0,
         frame_shift_ms: float = 10.0, precision: str = "f64"
         ) -> torch.Tensor:
    """wave [S] -> MFCC [F, num_ceps] with C0 replaced by the raw log
    energy: the DCT-II of the log mel energies (row 0 sqrt(1/N), the rest
    sqrt(2/N)), liftered by 1 + Q/2 sin(pi i / Q)."""
    log_mel, log_e = _log_mel(wave, samp_freq, frame_length_ms,
                              frame_shift_ms, num_bins, low_freq, high_freq,
                              precision)
    n = np.arange(num_bins)
    k = np.arange(num_ceps)[:, None]
    dct = math.sqrt(2.0 / num_bins) * np.cos(math.pi / num_bins
                                             * (n + 0.5) * k)
    dct[0] = math.sqrt(1.0 / num_bins)
    lift = 1.0 + 0.5 * cepstral_lifter * np.sin(math.pi * np.arange(num_ceps)
                                                / cepstral_lifter)
    dt = log_mel.dtype
    with matmul_precision(precision):
        c = rounded(log_mel @ rounded(torch.as_tensor(
            dct.T, dtype=dt, device=wave.device), precision), precision)
    c = rounded(c * torch.as_tensor(lift, dtype=dt, device=wave.device),
                precision)
    return torch.cat([log_e[:, None], c[:, 1:]], dim=1)


def add_deltas(feats: torch.Tensor, order: int = 2,
               window: int = 2) -> torch.Tensor:
    """[T, D] -> [T, D * (order + 1)]: Kaldi's DeltaFeatures. The order-i
    coefficients are the order-(i-1) window convolved with the regression
    window j / sum(j^2), j in [-window, window], each applied to the
    features with frame indices clamped at the edges."""
    T = feats.shape[0]
    norm = float(sum(j * j for j in range(-window, window + 1)))
    scales = [np.array([1.0])]
    for _ in range(order):
        prev = scales[-1]
        po = (len(prev) - 1) // 2
        cur = np.zeros(len(prev) + 2 * window)
        for j in range(-window, window + 1):
            for k in range(-po, po + 1):
                cur[j + k + po + window] += j * prev[k + po] / norm
        scales.append(cur)
    t = torch.arange(T, device=feats.device)
    outs = []
    for sc in scales:
        off = (len(sc) - 1) // 2
        acc = torch.zeros_like(feats)
        for j, w in enumerate(sc):
            if w != 0.0:
                acc = acc + float(w) * feats[torch.clamp(t + j - off, 0,
                                                         T - 1)]
        outs.append(acc)
    return torch.cat(outs, dim=1)


def cmvn(feats: torch.Tensor) -> torch.Tensor:
    """Per-utterance mean and variance normalisation over time:
    (x - mean) / (population std + 1e-5)."""
    mu = feats.mean(dim=0, keepdim=True)
    sd = ((feats - mu) ** 2).mean(dim=0, keepdim=True).sqrt()
    return (feats - mu) / (sd + 1e-5)


def energy_vad(feats: torch.Tensor, threshold: float = 5.0,
               mean_scale: float = 0.5) -> torch.Tensor:
    """Kaldi's energy VAD with no context window: frame t is voiced when
    its C0 exceeds threshold + mean_scale * mean(C0). -> bool [T]."""
    e = feats[:, 0]
    return e > threshold + mean_scale * e.mean()
