"""Kaldi-style pitch tracker: NCCF + Viterbi lag smoothing + POV features.

(ref: feat/pitch-functions.h:42-432 — ComputeKaldiPitch computes, per
 frame, normalized cross-correlation over candidate lags (50-400 Hz),
 then Viterbi-smooths the lag track with a log-lag transition penalty and
 outputs (NCCF/POV, pitch); ProcessPitch :407 turns that into the 3-dim
 (pov-feature, normalized-log-pitch, delta-pitch) feature.)

TPU-first: NCCF for all frames and lags is one batched correlation
(a matmul-shaped reduction); the Viterbi over lags is a `lax.scan` over
frames with an [L, L] transition-cost matrix — dense DP like the aligner.

The port's counterpart of kaldi_tpu/ops/pitch.py, on a device (the card
by default) in JAX's dtypes: the resampler and the NCCF in f64 (all lags
at once from one unfold of the frames), the Viterbi over lags in f32 (JAX
runs it on `jnp.asarray` of the f64 costs with x64 off), its first-minimum
tie-break kept, as a loop over frames on the device with one copy of the
backpointers to the host for the backtrace. `process_pitch` stays host
f64, its window loop vectorized over the same cumulative sums.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.ops.resample import LinearResample


@dataclasses.dataclass(frozen=True)
class PitchOpts:
    """(ref: pitch-functions.h:42 PitchExtractionOptions)"""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    resample_freq: float = 4000.0
    penalty_factor: float = 0.1
    delta_pitch: float = 0.005
    soft_min_f0: float = 10.0
    nccf_ballast: float = 7000.0
    lowpass_cutoff: float = 1000.0


@dataclasses.dataclass(frozen=True)
class ProcessPitchOpts:
    """(ref: pitch-functions.h:210 ProcessPitchOptions)"""

    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    delta_pitch_scale: float = 10.0
    normalization_window: int = 151  # frames, for mean log-pitch


def _nccf(frames: torch.Tensor, lags: np.ndarray, win: int,
          ballast: float) -> torch.Tensor:
    """frames [T, win + max_lag] f64 tensor; -> nccf [T, L] on its device,
    every lag at once: the lagged windows are one unfold [T, L, win]."""
    a = frames[:, :win]
    a = a - a.mean(dim=1, keepdim=True)
    e1 = torch.sum(a * a, dim=1)
    lo, hi = int(lags[0]), int(lags[-1])
    b = frames.unfold(1, win, 1)[:, lo: hi + 1]            # [T, L, win]
    b = b - b.mean(dim=2, keepdim=True)
    e2 = torch.sum(b * b, dim=2)
    num = torch.sum(a[:, None, :] * b, dim=2)
    return num / torch.sqrt(e1[:, None] * e2 + ballast + 1e-10)


def _viterbi_lags(costs: torch.Tensor, trans: torch.Tensor) -> np.ndarray:
    """costs [T, L] local costs; trans [L, L] transition costs (f32
    tensors on one device) -> best lag index per frame [T]."""
    T, L = costs.shape
    alpha = costs[0]
    bps = torch.empty((max(T - 1, 0), L), dtype=torch.int64,
                      device=costs.device)
    for t in range(1, T):
        # new[j] = min_i alpha[i] + trans[i, j] + c_t[j]; first minimum
        m = alpha[:, None] + trans
        best, bps[t - 1] = torch.min(m, dim=0)
        alpha = best + costs[t]
    j = int(torch.argmin(alpha))
    bps = bps.cpu().numpy()
    path = np.empty(T, np.int64)
    path[T - 1] = j
    for t in range(T - 2, -1, -1):
        j = int(bps[t, j])
        path[t] = j
    return path


def compute_kaldi_pitch(wave: np.ndarray,
                        opts: PitchOpts = PitchOpts(),
                        device="cuda") -> np.ndarray:
    """wave [S] at opts.samp_freq -> [T, 2] (nccf_pov, pitch_hz),
    computed on `device`."""
    dev = resolve_device(device)
    wave = torch.as_tensor(np.asarray(wave, np.float64), device=dev)
    if opts.samp_freq != opts.resample_freq:
        rs = LinearResample(opts.samp_freq, opts.resample_freq,
                            filter_cutoff=opts.lowpass_cutoff)
        # JAX's resampler hands back float32
        wave = rs.resample_tensor(wave).float().double()
    sf = opts.resample_freq
    shift = int(sf * 0.001 * opts.frame_shift_ms)
    win = int(sf * 0.001 * opts.frame_length_ms)
    min_lag = int(sf / opts.max_f0)
    max_lag = int(math.ceil(sf / opts.min_f0))
    lags = np.arange(min_lag, max_lag + 1)
    need = win + max_lag
    T = max(0, 1 + (len(wave) - need) // shift)
    if T == 0:
        return np.zeros((0, 2), np.float32)
    frames = wave.unfold(0, need, shift)[:T]
    # ballast scales with signal energy (ref: nccf_ballast semantics)
    mean_sq = float(torch.mean(wave * wave)) + 1e-10
    ballast = opts.nccf_ballast * (mean_sq * win) ** 1.0
    nccf = _nccf(frames, lags, win, ballast)
    # local cost: 1 - nccf + soft-min-f0 lag penalty (breaks octave ties in
    # favor of the shorter lag, ref: soft_min_f0 in ComputeLocalCost);
    # transition: penalty * (log lag diff)^2
    lag_penalty = opts.soft_min_f0 * (lags / sf)
    nccf_for_search = nccf - torch.as_tensor(lag_penalty, device=dev)[None, :]
    log_lags = np.log(lags.astype(np.float64))
    d = log_lags[:, None] - log_lags[None, :]
    trans = opts.penalty_factor * (d * d) / (opts.delta_pitch ** 0.5)
    path = _viterbi_lags((1.0 - nccf_for_search).float(),
                         torch.as_tensor(trans, device=dev).float())
    pitch = sf / lags[path]
    pov = nccf.cpu().numpy()[np.arange(T), path]
    return np.stack([pov, pitch], axis=1).astype(np.float32)


def process_pitch(pitch_feats: np.ndarray,
                  opts: ProcessPitchOpts = ProcessPitchOpts()) -> np.ndarray:
    """[T, 2] (nccf, pitch) -> [T, 3] (pov_feature, norm_log_pitch,
    delta_pitch) (ref: pitch-functions.h:407 ProcessPitch)."""
    nccf = np.clip(pitch_feats[:, 0], -1.0, 1.0)
    pitch = np.maximum(pitch_feats[:, 1], 1e-3)
    T = len(nccf)
    # POV nonlinearity: pow(1.0001 - nccf, 0.15) - 1, signed — NOT abs()
    # (ref: pitch-functions.cc:44-52 NccfToPovFeature; abs would map a
    # strongly unvoiced nccf=-0.9 onto the same value as voiced +0.9 and
    # destroy the probability-of-voicing signal)
    pov = (1.0001 - nccf) ** 0.15 - 1.0
    pov_feature = opts.pov_scale * pov
    log_pitch = np.log(pitch)
    # mean-subtract log pitch over a sliding window, POV-weighted
    w = (nccf + 1.0) / 2.0 + 1e-3
    half = opts.normalization_window // 2
    csw = np.concatenate([[0], np.cumsum(w)])
    cswp = np.concatenate([[0], np.cumsum(w * log_pitch)])
    t = np.arange(T)
    lo, hi = np.maximum(0, t - half), np.minimum(T, t + half + 1)
    mean_lp = (cswp[hi] - cswp[lo]) / (csw[hi] - csw[lo])
    norm_lp = log_pitch - mean_lp
    norm_log_pitch = opts.pitch_scale * norm_lp
    dp = np.zeros(T)
    dp[1:] = log_pitch[1:] - log_pitch[:-1]
    delta_pitch = opts.delta_pitch_scale * dp
    return np.stack([pov_feature, norm_log_pitch, delta_pitch],
                    axis=1).astype(np.float32)
