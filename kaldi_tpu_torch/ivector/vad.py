"""Energy-based voice activity detection.

(ref: ivector/voice-activity-detection.h ComputeVadEnergy — frame is voiced
if C0 energy exceeds a threshold (absolute + mean-scaled), smoothed by a
context-window vote.)

The port's copy of kaldi_tpu/ivector/vad.py (host numpy: one pass over
column 0 per utterance).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VadOpts:
    vad_energy_threshold: float = 5.0
    vad_energy_mean_scale: float = 0.5
    vad_frames_context: int = 0
    vad_proportion_threshold: float = 0.6


def compute_vad(feats: np.ndarray, opts: VadOpts = VadOpts()) -> np.ndarray:
    """feats [T, D] with C0 log-energy at index 0 -> bool mask [T]."""
    log_energy = np.asarray(feats)[:, 0]
    T = len(log_energy)
    threshold = opts.vad_energy_threshold
    if opts.vad_energy_mean_scale != 0.0:
        threshold += opts.vad_energy_mean_scale * log_energy.mean()
    raw = log_energy > threshold
    if opts.vad_frames_context == 0:
        return raw
    ctx = opts.vad_frames_context
    out = np.zeros(T, bool)
    csum = np.concatenate([[0], np.cumsum(raw)])
    for t in range(T):
        lo, hi = max(0, t - ctx), min(T, t + ctx + 1)
        num = csum[hi] - csum[lo]
        out[t] = num >= opts.vad_proportion_threshold * (hi - lo)
    return out


def select_voiced_frames(feats: np.ndarray, vad: np.ndarray) -> np.ndarray:
    """(ref: ivectorbin/select-voiced-frames.cc)"""
    return np.asarray(feats)[np.asarray(vad, bool)]
