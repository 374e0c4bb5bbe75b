"""Cepstral mean/variance normalization, per speaker or utterance.

Counterpart of kaldi_tpu/transform/cmvn.py (ref: transform/cmvn.h:37-60 —
stats are a 2 x (D+1) matrix: row0 = [sum_x ..., count], row1 = [sum_x^2
..., 0]). The stats stay f64 numpy on the host, as in the JAX class;
`apply_cmvn` runs on the features' device.
"""

from __future__ import annotations

import numpy as np
import torch


class CmvnStats:
    def __init__(self, dim: int):
        self.stats = np.zeros((2, dim + 1), np.float64)

    @property
    def count(self) -> float:
        return float(self.stats[0, -1])

    def accumulate(self, feats, weights=None):
        if torch.is_tensor(feats):
            feats = feats.detach().cpu().numpy()
        x = np.asarray(feats, np.float64)
        if weights is None:
            self.stats[0, :-1] += x.sum(axis=0)
            self.stats[1, :-1] += (x * x).sum(axis=0)
            self.stats[0, -1] += x.shape[0]
        else:
            w = np.asarray(weights, np.float64)[:, None]
            self.stats[0, :-1] += (x * w).sum(axis=0)
            self.stats[1, :-1] += (x * x * w).sum(axis=0)
            self.stats[0, -1] += w.sum()

    def add(self, other: "CmvnStats"):
        self.stats += other.stats

    def mean_var(self):
        n = max(self.count, 1.0)
        mean = self.stats[0, :-1] / n
        var = self.stats[1, :-1] / n - mean * mean
        return mean, np.maximum(var, 1e-10)


def apply_cmvn(feats, stats: CmvnStats, norm_vars: bool = False,
               reverse: bool = False) -> torch.Tensor:
    """(ref: transform/cmvn.cc ApplyCmvn / reverse variant) feats [..., D]
    (a tensor, or numpy for a CPU tensor) -> a tensor on feats' device."""
    x = torch.as_tensor(feats)
    mean, var = stats.mean_var()
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    if not reverse:
        x = x - mean
        if norm_vars:
            x = x * torch.as_tensor(1.0 / np.sqrt(var), dtype=torch.float32,
                                    device=x.device)
    else:
        if norm_vars:
            x = x * torch.as_tensor(np.sqrt(var), dtype=torch.float32,
                                    device=x.device)
        x = x + mean
    return x
