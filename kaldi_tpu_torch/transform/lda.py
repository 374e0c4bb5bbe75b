"""LDA estimation from class-labeled features.

(ref: transform/lda-estimate.h:57 LdaEstimate / bin/est-lda — accumulate
 per-class first moments + global second moment; solve the generalized
 symmetric eigenproblem between/within; emit [target_dim, D+1] transform
 including the mean-offset column.)

The port's copy of kaldi_tpu/transform/lda.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import numpy as np


class LdaStats:
    def __init__(self, num_classes: int, dim: int):
        self.zero_acc = np.zeros(num_classes, np.float64)
        self.first_acc = np.zeros((num_classes, dim), np.float64)
        self.total_second = np.zeros((dim, dim), np.float64)

    @property
    def total_count(self):
        return self.zero_acc.sum()

    def accumulate(self, feats: np.ndarray, classes: np.ndarray,
                   weights=None):
        x = np.asarray(feats, np.float64)
        c = np.asarray(classes)
        w = np.ones(len(x)) if weights is None else np.asarray(weights, np.float64)
        np.add.at(self.zero_acc, c, w)
        np.add.at(self.first_acc, c, x * w[:, None])
        self.total_second += (x * w[:, None]).T @ x

    def add(self, other: "LdaStats"):
        self.zero_acc += other.zero_acc
        self.first_acc += other.first_acc
        self.total_second += other.total_second


def estimate_lda(stats: LdaStats, target_dim: int,
                 within_class_factor: float = 1.0,
                 remove_offset: bool = True):
    """-> transform [target_dim, D+1] (apply to [x; 1]).

    (ref: transform/lda-estimate.cc LdaEstimate::Estimate)
    """
    n = stats.total_count
    dim = stats.first_acc.shape[1]
    total_mean = stats.first_acc.sum(axis=0) / n
    # total covar
    total_covar = stats.total_second / n - np.outer(total_mean, total_mean)
    # between-class covar
    counts = np.maximum(stats.zero_acc, 0.0)
    nz = counts > 0
    means = np.zeros_like(stats.first_acc)
    means[nz] = stats.first_acc[nz] / counts[nz, None]
    bc = ((counts[nz, None] * (means[nz] - total_mean)).T
          @ (means[nz] - total_mean)) / n
    wc = total_covar - bc
    # solve: maximize trace(T bc T^T) s.t. T wc T^T = I
    # whiten by wc, eigendecompose whitened bc
    evals_w, evecs_w = np.linalg.eigh(wc)
    evals_w = np.maximum(evals_w, 1e-10)
    wc_inv_half = evecs_w @ np.diag(evals_w ** -0.5) @ evecs_w.T
    m = wc_inv_half @ bc @ wc_inv_half
    evals_b, evecs_b = np.linalg.eigh(m)
    order = np.argsort(evals_b)[::-1][:target_dim]
    proj = (evecs_b[:, order].T @ wc_inv_half)  # [target_dim, D]
    if within_class_factor != 1.0:
        # scale rows so within-class variance = within_class_factor
        proj = proj * np.sqrt(within_class_factor)
    out = np.zeros((target_dim, dim + 1), np.float64)
    out[:, :dim] = proj
    if remove_offset:
        out[:, dim] = -proj @ total_mean
    return out.astype(np.float32), evals_b[order]


def apply_lda(feats: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """feats [..., D] x transform [K, D+1] -> [..., K]."""
    lin = transform[:, :-1]
    off = transform[:, -1]
    return feats @ lin.T + off
