"""Full-covariance GMM (for UBMs in the i-vector stack).

(ref: gmm/full-gmm.h FullGmm — canonical form means_invcovars_ +
 inv_covars_ + gconsts_; gmm/mle-full-gmm.h estimation.)

Scoring over a frame block is again a GEMM: with x2 = vec(x xᵀ) implied,
loglike(x, m) = gconst[m] + <invcov·mean[m], x> - 0.5 xᵀ invcov[m] x,
the quadratic term computed as einsum('td,mde,te->tm').

The port's copy of kaldi_tpu/gmm/full_gmm.py (host numpy).
"""

from __future__ import annotations

import math

import numpy as np

M_LOG_2PI = math.log(2.0 * math.pi)


class FullGmm:
    def __init__(self, weights, means, covars):
        """weights [M], means [M, D], covars [M, D, D] (full, SPD)."""
        self.weights = np.asarray(weights, np.float64)
        self.means = np.asarray(means, np.float64)
        self.covars = np.asarray(covars, np.float64)

    @property
    def num_gauss(self):
        return self.weights.shape[0]

    @property
    def dim(self):
        return self.means.shape[1]

    def inv_covars(self) -> np.ndarray:
        return np.linalg.inv(self.covars)

    def gconsts(self) -> np.ndarray:
        sign, logdet = np.linalg.slogdet(self.covars)
        assert np.all(sign > 0), "covariance not positive definite"
        ic = self.inv_covars()
        quad = np.einsum("md,mde,me->m", self.means, ic, self.means)
        with np.errstate(divide="ignore"):
            logw = np.log(self.weights)
        return logw - 0.5 * (self.dim * M_LOG_2PI + logdet + quad)

    def loglikes(self, x: np.ndarray) -> np.ndarray:
        """x [T, D] -> [T, M]."""
        x = np.asarray(x, np.float64)
        ic = self.inv_covars()
        lin = x @ np.einsum("mde,me->md", ic, self.means).T  # [T, M]
        quad = np.einsum("td,mde,te->tm", x, ic, x)
        return (self.gconsts()[None, :] + lin - 0.5 * quad).astype(np.float32)

    def loglike(self, x: np.ndarray) -> np.ndarray:
        ll = self.loglikes(x)
        m = ll.max(axis=1, keepdims=True)
        return m[:, 0] + np.log(np.exp(ll - m).sum(axis=1))

    def posteriors(self, x: np.ndarray) -> np.ndarray:
        ll = self.loglikes(x)
        m = ll.max(axis=1, keepdims=True)
        e = np.exp(ll - m)
        return e / e.sum(axis=1, keepdims=True)

    @staticmethod
    def from_diag(weights, means, diag_vars) -> "FullGmm":
        covars = np.stack([np.diag(v) for v in np.asarray(diag_vars)], axis=0)
        return FullGmm(weights, means, covars)

    def to_diag(self):
        from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
        return DiagGmm(self.weights, self.means,
                       np.stack([np.diag(c) for c in self.covars]))


class AccumFullGmm:
    """Sufficient stats: occ, first moment, full second moment."""

    def __init__(self, num_gauss, dim):
        self.occ = np.zeros(num_gauss, np.float64)
        self.mean_acc = np.zeros((num_gauss, dim), np.float64)
        self.cov_acc = np.zeros((num_gauss, dim, dim), np.float64)

    def accumulate_from_posteriors(self, x, post):
        x = np.asarray(x, np.float64)
        self.occ += post.sum(axis=0)
        self.mean_acc += post.T @ x
        self.cov_acc += np.einsum("tm,td,te->mde", post, x, x)

    def accumulate(self, gmm: FullGmm, x, weights=None):
        post = gmm.posteriors(x)
        if weights is not None:
            post = post * np.asarray(weights)[:, None]
        self.accumulate_from_posteriors(x, post)

    def add(self, other):
        self.occ += other.occ
        self.mean_acc += other.mean_acc
        self.cov_acc += other.cov_acc


def mle_full_gmm_update(
    gmm: FullGmm,
    acc: AccumFullGmm,
    min_gaussian_occupancy: float = 10.0,
    variance_floor: float = 1e-3,
    covariance_floor_scale: float = 0.0,
) -> FullGmm:
    """(ref: gmm/mle-full-gmm.h MleFullGmmUpdate)"""
    occ = acc.occ
    tot = max(occ.sum(), 1e-10)
    ok = occ > min_gaussian_occupancy
    safe = np.maximum(occ, 1e-10)
    w = np.where(ok, occ / tot, gmm.weights)
    w /= w.sum()
    means = acc.mean_acc / safe[:, None]
    covs = (acc.cov_acc / safe[:, None, None]
            - np.einsum("md,me->mde", means, means))
    d = gmm.dim
    eye = np.eye(d)
    for m in range(gmm.num_gauss):
        if not ok[m]:
            means[m] = gmm.means[m]
            covs[m] = gmm.covars[m]
            continue
        # floor eigenvalues for stability
        covs[m] = 0.5 * (covs[m] + covs[m].T)
        evals, evecs = np.linalg.eigh(covs[m])
        evals = np.maximum(evals, variance_floor)
        covs[m] = (evecs * evals) @ evecs.T
        if covariance_floor_scale > 0:
            covs[m] += covariance_floor_scale * eye
    return FullGmm(w, means, covs)
