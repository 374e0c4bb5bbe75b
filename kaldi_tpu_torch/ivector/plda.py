"""PLDA: two-covariance probabilistic LDA for i-vector scoring.

(ref: ivector/plda.h:65 — Plda stores a simultaneous-diagonalizing
 transform and per-dim between-class variances psi; scoring is the
 same/different-speaker LLR with enrollment-count weighting;
 ivectorbin/ivector-compute-plda.cc trains it from speaker-labeled
 i-vectors. Length normalization per the SRE recipes.)

Model: x = mu + u + e, u ~ N(0, B) between-speaker, e ~ N(0, W) within.
Estimation: EM on per-speaker sample means (closed-form-ish two-covariance
EM). After diagonalization W -> I, B -> diag(psi), the LLR has the simple
per-dimension closed form used below.

The port's copy of kaldi_tpu/ivector/plda.py (host numpy, f64 in JAX's
order). One change of cost and none of value: within an EM iteration every
speaker with the same count n has the same posterior precision
Binv + n Winv, so its inverse is taken once per count (the recipes give
each speaker the same number of utterances, which at 600 dimensions saves
an inverse per speaker).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def length_normalize(x: np.ndarray) -> np.ndarray:
    """Scale each vector to norm sqrt(dim) (ref: ivector-normalize-length)."""
    x = np.asarray(x, np.float64)
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    target = np.sqrt(x.shape[-1])
    return x * (target / np.maximum(norm, 1e-10))


class PldaStats:
    """Speaker-labeled i-vector stats (ref: plda.h PldaStats)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.speakers: list[tuple[int, np.ndarray]] = []  # (n, sum)
        self.sum_all = np.zeros(dim)
        self.sumsq_all = np.zeros((dim, dim))
        self.n_all = 0

    def add_speaker(self, ivectors: np.ndarray):
        iv = np.asarray(ivectors, np.float64)
        n = iv.shape[0]
        self.speakers.append((n, iv.sum(axis=0)))
        self.sum_all += iv.sum(axis=0)
        self.sumsq_all += iv.T @ iv
        self.n_all += n


@dataclasses.dataclass
class Plda:
    mean: np.ndarray          # [D]
    transform: np.ndarray     # [D, D]: x' = transform @ (x - mean)
    psi: np.ndarray           # [D]: between-class variance in transformed space

    @staticmethod
    def train(stats: PldaStats, num_iters: int = 10) -> "Plda":
        D = stats.dim
        mu = stats.sum_all / stats.n_all
        # init: total covariance split
        total_cov = stats.sumsq_all / stats.n_all - np.outer(mu, mu)
        B = 0.5 * total_cov
        W = 0.5 * total_cov
        for _it in range(num_iters):
            # E-step over speakers: posterior of speaker mean u_s
            B_acc = np.zeros((D, D))
            W_acc = np.zeros((D, D))
            n_frames = 0
            Winv = np.linalg.inv(W)
            Binv = np.linalg.inv(B)
            sig_of: dict = {}
            for (n, s) in stats.speakers:
                mean_s = s / n - mu
                # posterior: precision = Binv + n Winv
                if n not in sig_of:
                    sig_of[n] = np.linalg.inv(Binv + n * Winv)
                Sig = sig_of[n]
                m = Sig @ (n * (Winv @ mean_s))
                B_acc += Sig + np.outer(m, m)
                # within-class: E[(x - mu - u)(x - mu - u)^T] summed
                # = sum (x-mu)(x-mu)^T - n (m mean_s^T + mean_s m^T) + n(Sig+mm^T)
                W_acc += n * (Sig + np.outer(m, m)
                              - np.outer(m, mean_s) - np.outer(mean_s, m))
                n_frames += n
            # within needs the raw scatter too
            scatter = (stats.sumsq_all - np.outer(stats.sum_all, mu)
                       - np.outer(mu, stats.sum_all)
                       + stats.n_all * np.outer(mu, mu))
            W = (scatter + W_acc) / stats.n_all
            B = B_acc / len(stats.speakers)
            W = 0.5 * (W + W.T)
            B = 0.5 * (B + B.T)
        # simultaneous diagonalization: W -> I, B -> diag(psi)
        ew, Ew = np.linalg.eigh(W)
        ew = np.maximum(ew, 1e-10)
        W_half_inv = Ew @ np.diag(ew ** -0.5) @ Ew.T
        Bt = W_half_inv @ B @ W_half_inv.T
        eb, Eb = np.linalg.eigh(Bt)
        order = np.argsort(eb)[::-1]
        psi = np.maximum(eb[order], 0.0)
        transform = Eb[:, order].T @ W_half_inv
        return Plda(mean=mu, transform=transform, psi=psi)

    def transform_ivector(self, x: np.ndarray) -> np.ndarray:
        return (self.transform @ (np.asarray(x, np.float64) - self.mean).T).T

    def llr(self, enroll_transformed: np.ndarray, n_enroll: int,
            test_transformed: np.ndarray) -> float:
        """Log-likelihood-ratio same/different speaker.

        (ref: plda.cc Plda::LogLikelihoodRatio — enroll is the MEAN of
        n_enroll transformed i-vectors.)
        """
        psi = self.psi
        u = np.asarray(enroll_transformed, np.float64)
        v = np.asarray(test_transformed, np.float64)
        n = n_enroll
        # given-speaker: test ~ N(m, var) with
        # m = (n psi / (n psi + 1)) * u ; var = 1 + psi/(n psi + 1)
        m = (n * psi / (n * psi + 1.0)) * u
        var_given = 1.0 + psi / (n * psi + 1.0)
        logdet_given = np.sum(np.log(var_given))
        sq_given = np.sum((v - m) ** 2 / var_given)
        # no-speaker: test ~ N(0, psi + 1)
        var_no = psi + 1.0
        logdet_no = np.sum(np.log(var_no))
        sq_no = np.sum(v ** 2 / var_no)
        return float(0.5 * (logdet_no + sq_no - logdet_given - sq_given))

    def adapt(self, adapt_ivectors: np.ndarray,
              mean_diff_scale: float = 1.0,
              within_covar_scale: float = 0.3,
              between_covar_scale: float = 0.7) -> "Plda":
        """Unsupervised domain adaptation from unlabeled i-vectors
        (ref: ivector/plda.h PldaUnsupervisedAdaptor::UpdatePlda).

        In the PLDA-transformed space (within = I, between = diag(psi)),
        directions where the adaptation data's total variance exceeds the
        model's expected 1 + psi get the excess distributed onto the
        within/between covariances; the model is then re-diagonalized.
        """
        x = np.asarray(adapt_ivectors, np.float64)
        # transform adaptation data into the diagonalized space
        y = self.transform_ivector(x)
        mean_y = y.mean(axis=0)
        S = np.cov(y.T, bias=True) if len(y) > 1 else np.eye(y.shape[1])
        s, V = np.linalg.eigh(0.5 * (S + S.T))
        D = len(self.psi)
        W_new = np.eye(D)
        B_new = np.diag(self.psi.copy())
        for j in range(D):
            v = V[:, j]
            expected = float(v @ (np.eye(D) + np.diag(self.psi)) @ v)
            excess = float(s[j]) - expected
            if excess > 0:
                W_new += within_covar_scale * excess * np.outer(v, v)
                B_new += between_covar_scale * excess * np.outer(v, v)
        # re-diagonalize (same construction as train())
        ew, Ew = np.linalg.eigh(W_new)
        ew = np.maximum(ew, 1e-10)
        W_half_inv = Ew @ np.diag(ew ** -0.5) @ Ew.T
        Bt = W_half_inv @ B_new @ W_half_inv.T
        eb, Eb = np.linalg.eigh(0.5 * (Bt + Bt.T))
        order = np.argsort(eb)[::-1]
        psi = np.maximum(eb[order], 0.0)
        extra = Eb[:, order].T @ W_half_inv      # acts in the old
        #   transformed space; compose with the old transform
        new_transform = extra @ self.transform
        # shift the model mean toward the adaptation mean (in raw space:
        # mean_y is the offset expressed in the transformed space)
        new_mean = self.mean + mean_diff_scale * np.linalg.lstsq(
            self.transform, mean_y, rcond=None)[0]
        return Plda(mean=new_mean, transform=new_transform, psi=psi)

    def score_trials(self, enroll: dict, test: dict,
                     n_enroll: dict | None = None,
                     length_norm: bool = True):
        """enroll/test: id -> raw i-vector (enroll may be averaged).

        -> dict (enroll_id, test_id) -> LLR score.
        """
        def prep(x):
            x = np.asarray(x, np.float64)
            if length_norm:
                x = length_normalize(x)
            return self.transform_ivector(x)

        et = {k: prep(v) for k, v in enroll.items()}
        tt = {k: prep(v) for k, v in test.items()}
        out = {}
        for ek, ev in et.items():
            n = (n_enroll or {}).get(ek, 1)
            for tk, tv in tt.items():
                out[(ek, tk)] = self.llr(ev, n, tv)
        return out
