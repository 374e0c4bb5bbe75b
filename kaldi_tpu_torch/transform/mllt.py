"""MLLT / global STC estimation.

(ref: transform/mllt.h:42 MlltAccs; update per Gales' semi-tied covariance
 row iteration, transform/mllt.cc:66-127 — row_i = G_i^{-1} c_i *
 sqrt(beta / c_i^T G_i^{-1} c_i) with c_i the cofactor row.)

The port's copy of kaldi_tpu/transform/mllt.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import numpy as np


class MlltStats:
    def __init__(self, dim: int):
        self.G = np.zeros((dim, dim, dim), np.float64)
        self.beta = 0.0

    def accumulate(self, feats: np.ndarray, means: np.ndarray,
                   variances: np.ndarray, posteriors: np.ndarray):
        """feats [T, D]; means/vars [M, D] gaussian params; post [T, M].

        G[i] += sum_{t,m} post[t,m]/var[m,i] (x_t - mu_m)(x_t - mu_m)^T
        (ref: mllt.cc MlltAccs::AccStats)
        """
        T, D = feats.shape
        M = means.shape[0]
        for m in range(M):
            w = posteriors[:, m]
            if w.sum() < 1e-8:
                continue
            d = feats - means[m]
            wd = d * w[:, None]
            outer = wd.T @ d  # sum_t w (x-mu)(x-mu)^T
            # G[i] += outer / var[m, i] for all i at once
            self.G += outer[None, :, :] / variances[m][:, None, None]
        self.beta += posteriors.sum()

    def accumulate_from_gmm_post(self, feats, am_gmm, pdf_post):
        """Accumulate from per-frame pdf posteriors against an AmDiagGmm:
        within each posted pdf the Gaussian-level posteriors are computed
        and scattered into the G statistics
        (ref: transform/mllt.h:78 MlltAccs::AccumulateFromPosteriors).

        feats [T, D]; pdf_post: per frame, list of (pdf_id, weight).
        """
        feats = np.asarray(feats, np.float64)
        # group frames by pdf so each pdf's GMM is scored vectorized
        by_pdf: dict[int, list] = {}
        for t, frame in enumerate(pdf_post):
            for pdf, w in frame:
                by_pdf.setdefault(int(pdf), []).append((t, float(w)))
        for pdf, items in by_pdf.items():
            g = am_gmm.pdfs[pdf]
            idx = np.array([t for (t, _w) in items])
            w = np.array([wt for (_t, wt) in items])
            x = feats[idx]                                   # [N, D]
            # component log-likelihoods -> posteriors
            ll = (np.log(np.maximum(g.weights, 1e-30))[None, :]
                  - 0.5 * np.sum(np.log(2 * np.pi * g.vars), axis=1)[None]
                  - 0.5 * np.sum((x[:, None, :] - g.means[None]) ** 2
                                 / g.vars[None], axis=2))    # [N, M]
            m = ll.max(axis=1, keepdims=True)
            post = np.exp(ll - m)
            post /= post.sum(axis=1, keepdims=True)
            self.accumulate(x, g.means, g.vars, post * w[:, None])


def update_mllt(stats: MlltStats, num_iters: int = 200):
    """-> (M [D, D], objf improvement). Start from identity."""
    D = stats.G.shape[0]
    beta = stats.beta
    Ginv = np.stack([np.linalg.inv(stats.G[i]) for i in range(D)])
    M = np.eye(D)
    tot_impr = 0.0
    for _p in range(num_iters):
        for i in range(D):
            cof = np.linalg.inv(M).T[i]  # cofactor row (up to scale)
            objf_before = (beta * np.log(abs(M[i] @ cof))
                           - 0.5 * M[i] @ stats.G[i] @ M[i])
            denom = cof @ Ginv[i] @ cof
            M[i] = np.sqrt(beta / denom) * (Ginv[i] @ cof)
            objf_after = (beta * np.log(abs(M[i] @ cof))
                          - 0.5 * M[i] @ stats.G[i] @ M[i])
            tot_impr += objf_after - objf_before
    return M.astype(np.float32), tot_impr


def mllt_objf(stats: MlltStats, M: np.ndarray) -> float:
    D = M.shape[0]
    _sign, logdet = np.linalg.slogdet(M)
    obj = stats.beta * logdet
    for i in range(D):
        obj -= 0.5 * M[i] @ stats.G[i] @ M[i]
    return float(obj)
