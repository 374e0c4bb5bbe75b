"""fMLLR (constrained MLLR) estimation for diagonal GMMs.

(ref: transform/fmllr-diag-gmm.h:61 FmllrDiagGmmAccs,
 transform/fmllr-diag-gmm.cc:193-234 FmllrInnerUpdate,
 :236-270 ComputeFmllrMatrixDiagGmmFull.)

Stats (AffineXformStats): with x+ = [x; 1],
  beta   = sum of posteriors
  K[d]   = sum_{t,m} gamma_tm * mu_md / var_md * x+_t         [D, D+1]
  G[d]   = sum_{t,m} gamma_tm / var_md * x+_t x+_t^T          [D, D+1, D+1]

Counterpart of kaldi_tpu/transform/fmllr.py. The statistics and the
D x (D+1) row-iteration solve are the JAX package's f64 numpy code,
copied. The device parts are the Gaussian posteriors behind
`accumulate_from_alignment` / `accumulate_from_posteriors` (the port's
`gmm.estimation._aligned_posteriors` on the AM's device, one copy back
per call) and `apply_affine_transform`, an f32 product on the features'
device (TF32 off, as `resolve_device` sets it).
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.gmm.estimation import _aligned_posteriors


class FmllrStats:
    def __init__(self, dim: int):
        self.beta = 0.0
        self.K = np.zeros((dim, dim + 1), np.float64)
        self.G = np.zeros((dim, dim + 1, dim + 1), np.float64)

    def accumulate(self, feats: np.ndarray, means: np.ndarray,
                   variances: np.ndarray, posteriors: np.ndarray):
        """feats [T, D], means/vars [M, D], posteriors [T, M]."""
        T, D = feats.shape
        xp = np.concatenate([feats, np.ones((T, 1))], axis=1)  # [T, D+1]
        gamma_m = posteriors.sum(axis=0)                        # [M]
        self.beta += gamma_m.sum()
        inv_var = 1.0 / variances                               # [M, D]
        # K[d] = sum_m (mu/var)[m,d] * sum_t gamma[t,m] xp[t]
        sum_gx = posteriors.T @ xp                              # [M, D+1]
        self.K += (means * inv_var).T @ sum_gx                  # [D, D+1]
        # G[d] = sum_m inv_var[m,d] * sum_t gamma[t,m] xp xp^T
        # compute per-gaussian outer-product sums via weighted features
        # S_m = sum_t gamma[t,m] xp xp^T would be [M,D+1,D+1] — fold the m
        # axis first: for each d, weight gamma by inv_var[:, d].
        for d in range(D):
            w = posteriors @ inv_var[:, d]                      # [T]
            self.G[d] += (xp * w[:, None]).T @ xp

    def accumulate_from_alignment(self, am, feats, pdf_ids):
        """Hard-alignment accumulation against an AmDiagGmm."""
        post = _posteriors_np(am, np.asarray(feats, np.float32),
                              np.asarray(pdf_ids),
                              np.ones(len(feats), np.float32))
        means = np.concatenate([p.means for p in am.pdfs], axis=0)
        variances = np.concatenate([p.vars for p in am.pdfs], axis=0)
        self.accumulate(np.asarray(feats, np.float64), means, variances, post)

    def accumulate_from_posteriors(self, am, feats, pdf_post):
        """Weighted pdf-posterior accumulation against an AmDiagGmm
        (ref: transform/fmllr-diag-gmm.h AccumulateFromPosteriors via
        gmm-est-fmllr.cc). pdf_post: per frame, list of (pdf_id, w) —
        the ali-to-post | weight-silence-post pipeline output. Each
        (frame, pdf, w) entry is expanded to a virtual frame so the
        within-pdf Gaussian posteriors come from the same batched kernel
        as the hard-alignment path."""
        rows, pdfs, ws = [], [], []
        for t, frame in enumerate(pdf_post):
            for pdf, w in frame:
                rows.append(t)
                pdfs.append(int(pdf))
                ws.append(float(w))
        if not rows:
            return
        feats = np.asarray(feats, np.float64)
        xf = feats[np.asarray(rows)]
        post = _posteriors_np(am, xf.astype(np.float32),
                              np.asarray(pdfs, np.int32),
                              np.asarray(ws, np.float32))
        means = np.concatenate([p.means for p in am.pdfs], axis=0)
        variances = np.concatenate([p.vars for p in am.pdfs], axis=0)
        self.accumulate(xf, means, variances, post)

    def add(self, other):
        self.beta += other.beta
        self.K += other.K
        self.G += other.G


def fmllr_auxf(transform: np.ndarray, stats: FmllrStats) -> float:
    """beta * log|det A| + tr(K W^T) - 0.5 sum_d w_d G_d w_d^T."""
    D = transform.shape[0]
    A = transform[:, :D]
    _s, logdet = np.linalg.slogdet(A)
    obj = stats.beta * logdet + np.sum(stats.K * transform)
    for d in range(D):
        obj -= 0.5 * transform[d] @ stats.G[d] @ transform[d]
    return float(obj)


def _inner_update(inv_G, k, beta, row, transform):
    """(ref: fmllr-diag-gmm.cc:193 FmllrInnerUpdate)"""
    D = transform.shape[0]
    cof = np.linalg.inv(transform[:, :D]).T[row]
    cof_ext = np.concatenate([cof, [0.0]])
    cig = inv_G @ cof_ext
    e1 = cig @ cof_ext
    e2 = cig @ k
    discr = np.sqrt(e2 * e2 + 4 * e1 * beta)
    alphas = [(-e2 + discr) / (2 * e1), (-e2 - discr) / (2 * e1)]
    auxfs = [beta * np.log(abs(a * e1 + e2)) - 0.5 * a * a * e1
             for a in alphas]
    alpha = alphas[int(np.argmax(auxfs))]
    transform[row] = inv_G @ (alpha * cof_ext + k)


def estimate_fmllr(stats: FmllrStats, num_iters: int = 20,
                   min_count: float = 500.0,
                   init: np.ndarray | None = None):
    """-> (transform [D, D+1], objf_impr, count).

    Returns identity if below min-count (ref: fmllr-diag-gmm.cc:161).
    """
    D = stats.K.shape[0]
    ident = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
    if stats.beta < min_count:
        return ident.astype(np.float32), 0.0, stats.beta
    W = ident.copy() if init is None else np.asarray(init, np.float64).copy()
    inv_G = np.stack([np.linalg.inv(stats.G[d]) for d in range(D)])
    objf_old = fmllr_auxf(W, stats)
    for _i in range(num_iters):
        for d in range(D):
            _inner_update(inv_G[d], stats.K[d], stats.beta, d, W)
    objf_new = fmllr_auxf(W, stats)
    if objf_new < objf_old:
        # numerical non-improvement: keep the CALLER'S starting transform
        # (returning identity would silently discard prior adaptation)
        keep = ident if init is None else np.asarray(init, np.float64)
        return keep.astype(np.float32), 0.0, stats.beta
    return W.astype(np.float32), objf_new - objf_old, stats.beta


def _posteriors_np(am, feats, pdf_ids, weights) -> np.ndarray:
    """Per-gaussian posteriors [T, G] within each frame's pdf, computed on
    the AM's device and copied back once, as f64."""
    packed, seg, _table = am.device_pack()
    dev = am.device
    post, _ll = _aligned_posteriors(
        torch.as_tensor(feats, device=dev),
        torch.as_tensor(pdf_ids.astype(np.int64), device=dev),
        torch.as_tensor(weights, device=dev), packed, seg)
    return post.cpu().numpy().astype(np.float64)


def apply_affine_transform(feats, transform, device=None) -> torch.Tensor:
    """feats [..., D] x [D, D+1] -> [..., D] f32 (transform-feats), on
    `device`, or the features' own device when it is None (the CPU for a
    numpy array)."""
    x = torch.as_tensor(feats)
    x = x.to(device=x.device if device is None else device,
             dtype=torch.float32)
    t = torch.as_tensor(np.asarray(transform, np.float32), device=x.device)
    return x @ t[:, :-1].T + t[:, -1]
