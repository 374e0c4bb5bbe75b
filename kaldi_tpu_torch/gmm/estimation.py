"""GMM sufficient-statistics accumulation + MLE/MAP updates.

Counterpart of kaldi_tpu/gmm/estimation.py (ref: gmm/mle-diag-gmm.h:136-225
AccumDiagGmm / MleDiagGmmUpdate / MapDiagGmmUpdate; gmm/mle-am-diag-gmm.h
AccumAmDiagGmm). The accumulators and the updates are the JAX package's
numpy code, copied. The device part is `_aligned_posteriors`: for frames
[T, D] with one aligned pdf each, every component's posterior within that
pdf, from one GEMM over all pdfs and a masked softmax, on the AM's device.
JAX pads T to a power of two so that its jit compiles few shapes; torch
compiles nothing, so the port does not pad (the padded frames have zero
weight and change no statistic). `AccumDiagGmm.accumulate_batch` runs the
same posteriors for one GMM over chunks of frames on a device (the UBM
at 2048 gaussians).
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm, _augment
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm


class AccumDiagGmm:
    """Sufficient stats for one DiagGmm: occupancy, mean & var accumulators."""

    def __init__(self, num_gauss: int, dim: int):
        self.occ = np.zeros(num_gauss, np.float64)
        self.mean_acc = np.zeros((num_gauss, dim), np.float64)
        self.var_acc = np.zeros((num_gauss, dim), np.float64)

    def accumulate_from_posteriors(self, x: np.ndarray, post: np.ndarray):
        """x [T, D], post [T, M]."""
        self.occ += post.sum(axis=0)
        self.mean_acc += post.T @ x
        self.var_acc += post.T @ (x * x)

    def accumulate(self, gmm: DiagGmm, x: np.ndarray, weights=None):
        post = gmm.posteriors(x)
        if weights is not None:
            post = post * np.asarray(weights)[:, None]
        self.accumulate_from_posteriors(x, post)

    def add(self, other: "AccumDiagGmm"):
        self.occ += other.occ
        self.mean_acc += other.mean_acc
        self.var_acc += other.var_acc

    def accumulate_batch(self, gmm: DiagGmm, x: torch.Tensor,
                         chunk: int = 1 << 16):
        """`accumulate` for f32 frames [T, D] on their device: per chunk
        the f32 posteriors (`_aligned_posteriors` with every frame in the
        one GMM) and the f32 sums posteriors, posteriors^T x and
        posteriors^T x^2, as JAX sums them over all its frames; the chunks'
        sums are added in f64 there and copied back once."""
        dev = x.device
        packed = torch.as_tensor(gmm.packed(), device=dev)
        seg = torch.zeros(gmm.num_gauss, dtype=torch.int64, device=dev)
        sums = torch.zeros((gmm.num_gauss, 1 + 2 * gmm.dim),
                           dtype=torch.float64, device=dev)
        for i in range(0, len(x), chunk):
            xc = x[i:i + chunk]
            post, _ll = _aligned_posteriors(
                xc, torch.zeros(len(xc), dtype=torch.int64, device=dev),
                torch.ones(len(xc), device=dev), packed, seg)
            sums += torch.cat([post.sum(dim=0)[:, None], post.T @ xc,
                               post.T @ (xc * xc)], dim=1).double()
        sums = sums.cpu().numpy()
        self.occ += sums[:, 0]
        self.mean_acc += sums[:, 1:1 + gmm.dim]
        self.var_acc += sums[:, 1 + gmm.dim:]


def mle_diag_gmm_update(
    gmm: DiagGmm,
    acc: AccumDiagGmm,
    min_gaussian_occupancy: float = 10.0,
    min_gaussian_weight: float = 1e-5,
    variance_floor: float = 1e-10,
    update_weights: bool = True,
    update_means: bool = True,
    update_vars: bool = True,
) -> DiagGmm:
    """MLE re-estimation (ref: mle-diag-gmm.h:214 MleDiagGmmUpdate).

    Components with occupancy below threshold keep their old parameters
    (the reference optionally removes them; we keep for shape stability).
    """
    occ = acc.occ
    tot = occ.sum()
    new_w = gmm.weights.copy()
    new_m = gmm.means.copy()
    new_v = gmm.vars.copy()
    ok = occ > min_gaussian_occupancy
    if update_weights and tot > 0:
        w = occ / tot
        w = np.where(ok, np.maximum(w, min_gaussian_weight), gmm.weights)
        new_w = w / w.sum()
    safe_occ = np.maximum(occ, 1e-10)[:, None]
    mean_hat = acc.mean_acc / safe_occ
    if update_means:
        new_m = np.where(ok[:, None], mean_hat, gmm.means)
    if update_vars:
        # var = E[x^2] - 2 m E[x] + m^2 where m is the NEW mean
        m = mean_hat if update_means else gmm.means
        var_hat = (acc.var_acc / safe_occ
                   - 2.0 * m * (acc.mean_acc / safe_occ) + m * m)
        var_hat = np.maximum(var_hat, variance_floor)
        new_v = np.where(ok[:, None], var_hat, gmm.vars)
    return DiagGmm(new_w, new_m, new_v)


def map_diag_gmm_update(
    gmm: DiagGmm,
    acc: AccumDiagGmm,
    mean_tau: float = 10.0,
    weight_tau: float = 10.0,
    variance_tau: float = 50.0,
    update_weights: bool = False,
    update_vars: bool = False,
) -> DiagGmm:
    """MAP re-estimation toward the current model as prior
    (ref: gmm/mle-diag-gmm.h:225 MapDiagGmmUpdate)."""
    occ = acc.occ
    tot = max(occ.sum(), 1e-10)
    new_w = gmm.weights.copy()
    if update_weights:
        new_w = (occ + weight_tau * gmm.weights) / (tot + weight_tau)
        new_w /= new_w.sum()
    new_m = (acc.mean_acc + mean_tau * gmm.means) / (occ[:, None] + mean_tau)
    new_v = gmm.vars.copy()
    if update_vars:
        var_stats = acc.var_acc - 2 * new_m * acc.mean_acc + occ[:, None] * new_m**2
        prior_stats = variance_tau * (gmm.vars + np.square(gmm.means - new_m))
        new_v = (var_stats + prior_stats) / (occ[:, None] + variance_tau)
        new_v = np.maximum(new_v, 1e-10)
    return DiagGmm(new_w, new_m, new_v)


class AccumAmDiagGmm:
    """Per-pdf accumulators for a whole AM (host f64)."""

    def __init__(self, am: AmDiagGmm):
        self.accs = [AccumDiagGmm(p.num_gauss, p.dim) for p in am.pdfs]
        self.tot_like = 0.0
        self.tot_frames = 0.0

    def add(self, other: "AccumAmDiagGmm"):
        for a, b in zip(self.accs, other.accs):
            a.add(b)
        self.tot_like += other.tot_like
        self.tot_frames += other.tot_frames

    def accumulate_from_posteriors(
        self, am: AmDiagGmm, feats: np.ndarray, post,
    ):
        """Soft per-frame pdf posteriors: post[t] = [(pdf, weight)].

        Expands to (frame, pdf, weight) triples and reuses the aligned
        path with repeated frames (ref: gmm/mle-am-diag-gmm.h
        AccumAmDiagGmm::AccumulateFromPosteriors)."""
        idx, pdfs, ws = [], [], []
        for t, frame in enumerate(post):
            for pdf, w in frame:
                idx.append(t)
                pdfs.append(pdf)
                ws.append(w)
        if not idx:
            return
        feats = np.asarray(feats, np.float32)
        self.accumulate_from_alignment(
            am, feats[np.asarray(idx)], np.asarray(pdfs),
            np.asarray(ws, np.float32))

    def accumulate_from_alignment(
        self, am: AmDiagGmm, feats: np.ndarray, pdf_ids: np.ndarray,
        weights: np.ndarray | None = None,
    ):
        """feats [T, D], pdf_ids [T] (hard alignment), optional weights [T].

        Per-component posteriors within the aligned pdf of every frame on
        the AM's device (one copy back), then a scatter into the host
        accumulators, pdf by pdf, as in JAX."""
        feats = np.asarray(feats, np.float32)
        pdf_ids = np.asarray(pdf_ids)
        if weights is None:
            weights = np.ones(len(feats), np.float32)
        weights = np.asarray(weights, np.float32)
        packed, seg, _table = am.device_pack()
        dev = am.device
        post, ll = _aligned_posteriors(
            torch.as_tensor(feats, device=dev),
            torch.as_tensor(pdf_ids.astype(np.int64), device=dev),
            torch.as_tensor(weights, device=dev), packed, seg)
        # one copy: the scalar rides in the posterior buffer
        both = torch.cat([post.reshape(-1), ll.reshape(1)]).cpu().numpy()
        post = both[:-1].reshape(post.shape)
        self.tot_like += float(both[-1])
        self.tot_frames += float(weights.sum())
        offsets = np.cumsum([0] + [p.num_gauss for p in am.pdfs])
        x = feats.astype(np.float64)
        xsq = x * x
        touched = np.unique(pdf_ids)
        for pdf in touched:
            sl = slice(offsets[pdf], offsets[pdf + 1])
            p = post[:, sl]
            rows = p.sum(axis=1) > 0
            if not rows.any():
                continue
            pr = p[rows]
            self.accs[pdf].occ += pr.sum(axis=0)
            self.accs[pdf].mean_acc += pr.T @ x[rows]
            self.accs[pdf].var_acc += pr.T @ xsq[rows]


def _aligned_posteriors(feats: torch.Tensor, pdf_ids: torch.Tensor,
                        weights: torch.Tensor, packed: torch.Tensor,
                        seg_ids: torch.Tensor):
    """kaldi_tpu `_aligned_posteriors`: per-component posteriors masked to
    each frame's aligned pdf. feats [T, D] f32, pdf_ids [T], weights [T],
    packed [2D+1, G], seg_ids [G] -> (post [T, G], total loglike [])."""
    comp_ll = torch.matmul(_augment(feats), packed)
    mask = seg_ids[None, :] == pdf_ids[:, None]               # [T, G]
    masked = torch.where(mask, comp_ll, float("-inf"))
    m = torch.amax(masked, dim=1, keepdim=True)
    e = torch.exp(masked - m)
    denom = torch.sum(e, dim=1, keepdim=True)
    post = e / torch.clamp(denom, min=1e-37) * weights[:, None]
    ll = torch.sum((m[:, 0] + torch.log(torch.clamp(denom[:, 0], min=1e-37)))
                   * weights)
    return post, ll
