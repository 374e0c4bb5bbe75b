"""I-vector extractor: per-Gaussian factor-analysis over a UBM.

(ref: ivector/ivector-extractor.h:135 IvectorExtractor — model
 mu_i(s) = mu_i + M_i w_s with w_s ~ N(0, I); :474 IvectorExtractorStats
 EM training; ivectorbin/ivector-extractor-{init,acc-stats,est}.cc and
 ivector-extract.cc.)

The zeroth/first-order stats of an utterance are two products
(posteriors against frames), the i-vector posterior a K x K solve. The
reference's prior offset convention (i-vector coordinate 0 centered at
prior_offset) is kept so the output scale matches ivector-extract's.

The port's copy of kaldi_tpu/ivector/extractor.py, which is numpy in
JAX too (it imports jax and does not use it). The numpy parameters and the
per-utterance methods (`frame_posteriors`, `utterance_stats`, `extract`)
are JAX's host code; online i-vectors use them. `extract_batch`,
`IvectorStats` and `train_ivector_extractor` run the batch path on their
device, which the published width (2048 gaussians, 600-dim i-vectors)
needs:

- gselect and min-post pruning for chunks of utterances (the f32 diag
  loglikes one GEMM, `torch.topk` for `np.argpartition`), and the stats
  gamma [N, I], X [N, I, D] in f64;
- U = M^T Sigma^-1 M [I, K, K] and V [I, K, D] once per M (cached until
  an update or a new M), not once per utterance;
- per batch of utterances L = I + gamma U as one f64 GEMM, the solve by
  a batched Cholesky (`b[0] += prior_offset`, taken back off the result),
  and the M-step's A and B as GEMMs; the M-step a batched Cholesky solve
  over [I, K, K] in chunks of gaussians.

Everything is f64 as in JAX except the gselect loglikes, which JAX also
computes in f32. A Cholesky solve where JAX calls `solve` and `inv`
differs from it in the last bits (within the condition number of L or A
times the f64 roundoff).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.gmm.am_gmm import _augment
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.full_gmm import FullGmm

# utterances per E-step batch: [B, K, K] f64 is 184 MB at K = 600
BATCH = 64
# f64 elements of a dense [frames, gaussians] posterior chunk (256 MB)
CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass
class IvectorExtractorOpts:
    ivector_dim: int = 100
    num_iters: int = 10
    prior_offset: float = 100.0  # (ref: ivector-extractor.h prior_offset_)
    num_gselect: int = 20
    min_post: float = 0.025


class IvectorExtractor:
    """Parameters: UBM (means mu [I, D], inverse variances or full inverse
    covariances), factor loading M [I, D, K]."""

    def __init__(self, ubm, ivector_dim: int, prior_offset: float = 100.0,
                 seed: int = 0):
        if isinstance(ubm, DiagGmm):
            self.means = np.asarray(ubm.means)
            self.inv_covars = np.stack([np.diag(1.0 / v) for v in ubm.vars])
            self.weights = np.asarray(ubm.weights)
        elif isinstance(ubm, FullGmm):
            self.means = np.asarray(ubm.means)
            self.inv_covars = ubm.inv_covars()
            self.weights = np.asarray(ubm.weights)
        else:
            raise TypeError(type(ubm))
        I, D = self.means.shape
        K = ivector_dim
        rng = np.random.RandomState(seed)
        self.M = rng.randn(I, D, K) * 0.1
        # coordinate 0 of w is centered at prior_offset; M[:, :, 0] set so
        # that M_i * [prior_offset, 0...] ~ 0 initially (means absorbed)
        self.M[:, :, 0] = 0.0
        self.prior_offset = prior_offset
        self.ivector_dim = K
        self._version = 0
        self._dev = None

    @classmethod
    def from_arrays(cls, means, inv_covars, weights, M,
                    prior_offset: float) -> "IvectorExtractor":
        """An extractor holding the given parameters (f64 copies): UBM
        means [I, D], inverse covariances [I, D, D], weights [I], factor
        loadings M [I, D, K]."""
        ext = cls.__new__(cls)
        ext.means = np.array(means, np.float64)
        ext.inv_covars = np.array(inv_covars, np.float64)
        ext.weights = np.array(weights, np.float64)
        ext.M = np.array(M, np.float64)
        ext.prior_offset = float(prior_offset)
        ext.ivector_dim = ext.M.shape[2]
        ext._version = 0
        ext._dev = None
        return ext

    # --- posterior computation over the UBM ---

    def frame_posteriors(self, feats: np.ndarray, num_gselect: int = 20,
                         min_post: float = 0.025) -> np.ndarray:
        """[T, D] -> sparse-ish posteriors [T, I] (pruned & renormalized,
        ref: ivector-extract.cc gselect + min-post pruning)."""
        ll = self._gselect_gmm().loglikes(feats.astype(np.float32))
        T, I = ll.shape
        k = min(num_gselect, I)
        idx = np.argpartition(-ll, k - 1, axis=1)[:, :k]
        sel = np.take_along_axis(ll, idx, axis=1)
        m = sel.max(axis=1, keepdims=True)
        p = np.exp(sel - m)
        p /= p.sum(axis=1, keepdims=True)
        p[p < min_post] = 0.0
        s = p.sum(axis=1, keepdims=True)
        p = np.divide(p, s, out=np.zeros_like(p), where=s > 0)
        post = np.zeros((T, I))
        np.put_along_axis(post, idx, p, axis=1)
        return post

    def utterance_stats(self, feats: np.ndarray, post: np.ndarray):
        """-> (gamma [I], X [I, D]): zeroth/first-order stats."""
        gamma = post.sum(axis=0)
        X = post.T @ feats
        return gamma, X

    # --- i-vector posterior ---

    def _precompute(self):
        # U_i = M_i^T Sigma_i^-1 M_i  [I, K, K];  V_i = M_i^T Sigma_i^-1 [I, K, D]
        V = np.einsum("idk,ide->ike", self.M, self.inv_covars)  # M^T Sig^-1
        U = np.einsum("ikd,idj->ikj", V, self.M)
        return U, V

    def extract(self, gamma: np.ndarray, X: np.ndarray):
        """-> (ivector mean [K] (prior offset subtracted from coord 0),
        posterior precision L [K, K])."""
        U, V = self._precompute()
        K = self.ivector_dim
        L = np.eye(K) + np.einsum("i,ikj->kj", gamma, U)
        Xc = X - gamma[:, None] * self.means
        b = np.einsum("ikd,id->k", V, Xc)
        b[0] += self.prior_offset  # prior mean [offset, 0, ...] times I
        w = np.linalg.solve(L, b)
        out = w.copy()
        out[0] -= self.prior_offset
        return out, L

    def extract_batch(self, stats_list, device="cuda") -> np.ndarray:
        """i-vectors [N, K] of [(gamma [I], X [I, D])] (or of stacked
        (gamma [N, I], X [N, I, D])), JAX's per-utterance `extract` as the
        batch path on `device`."""
        c = self.on_device(device)
        gamma, X = _stacked(stats_list, c["device"])
        return torch.cat([self.posterior_batch(gamma[i:i + BATCH],
                                               X[i:i + BATCH])[0]
                          for i in range(0, len(gamma), BATCH)]
                         ).cpu().numpy()

    # --- the batch path on a device ---

    def changed(self):
        """Call after writing into `M` in place: the device copy (U and V)
        is rebuilt at the next batch call."""
        self._version += 1

    def on_device(self, device="cuda") -> dict:
        """The parameters on `device` in f64: "M" [I, D, K], "Vt" [I, D, K]
        (V_i^T = Sigma_i^-1 M_i), "U" [I, K, K] and "means" [I, D]. Built
        once per M: kept until `M` is replaced, an update or `changed`."""
        dev = resolve_device(device)
        c = self._dev
        if (c is not None and c["device"] == dev and c["host_M"] is self.M
                and c["version"] == self._version):
            return c
        self._dev = None                   # free the old U before the new
        M = torch.as_tensor(self.M, dtype=torch.float64, device=dev)
        ic = torch.as_tensor(self.inv_covars, dtype=torch.float64,
                             device=dev)
        Vt = ic.transpose(1, 2) @ M
        self._dev = {"device": dev, "host_M": self.M,
                     "version": self._version, "M": M, "Vt": Vt,
                     "U": Vt.transpose(1, 2) @ M,
                     "means": torch.as_tensor(self.means, dtype=torch.float64,
                                              device=dev)}
        return self._dev

    def _gselect_gmm(self) -> DiagGmm:
        """The diagonal GMM of `frame_posteriors`: the diagonal of the
        inverse covariances, floored at 1e-10, inverted."""
        return DiagGmm(self.weights, self.means,
                       1.0 / np.maximum(np.einsum("idd->id", self.inv_covars),
                                        1e-10))

    def batch_stats(self, feats_list, num_gselect: int = 20,
                    min_post: float = 0.025, posts=None, device="cuda"):
        """Zeroth/first-order stats of many utterances on `device`: ->
        (gamma [N, I], X [N, I, D]) f64 tensors there. The posteriors are
        `frame_posteriors`' (gselect and min-post pruning) unless `posts`
        gives each utterance's [T, I] (the v2 recipe's)."""
        dev = resolve_device(device)
        diag = torch.as_tensor(self._gselect_gmm().packed(), device=dev)
        I, D = self.means.shape
        N = len(feats_list)
        gamma = torch.zeros((N, I), dtype=torch.float64, device=dev)
        X = torch.zeros((N, I, D), dtype=torch.float64, device=dev)
        budget = max(1, CHUNK_ELEMS // I)
        start = 0
        while start < N:
            end, frames = start, 0
            while end < N and (end == start or
                               frames + len(feats_list[end]) <= budget):
                frames += len(feats_list[end])
                end += 1
            x = torch.as_tensor(np.concatenate(
                [np.asarray(f, np.float64) for f in feats_list[start:end]]),
                device=dev)
            if posts is None:
                p = _gselect_posteriors(x.float(), diag, num_gselect,
                                        min_post)
            else:
                p = torch.as_tensor(np.concatenate(
                    [np.asarray(q, np.float64) for q in posts[start:end]]),
                    dtype=torch.float64, device=dev)
            t = 0
            for n in range(start, end):
                T = len(feats_list[n])
                gamma[n] = p[t:t + T].sum(dim=0)
                X[n] = p[t:t + T].T @ x[t:t + T]
                t += T
            start = end
        return gamma, X

    def linear_terms(self, gamma: torch.Tensor, X: torch.Tensor):
        """The i-vector posterior's linear system for a batch of
        utterances' stats (gamma [B, I], X [B, I, D] f64 on the device of
        `on_device`): -> (the precisions L = I + sum_i gamma_i U_i [B, K, K]
        as one GEMM over the flattened U, the right-hand sides b [B, K]
        with the prior offset added to coordinate 0, the centered stats
        Xc = X - gamma mu [B, I, D])."""
        c = self.on_device(gamma.device)
        B, (I, D), K = len(gamma), self.means.shape, self.ivector_dim
        L = (gamma @ c["U"].view(I, K * K)).view(B, K, K)
        L.diagonal(dim1=1, dim2=2).add_(1.0)
        Xc = X - gamma[:, :, None] * c["means"][None]
        b = Xc.reshape(B, I * D) @ c["Vt"].reshape(I * D, K)
        b[:, 0] += self.prior_offset   # prior mean [offset, 0, ...] times I
        return L, b, Xc

    def posterior_batch(self, gamma: torch.Tensor, X: torch.Tensor):
        """The i-vector posterior of a batch of utterances' stats
        (`linear_terms`), solved by a batched Cholesky: -> (the i-vectors
        [B, K] with the prior offset taken off coordinate 0, the offset
        means w [B, K], the Cholesky factors of L [B, K, K], the centered
        stats Xc [B, I, D])."""
        L, b, Xc = self.linear_terms(gamma, X)
        chol = torch.linalg.cholesky(L)
        w = torch.cholesky_solve(b[:, :, None], chol)[:, :, 0]
        out = w.clone()
        out[:, 0] -= self.prior_offset
        return out, w, chol, Xc


class IvectorStats:
    """EM statistics for the extractor M-step
    (ref: ivector-extractor.h:474 IvectorExtractorStats)."""

    def __init__(self, extractor: IvectorExtractor, device="cuda"):
        """A and B are f64 tensors on `device`."""
        I, D, K = extractor.M.shape
        self.device = resolve_device(device)
        # sums over utts: gamma_i E[w w^T]; (X_i - gamma_i mu_i) E[w]^T
        self.A = torch.zeros((I, K, K), dtype=torch.float64,
                             device=self.device)
        self.B = torch.zeros((I, D, K), dtype=torch.float64,
                             device=self.device)
        self.count = 0.0

    def accumulate(self, extractor: IvectorExtractor, gamma, X):
        """One utterance's stats (gamma [I], X [I, D]): `accumulate_batch`
        of a batch of one."""
        self.accumulate_batch(extractor, *_stacked(
            (np.asarray(gamma)[None], np.asarray(X)[None]), self.device))

    def accumulate_batch(self, extractor: IvectorExtractor,
                         gamma: torch.Tensor, X: torch.Tensor):
        """`accumulate` for a batch of utterances' stats (gamma [B, I], X
        [B, I, D] f64 on this accumulator's device): E[w w^T] = L^-1 +
        w w^T from the Cholesky factor, then A += gamma^T E[w w^T] and
        B += Xc^T w as two GEMMs."""
        _out, w, chol, Xc = extractor.posterior_batch(gamma, X)
        B, (I, D, K) = len(gamma), extractor.M.shape
        Eww = torch.cholesky_inverse(chol) + w[:, :, None] * w[:, None, :]
        self.A.view(I, K * K).addmm_(gamma.T, Eww.reshape(B, K * K))
        self.B.view(I * D, K).addmm_(Xc.reshape(B, I * D).T, w)
        self.count += B

    def update(self, extractor: IvectorExtractor, smoothing: float = 1e-4):
        """M-step: M_i = B_i (A_i + s I)^-1, as M_i^T = (A_i + s I)^-1
        B_i^T by a batched Cholesky solve over chunks of gaussians."""
        I, D, K = extractor.M.shape
        eye = smoothing * torch.eye(K, dtype=torch.float64,
                                    device=self.device)
        step = max(1, CHUNK_ELEMS // (K * K))
        M = torch.empty((I, D, K), dtype=torch.float64, device=self.device)
        for i in range(0, I, step):
            chol = torch.linalg.cholesky(self.A[i:i + step] + eye)
            M[i:i + step] = torch.cholesky_solve(
                self.B[i:i + step].transpose(1, 2), chol).transpose(1, 2)
        extractor.M[...] = M.cpu().numpy()
        extractor.changed()


def train_ivector_extractor(
    ubm, utterance_feats: list[np.ndarray], ivector_dim: int,
    num_iters: int = 5, prior_offset: float = 100.0, seed: int = 0,
    num_gselect: int = 20, device="cuda", posts=None,
    iter_stats: list | None = None,
) -> IvectorExtractor:
    """Full EM training (ref: steps/train_ivector_extractor / sid scripts),
    the batch path on `device`. posts, if given, are each utterance's
    frame posteriors [T, I] in place of the gselect ones (`batch_stats`;
    the v2 recipe's). iter_stats, if given, gets one dict per EM
    iteration: "iter" and "secs" (ending in M's copy to the host)."""
    ext = IvectorExtractor(ubm, ivector_dim, prior_offset, seed)
    gamma, X = ext.batch_stats(utterance_feats, num_gselect, posts=posts,
                               device=device)
    for it in range(num_iters):
        t = time.perf_counter()
        em_iteration(ext, gamma, X)
        if iter_stats is not None:
            iter_stats.append(dict(iter=it, secs=time.perf_counter() - t))
    return ext


def em_iteration(ext: IvectorExtractor, gamma: torch.Tensor,
                 X: torch.Tensor) -> IvectorStats:
    """One EM iteration of the batch path over all utterances' stats
    (gamma [N, I], X [N, I, D] on a device), BATCH utterances at a time;
    updates `ext` in place and returns the statistics."""
    st = IvectorStats(ext, gamma.device)
    for i in range(0, len(gamma), BATCH):
        st.accumulate_batch(ext, gamma[i:i + BATCH], X[i:i + BATCH])
    st.update(ext)
    return st


def _gselect_posteriors(x: torch.Tensor, packed: torch.Tensor,
                        num_gselect: int, min_post: float) -> torch.Tensor:
    """`frame_posteriors` on a chunk of f32 frames [T, D]: the top
    num_gselect f32 diag loglikes (x augmented times `packed`), their
    f32 softmax, entries under min_post zeroed and the rest renormalized
    (a frame left with nothing stays 0), scattered into a dense f64
    [T, I]."""
    ll = _augment(x) @ packed
    k = min(num_gselect, ll.shape[1])
    sel, idx = torch.topk(ll, k, dim=1)
    p = torch.exp(sel - sel[:, :1])
    p = p / p.sum(dim=1, keepdim=True)
    p = torch.where(p < min_post, torch.zeros_like(p), p)
    s = p.sum(dim=1, keepdim=True)
    p = torch.where(s > 0, p / torch.where(s > 0, s, torch.ones_like(s)),
                    torch.zeros_like(p))
    post = torch.zeros(ll.shape, dtype=torch.float64, device=x.device)
    return post.scatter_(1, idx, p.double())


def _stacked(stats, device) -> tuple[torch.Tensor, torch.Tensor]:
    """[(gamma, X)] or (gamma [N, I], X [N, I, D]) -> f64 tensors on
    `device`."""
    if isinstance(stats, tuple) and len(stats) == 2 and \
            np.ndim(stats[0]) == 2:
        g, X = stats
    else:
        g = np.stack([np.asarray(a) for a, _ in stats])
        X = np.stack([np.asarray(b) for _, b in stats])
    return (torch.as_tensor(g, dtype=torch.float64, device=device),
            torch.as_tensor(X, dtype=torch.float64, device=device))
