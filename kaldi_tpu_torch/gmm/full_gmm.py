"""Full-covariance GMM (for UBMs in the i-vector stack).

(ref: gmm/full-gmm.h FullGmm — canonical form means_invcovars_ +
 inv_covars_ + gconsts_; gmm/mle-full-gmm.h estimation.)

Scoring over a frame block is again a GEMM: with x2 = vec(x xᵀ) implied,
loglike(x, m) = gconst[m] + <invcov·mean[m], x> - 0.5 xᵀ invcov[m] x,
the quadratic term computed as einsum('td,mde,te->tm').

The port's copy of kaldi_tpu/gmm/full_gmm.py. The numpy methods
(`loglikes`, `posteriors`, `accumulate`, ...) are JAX's per-call API,
copied; the UBM steps call the batch path, which runs on a device. There
the frames go in chunks, and each chunk's loglikes are one f64 GEMM of
`full_features(x)` = [1, x, x_d x_e (d <= e)] against the packed
[1 + D + D(D+1)/2, M] matrix of gconsts, inverse covariances times means
and inverse covariances; the accumulation is one more f64 GEMM of the
posteriors against the same features (occupancies, first and second
moments at once). As in JAX the loglikes are computed in f64 and returned
in f32, the posteriors come from those f32 loglikes, and the statistics
are f64. `mle_full_gmm_update` floors the eigenvalues of the gaussians
that pass its occupancy test by one batched `torch.linalg.eigh` on its
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device

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

    # --- the batch path on a device ---

    def device_pack(self, device="cuda") -> torch.Tensor:
        """The scoring matrix [1 + D + P, M] on `device` in f64, from the
        host's inverse covariances and gconsts (JAX's numpy): rows gconst,
        the inverse covariance times the mean, and -0.5 times each packed
        pair d <= e of the inverse covariance (off-diagonal pairs summed
        over both halves), P = D (D + 1) / 2. `full_features(x) @ pack`
        is `loglikes` in f64."""
        dev = resolve_device(device)
        ic = self.inv_covars()
        rows, cols = np.triu_indices(self.dim)
        quad = ic[:, rows, cols] + np.where(rows != cols,
                                            ic[:, cols, rows], 0.0)
        lin = np.einsum("mde,me->md", ic, self.means)
        pack = np.concatenate([self.gconsts()[:, None], lin, -0.5 * quad],
                              axis=1)
        return torch.as_tensor(np.ascontiguousarray(pack.T),
                               dtype=torch.float64, device=dev)

    def chunk_frames(self) -> int:
        """Frames per chunk of the batch path: a [chunk, max(M, 1 + D + P)]
        f64 block is 256 MB."""
        return max(256, (1 << 25) // max(self.num_gauss,
                                         _num_features(self.dim)))

    def loglikes_batch(self, x, device="cuda") -> torch.Tensor:
        """x [T, D] -> f32 loglikes [T, M] on `device`: per chunk of frames
        one f64 GEMM of `full_features` against `device_pack`, cast to
        f32 as JAX casts its f64 loglikes."""
        pack = self.device_pack(device)
        x = torch.as_tensor(x, dtype=torch.float64, device=pack.device)
        n = self.chunk_frames()
        return torch.cat([(full_features(x[i:i + n]) @ pack).float()
                          for i in range(0, len(x), n)])

    def posteriors_batch(self, x, device="cuda") -> torch.Tensor:
        """x [T, D] -> f32 posteriors [T, M] on `device` (`posteriors`)."""
        return _softmax_f32(self.loglikes_batch(x, device))[0]

    def loglike_batch(self, x, device="cuda") -> torch.Tensor:
        """x [T, D] -> f32 total log-likelihood per frame [T] on `device`
        (`loglike`)."""
        return _softmax_f32(self.loglikes_batch(x, device))[1]

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

    def accumulate_batch(self, gmm: FullGmm, x, weights=None,
                         device="cuda") -> float:
        """`accumulate` on `device`: per chunk of frames the f32 posteriors
        from the f64 GEMM's loglikes, then one f64 GEMM, posteriors^T
        `full_features(x)`, for the occupancies, the first and the packed
        second moments at once; the sums come back to the host once. ->
        the frames' total log-likelihood under `gmm` (the f64 sum of each
        frame's f32 log-sum-exp)."""
        pack = gmm.device_pack(device)
        x = torch.as_tensor(x, dtype=torch.float64, device=pack.device)
        w = (None if weights is None else
             torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                             device=pack.device))
        sums = torch.zeros((gmm.num_gauss, pack.shape[0]),
                           dtype=torch.float64, device=pack.device)
        tot = torch.zeros((), dtype=torch.float64, device=pack.device)
        n = gmm.chunk_frames()
        for i in range(0, len(x), n):
            f = full_features(x[i:i + n])
            post, like = _softmax_f32((f @ pack).float())
            if w is not None:
                post = post * w[i:i + n, None]
            tot += like.double().sum()
            sums.addmm_(post.T.double(), f)
        self._add_sums(sums)
        return float(tot)

    def accumulate_posteriors_batch(self, feats_list, post_list,
                                    device="cuda"):
        """`accumulate_from_posteriors` of utterances [T_n, D] with given
        posteriors [T_n, M] on `device`: one f64 GEMM per utterance,
        posteriors^T `full_features(x)`."""
        dev = resolve_device(device)
        M, D = self.mean_acc.shape
        sums = torch.zeros((M, _num_features(D)), dtype=torch.float64,
                           device=dev)
        for x, post in zip(feats_list, post_list):
            f = full_features(torch.as_tensor(np.asarray(x),
                                              dtype=torch.float64, device=dev))
            sums.addmm_(torch.as_tensor(np.asarray(post), dtype=torch.float64,
                                        device=dev).T, f)
        self._add_sums(sums)

    def _add_sums(self, sums: torch.Tensor):
        """Adds [M, 1 + D + P] sums (occupancy, first moment, packed second
        moment) on a device to the host accumulators."""
        D = self.mean_acc.shape[1]
        s = sums.cpu().numpy()
        rows, cols = np.triu_indices(D)
        cov = np.zeros(self.cov_acc.shape)
        cov[:, rows, cols] = s[:, 1 + D:]
        cov[:, cols, rows] = s[:, 1 + D:]
        self.occ += s[:, 0]
        self.mean_acc += s[:, 1:1 + D]
        self.cov_acc += cov


def _num_features(dim: int) -> int:
    return 1 + dim + dim * (dim + 1) // 2


def full_features(x: torch.Tensor) -> torch.Tensor:
    """x [T, D] -> [T, 1 + D + P]: 1, x and each frame's packed outer
    product x_d x_e, d <= e (the rows of `FullGmm.device_pack`)."""
    rows, cols = np.triu_indices(x.shape[1])
    return torch.cat([torch.ones((len(x), 1), dtype=x.dtype, device=x.device),
                      x, x[:, rows] * x[:, cols]], dim=1)


def _softmax_f32(ll: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 loglikes [T, M] -> (posteriors e / sum e with e = exp(ll - max),
    as `FullGmm.posteriors` computes them, and each row's log-sum-exp)."""
    m = ll.max(dim=1, keepdim=True).values
    e = torch.exp(ll - m)
    s = e.sum(dim=1, keepdim=True)
    return e / s, m[:, 0] + torch.log(s[:, 0])


def mle_full_gmm_update(
    gmm: FullGmm,
    acc: AccumFullGmm,
    min_gaussian_occupancy: float = 10.0,
    variance_floor: float = 1e-3,
    covariance_floor_scale: float = 0.0,
    device="cuda",
) -> FullGmm:
    """(ref: gmm/mle-full-gmm.h MleFullGmmUpdate). The eigenvalue floor of
    the updated gaussians is one batched eigh on `device`
    (`floor_eigenvalues`)."""
    dev = resolve_device(device)
    occ = acc.occ
    tot = max(occ.sum(), 1e-10)
    ok = occ > min_gaussian_occupancy
    safe = np.maximum(occ, 1e-10)
    w = np.where(ok, occ / tot, gmm.weights)
    w /= w.sum()
    means = acc.mean_acc / safe[:, None]
    covs = (acc.cov_acc / safe[:, None, None]
            - np.einsum("md,me->mde", means, means))
    means[~ok] = gmm.means[~ok]
    covs[~ok] = gmm.covars[~ok]
    if ok.any():
        # floor eigenvalues for stability
        covs[ok] = floor_eigenvalues(covs[ok], variance_floor, dev)
        if covariance_floor_scale > 0:
            covs[ok] += covariance_floor_scale * np.eye(gmm.dim)
    return FullGmm(w, means, covs)


def floor_eigenvalues(covs: np.ndarray, floor: float, device="cuda"
                      ) -> np.ndarray:
    """[N, D, D] -> each symmetrized matrix with its eigenvalues floored at
    `floor`, (V max(w, floor)) V^T, by one batched f64 eigh on `device`."""
    c = torch.as_tensor(covs, dtype=torch.float64,
                        device=resolve_device(device))
    evals, evecs = torch.linalg.eigh(0.5 * (c + c.transpose(1, 2)))
    return ((evecs * torch.clamp(evals, min=floor)[:, None, :])
            @ evecs.transpose(1, 2)).cpu().numpy()
