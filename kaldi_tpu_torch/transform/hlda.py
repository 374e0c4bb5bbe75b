"""HLDA: maximum-likelihood dimension-reducing linear transform, on a
device in f64.

Counterpart of kaldi_tpu/transform/hlda.py (ref: transform/hlda.h
HldaAccsDiagGmm; Kumar & Andreou 1998 HLDA with diagonal within-class
covariance: the useful rows' G is the within-class scatter, the rejected
rows' the total scatter; rows optimized cyclically by MLLT's cofactor
update). The statistics are f64 GEMMs (class sums through a one-hot); the
row loop is JAX's, each row taking the inverse of the current A (no
Sherman-Morrison shortcut, which would round differently), on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device

F64 = torch.float64


class HldaStats:
    def __init__(self, dim: int, device="cuda"):
        self.device = resolve_device(device)
        self.dim = dim
        self.beta = 0.0
        z = lambda *s: torch.zeros(s, dtype=F64, device=self.device)  # noqa
        self.mean_acc = z(dim)
        self.total_2nd = z(dim, dim)
        self.class_beta = z(0)
        self.class_mean_acc = z(0, dim)

    def accumulate(self, feats, class_ids, num_classes: int):
        x = torch.as_tensor(np.asarray(feats) if not isinstance(
            feats, torch.Tensor) else feats, dtype=F64, device=self.device)
        ids = torch.as_tensor(np.asarray(class_ids, np.int64),
                              device=self.device)
        self.beta += len(x)
        self.mean_acc += x.sum(0)
        self.total_2nd += x.T @ x
        C = max(num_classes, len(self.class_beta))
        if C > len(self.class_beta):
            p = C - len(self.class_beta)
            self.class_beta = torch.cat([self.class_beta,
                                         self.class_beta.new_zeros(p)])
            self.class_mean_acc = torch.cat(
                [self.class_mean_acc,
                 self.class_mean_acc.new_zeros((p, self.dim))])
        oh = torch.nn.functional.one_hot(ids, C).to(F64)        # [T, C]
        self.class_beta += oh.sum(0)
        self.class_mean_acc += oh.T @ x

    def scatters(self):
        """-> (total covariance T, within-class covariance W)."""
        mu = self.mean_acc / self.beta
        T = self.total_2nd / self.beta - torch.outer(mu, mu)
        live = self.class_beta > 0
        cb = self.class_beta[live]
        cmu = self.class_mean_acc[live] / cb[:, None] - mu
        B = (cmu * cb[:, None]).T @ cmu / self.beta
        return T, T - B


def estimate_hlda(stats: HldaStats, keep_dims: int, num_iters: int = 50):
    """-> (transform [keep_dims, D] f64 numpy (the accepted rows),
    objective improvement per frame): JAX's cyclic row update of the full
    square A, auxf = beta log|det A| - beta/2 sum_d log(a_d G_d a_d'), G_d
    the within-class scatter for d < keep_dims, else the total; rows whose
    cofactor quadratic is not positive are left alone."""
    D = stats.dim
    dev = stats.device
    T, W = stats.scatters()
    eye = torch.eye(D, dtype=F64, device=dev)
    Gi = torch.stack([torch.linalg.inv(W + 1e-10 * eye),
                      torch.linalg.inv(T + 1e-10 * eye)])
    Gs = torch.stack([W, T])
    which = [0 if d < keep_dims else 1 for d in range(D)]
    sel = torch.as_tensor(which, device=dev)
    A = eye.clone()

    def auxf(A):
        _s, logdet = torch.linalg.slogdet(A)
        v = torch.einsum("dp,dpq,dq->d", A, Gs[sel], A)
        return stats.beta * logdet - 0.5 * stats.beta * torch.log(
            torch.clamp(v, min=1e-20)).sum()

    base = float(auxf(A))
    for _ in range(num_iters):
        for d in range(D):
            cof = torch.linalg.inv(A).T[d]
            w = Gi[which[d]] @ cof
            denom = cof @ w
            A[d] = torch.where(denom > 0, w * torch.sqrt(1.0 / denom), A[d])
    impr = (float(auxf(A)) - base) / stats.beta
    return A[:keep_dims].cpu().numpy(), impr
