"""Basis fMLLR: speaker transforms as a sum over a trained basis, on a
device in f64.

Counterpart of kaldi_tpu/transform/basis_fmllr.py (ref:
transform/basis-fmllr-diag-gmm.h — BasisFmllrAccus, BasisFmllrEstimate::
EstimateFmllrBasis and ComputeTransform; Povey & Yao 2012: W(s) = W0 +
sum_k d_k B_k with N(s) = min(basis_size, eta beta(s)) coefficients). The
basis is estimated in the space preconditioned by the average per-frame
Hessian H of the fMLLR auxiliary's quadratic term (top eigenvectors of
H^-1/2 S H^-1/2 mapped back through H^-1/2), and the transform by JAX's
projected gradient ascent with the exact curvature step m1 / m2 and
backtracking against the exact auxiliary.

The gradient scatter, the Hessian, both eigendecompositions and the
ascent run on `device` in f64 from the port's `FmllrStats` (host f64
arrays, copied over per call); each backtracking comparison reads one
scalar back.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.transform.fmllr import FmllrStats

F64 = torch.float64


def _stats_on(stats: FmllrStats, device) -> tuple:
    return (torch.as_tensor(stats.K, dtype=F64, device=device),
            torch.as_tensor(stats.G, dtype=F64, device=device),
            float(stats.beta))


def _ident(D: int, device) -> torch.Tensor:
    return torch.cat([torch.eye(D, dtype=F64, device=device),
                      torch.zeros((D, 1), dtype=F64, device=device)], 1)


def fmllr_auxf_t(W: torch.Tensor, K: torch.Tensor, G: torch.Tensor,
                 beta: float) -> torch.Tensor:
    """`fmllr_auxf` on a device: beta log|det A| + tr(K W') - 0.5 sum_d
    w_d G_d w_d'."""
    D = W.shape[0]
    _s, logdet = torch.linalg.slogdet(W[:, :D])
    quad = torch.einsum("dp,dpq,dq->", W, G, W)
    return beta * logdet + (K * W).sum() - 0.5 * quad


def _auxf_gradient(W, K, G, beta):
    """d auxf / dW = beta [A^-T, 0] + K - per-row G_d w_d."""
    D = W.shape[0]
    grad = K.clone()
    grad[:, :D] += beta * torch.linalg.inv(W[:, :D]).T
    return grad - torch.einsum("dpq,dq->dp", G, W)


class BasisFmllrAccus:
    """Gradient scatter and average-Hessian accumulation over training
    speakers on `device` (ref: basis-fmllr-diag-gmm.h:63)."""

    def __init__(self, dim: int, device="cuda"):
        self.device = resolve_device(device)
        self.dim = dim
        n = dim * (dim + 1)
        self.grad_scatter = torch.zeros((n, n), dtype=F64, device=self.device)
        self.H = torch.zeros((n, n), dtype=F64, device=self.device)
        self.beta = 0.0

    def accumulate_from_speaker(self, stats: FmllrStats):
        D = self.dim
        K, G, beta = _stats_on(stats, self.device)
        grad = _auxf_gradient(_ident(D, self.device), K, G, beta) \
            / max(np.sqrt(beta), 1e-10)
        v = grad.reshape(-1)
        self.grad_scatter += torch.outer(v, v)
        # blockdiag(G_d): the quadratic term's curvature, row by row
        H = self.H.view(D, D + 1, D, D + 1)
        idx = torch.arange(D, device=self.device)
        H[idx, :, idx, :] += G
        self.beta += beta


def _hbar(accus: BasisFmllrAccus) -> torch.Tensor:
    """Average per-frame Hessian, ridged so dimensions the data never
    excited stay invertible."""
    Hbar = accus.H / max(accus.beta, 1e-10)
    n = Hbar.shape[0]
    return Hbar + torch.eye(n, dtype=F64, device=Hbar.device) * (
        1e-4 * torch.trace(Hbar) / n + 1e-10)


def estimate_fmllr_basis(accus: BasisFmllrAccus,
                         basis_size: int) -> torch.Tensor:
    """-> basis [basis_size, D, D+1] on the accumulators' device,
    H-orthonormal: two `eigh` (H for H^-1/2, then the preconditioned
    scatter)."""
    D = accus.dim
    e, U = torch.linalg.eigh(_hbar(accus))
    H_mhalf = (U / torch.sqrt(e)) @ U.T
    w, V = torch.linalg.eigh(H_mhalf @ accus.grad_scatter @ H_mhalf)
    order = torch.argsort(-w)[:basis_size]
    B = H_mhalf @ V[:, order]
    return B.T.reshape(-1, D, D + 1).contiguous()


def compute_basis_fmllr_transform(stats: FmllrStats, basis, eta: float = 0.2,
                                  num_iters: int = 10, step_sizes: int = 20):
    """-> (W [D, D+1] f64 on the basis' device, coefficients used, auxf
    improvement per frame): JAX's projected gradient ascent over the
    coefficients with the second-order step m1 / m2 along each direction,
    halved until the exact auxiliary rises (a singular A is skipped)."""
    basis = torch.as_tensor(basis, dtype=F64)
    dev = basis.device
    K, G, beta = _stats_on(stats, dev)
    D = K.shape[0]
    W0 = _ident(D, dev)
    if beta <= 0:
        return W0, 0, 0.0
    N = int(min(len(basis), max(1, np.floor(eta * beta))))
    B = basis[:N]
    d = torch.zeros(N, dtype=F64, device=dev)
    W = W0.clone()
    base = float(fmllr_auxf_t(W0, K, G, beta))
    cur = base
    for _ in range(num_iters):
        grad_w = _auxf_gradient(W, K, G, beta)
        grad_d = torch.einsum("kij,ij->k", B, grad_w)
        dW = torch.einsum("k,kij->ij", grad_d, B)
        m1 = float((grad_w * dW).sum())
        m2 = float(torch.einsum("dp,dpq,dq->", dW, G, dW))
        if m1 <= 0 or m2 <= 0:
            break
        step = m1 / m2
        improved = False
        for _ in range(step_sizes):
            d_try = d + step * grad_d
            W_try = W0 + torch.einsum("k,kij->ij", d_try, B)
            if abs(float(torch.linalg.det(W_try[:, :D]))) > 1e-10:
                f = float(fmllr_auxf_t(W_try, K, G, beta))
                if f > cur:
                    rel = f - cur
                    d, W, cur = d_try, W_try, f
                    improved = True
                    break
            step *= 0.5
        if not improved:
            break
        if rel < 1e-5 * max(abs(cur), 1.0):
            break
    return W, N, (cur - base) / beta
