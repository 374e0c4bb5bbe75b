"""Natural-gradient preconditioning for affine layers.

Counterpart of kaldi_tpu/nnet/natural_gradient.py (ref:
nnet2/nnet-precondition-online.h:446 OnlinePreconditioner,
nnet3/natural-gradient-online.h:420 OnlineNaturalGradient): an EMA of the
gradient's row and column covariances, their inverse square roots
refreshed every `update_period` steps, and a final rescale to the
gradient's own Frobenius norm. The refresh is a Python branch on the host
step count, where JAX has a `lax.cond` on a device scalar.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kaldi_tpu_torch.nnet.optim import GradientTransformation, chain, sgd


class FactorState(NamedTuple):
    cov_in: torch.Tensor
    cov_out: torch.Tensor
    p_in: torch.Tensor       # inverse-sqrt preconditioners
    p_out: torch.Tensor


class NgSgdState(NamedTuple):
    factors: dict            # param name -> FactorState
    step: int


def _inv_sqrt_psd(M: torch.Tensor, eps: float) -> torch.Tensor:
    """(M + jitter)^-1/2 by eigh, with jitter eps * trace(M) / d + 1e-8 and
    the eigenvalues floored at 1e-10. V is not unique; V w^-1/2 V^T is."""
    d = M.shape[0]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    tr = torch.trace(M) / d
    w, V = torch.linalg.eigh(M + (eps * tr + 1e-8) * eye)
    w = torch.clamp(w, min=1e-10)
    return (V * (w ** -0.5)) @ V.T


def natural_gradient(alpha: float = 4.0, update_period: int = 10,
                     eps: float = 1e-3, min_dim: int = 2, max_dim: int = 4096,
                     param_filter=None) -> GradientTransformation:
    """Precondition every 2-D parameter's gradient by inverse-sqrt
    Kronecker factors of its own row/column covariance, then rescale it to
    its original Frobenius norm.

    alpha: smoothing toward the scaled identity (larger = closer to SGD).
    param_filter: optional predicate on the parameter's name ("layers.0.w");
    the parameters it rejects get plain gradients."""

    def is_mat(p):
        return (p.ndim == 2 and min(p.shape) >= min_dim
                and max(p.shape) <= max_dim)

    def init(params):
        factors = {}
        for name, p in params.items():
            if param_filter is not None and not param_filter(name):
                continue
            if is_mat(p):
                o, i = p.shape

                def eye(n):
                    return torch.eye(n, dtype=torch.float32, device=p.device)
                factors[name] = FactorState(eye(i), eye(o), eye(i), eye(o))
        return NgSgdState(factors=factors, step=0)

    def update(grads, state, params=None):
        step = state.step + 1
        beta = 0.95
        refresh = step % update_period == 0
        new_factors = dict(state.factors)
        out = {}
        for name, g in grads.items():
            f = state.factors.get(name)
            if f is None:
                out[name] = g
                continue
            o, i = g.shape
            g32 = g.to(torch.float32)
            cov_in = beta * f.cov_in + (1 - beta) * (g32.T @ g32) / o
            cov_out = beta * f.cov_out + (1 - beta) * (g32 @ g32.T) / i
            if refresh:
                eye_i = torch.eye(i, dtype=torch.float32, device=g.device)
                eye_o = torch.eye(o, dtype=torch.float32, device=g.device)
                p_in = _inv_sqrt_psd(
                    cov_in + alpha / i * torch.trace(cov_in) * eye_i, eps)
                p_out = _inv_sqrt_psd(
                    cov_out + alpha / o * torch.trace(cov_out) * eye_o, eps)
            else:
                p_in, p_out = f.p_in, f.p_out
            new_factors[name] = FactorState(cov_in, cov_out, p_in, p_out)
            pg = p_out @ g32 @ p_in
            # scale-preserving contract (see the module docstring)
            norm_g = torch.linalg.vector_norm(g32) + 1e-20
            norm_pg = torch.linalg.vector_norm(pg) + 1e-20
            out[name] = (pg * (norm_g / norm_pg)).to(g.dtype)
        return out, NgSgdState(factors=new_factors, step=step)

    return GradientTransformation(init, update)


def ng_sgd(learning_rate, alpha: float = 4.0, update_period: int = 10,
           momentum: float = 0.0) -> GradientTransformation:
    """NG-SGD: natural-gradient preconditioning, then SGD (ref: nnet2's
    AffineComponentPreconditionedOnline update rule)."""
    return chain(natural_gradient(alpha=alpha, update_period=update_period),
                 sgd(learning_rate, momentum=momentum if momentum > 0
                     else None))
