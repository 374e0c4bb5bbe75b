"""SGMM fMLLR pre-transform, fMLLR basis and state distances, on the
model's device in f64.

Counterpart of kaldi_tpu/sgmm/prexform.py (ref: sgmm2/fmllr-sgmm2.h
Sgmm2FmllrGlobalParams (pre_xform_ / inv_xform_ / mean_scatter_),
sgmm2bin/sgmm2-comp-prexform.cc, sgmmbin/sgmm-est-fmllrbasis.cc,
sgmmbin/sgmm-calc-distances.cc). JAX's per-state moment loop is one
batch over all substates.
"""

from __future__ import annotations

import torch

from kaldi_tpu_torch.sgmm.fmllr import FmllrSgmm2Accs
from kaldi_tpu_torch.sgmm.model import F64, AmSgmm2


def _occ_weighted_moments(model: AmSgmm2, state_occs):
    """-> (global mean [D], within-class covariance [D, D], between-class
    covariance [D, D]) of the substate means weighted by the states'
    occupancies, their substate weights and their gaussian weights."""
    occ = torch.as_tensor(state_occs, dtype=F64, device=model.device)
    occ = occ[model.state_of_substate()]                        # [Mtot]
    wmi = torch.exp(model.log_weights_plain()) * model.c[:, None]
    w_flat = torch.where((occ > 0)[:, None], occ[:, None] * wmi,
                         torch.zeros_like(wmi))
    mu = model.means()                                          # [Mtot, I, D]
    Sigma = torch.linalg.inv(model.Sigma_inv)
    tot_w = max(float(w_flat.sum()), 1e-10)
    mean = torch.einsum("mi,mid->d", w_flat, mu) / tot_w
    second = torch.einsum("mi,mid,mie->de", w_flat, mu, mu)
    within = torch.einsum("mi,ide->de", w_flat, Sigma) / tot_w
    between = second / tot_w - torch.outer(mean, mean)
    return mean, within, between


def compute_prexform(model: AmSgmm2, state_occs):
    """-> (pre_xform [D, D+1], inv_xform [D, D+1], mean_scatter [D]): the
    transform that makes the occupancy-weighted within-class covariance
    the identity and the global mean zero, its inverse, and the
    between-class scatter's diagonal in that basis
    (ref: AmSgmm2::ComputeFmllrPreXform)."""
    D = model.dim
    eye = torch.eye(D, dtype=F64, device=model.device)
    mean, within, between = _occ_weighted_moments(model, state_occs)
    within = 0.5 * (within + within.T) + 1e-6 * eye
    w_eig, U = torch.linalg.eigh(within)
    A = (U / torch.sqrt(torch.clamp(w_eig, min=1e-10))) @ U.T
    b = -A @ mean
    pre = torch.cat([A, b[:, None]], dim=1)
    inv = torch.cat([torch.linalg.inv(A), mean[:, None]], dim=1)
    scat = torch.diagonal(A @ between @ A.T).clone()
    return pre, inv, scat


def fmllr_grad_at_identity(accs: FmllrSgmm2Accs,
                           model: AmSgmm2) -> torch.Tensor:
    """Gradient of the fMLLR auxiliary at W = [I 0]."""
    D = model.dim
    W = torch.cat([torch.eye(D, dtype=F64, device=model.device),
                   torch.zeros((D, 1), dtype=F64, device=model.device)], 1)
    g = torch.zeros_like(W)
    g[:, :D] = accs.beta * torch.eye(D, dtype=F64, device=model.device)
    WG = torch.einsum("ef,ifg->ieg", W, accs.G)
    g = g - torch.einsum("ide,ieg->dg", model.Sigma_inv, WG)
    return g + accs.K


def estimate_fmllr_basis(model: AmSgmm2, spk_accs: list,
                         num_bases: int = 50) -> torch.Tensor:
    """-> basis [N, D, D+1]: the leading eigenvectors of the scatter of the
    per-speaker gradients at the identity, each over sqrt(beta)
    (ref: sgmmbin/sgmm-est-fmllrbasis.cc)."""
    D = model.dim
    n = D * (D + 1)
    scatter = torch.zeros((n, n), dtype=F64, device=model.device)
    for accs in spk_accs:
        if accs.beta <= 0:
            continue
        g = fmllr_grad_at_identity(accs, model).reshape(-1)
        scatter += torch.outer(g, g) / accs.beta
    w_eig, U = torch.linalg.eigh(scatter)
    order = torch.argsort(-w_eig)[:min(num_bases, n)]
    return U[:, order].T.reshape(-1, D, D + 1).contiguous()


def state_distances(model: AmSgmm2, state_occs) -> torch.Tensor:
    """[J, J] symmetrized approximate KL divergences between states on their
    first substates (ref: sgmmbin/sgmm-calc-distances.cc):
    0.5 sum_i wbar_i (v_j - v_k)' H_i (v_j - v_k)."""
    V = model.V[torch.as_tensor(model.offsets[:-1], device=model.device)]
    logw = torch.log_softmax(V @ model.w.T, dim=1)
    occ = torch.as_tensor(state_occs, dtype=F64, device=model.device)
    occ = occ / max(float(occ.sum()), 1e-10)
    wbar = occ @ torch.exp(logw)
    Hbar = torch.einsum("i,ist->st", wbar, model.H)
    dv = V[:, None, :] - V[None, :, :]
    return 0.5 * torch.einsum("jks,st,jkt->jk", dv, Hbar, dv)
