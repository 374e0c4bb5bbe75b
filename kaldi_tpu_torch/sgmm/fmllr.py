"""fMLLR for SGMM2 acoustic models (full-covariance feature transform), on
the model's device in f64.

Counterpart of kaldi_tpu/sgmm/fmllr.py (ref: sgmm2/fmllr-sgmm2.h
FmllrSgmm2Accs — a per-speaker affine W = [A b] maximizing

   Q(W) = beta log|det A| - 0.5 sum_i tr(Sigma_i^-1 W G_i W') + tr(K' W)

with G_i = sum_t gamma_ti x^_t x^_t' and K = sum_{t,jmi} gamma Sigma_i^-1
mu_jmi x^_t', by gradient ascent with JAX's backtracking). The statistics
come from the entries grouped by state, as `Sgmm2Accs.accumulate` takes
them: K from the dense posteriors' per-gaussian mean sums, G as one GEMM
of the frames' gaussian occupancies against x^ x^'. The line search
evaluates the auxiliary on the device; each of its comparisons reads one
scalar back.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.sgmm.estimate import (_dense, state_entries,
                                           state_posteriors)
from kaldi_tpu_torch.sgmm.model import F64, AmSgmm2, Sgmm2SpeakerState


class FmllrSgmm2Accs:
    """Sufficient statistics for the SGMM fMLLR auxiliary, on the model's
    device: beta, K [D, D+1], G [I, D+1, D+1]."""

    def __init__(self, model: AmSgmm2):
        D, I = model.dim, model.num_gauss
        dev = model.device
        self._beta = torch.zeros((), dtype=F64, device=dev)
        self.K = torch.zeros((D, D + 1), dtype=F64, device=dev)
        self.G = torch.zeros((I, D + 1, D + 1), dtype=F64, device=dev)

    @property
    def beta(self) -> float:
        return float(self._beta)

    def accumulate(self, model: AmSgmm2, feats, state_post,
                   num_gselect: int = 10,
                   spk: Sgmm2SpeakerState | None = None):
        """state_post[t] = [(state j, weight)] (ref: FmllrSgmm2Accs::
        AccumulateForFmllrSubspace — gamma from the current model)."""
        x = model._x(feats)
        D, I = model.dim, model.num_gauss
        xh = torch.cat([x, x.new_ones((len(x), 1))], dim=1)
        ent = state_entries(state_post, model.device)
        gsel = model.gselect(x, num_gselect)
        t = ent[0]
        mus = {}
        for s, e, ge, post, _tot in state_posteriors(model, x, ent, gsel,
                                                     spk):
            if s not in mus:
                mus = {s: model.means(s, spk)}                  # [M, I, D]
            P = _dense(post, ge, I)                             # [E, M, I]
            self._beta += P.sum()
            wm = torch.einsum("emi,mid->eid", P, mus[s])
            sm = torch.einsum("ide,tie->td", model.Sigma_inv, wm)
            self.K += sm.T @ xh[t[e]]
            G = P.sum(1)                                        # [E, I]
            xx = xh[t[e]][:, :, None] * xh[t[e]][:, None, :]
            self.G += (G.T @ xx.reshape(len(e), -1)).view(I, D + 1, D + 1)


def _auxf(W, Sinv, K, G, beta):
    D = W.shape[0]
    sign, logdet = torch.linalg.slogdet(W[:, :D])
    WG = torch.einsum("df,ifg->idg", W, G)
    quad = torch.einsum("ide,ieg,dg->", Sinv, WG, W)
    val = beta * logdet - 0.5 * quad + (K * W).sum()
    return torch.where(sign > 0, val, torch.full_like(val, float("-inf")))


def _grad(W, Sinv, K, G, beta):
    D = W.shape[0]
    g = torch.zeros_like(W)
    g[:, :D] = beta * torch.linalg.inv(W[:, :D]).T
    WG = torch.einsum("ef,ifg->ieg", W, G)
    g = g - torch.einsum("ide,ieg->dg", Sinv, WG)
    return g + K


def estimate_sgmm2_fmllr(accs: FmllrSgmm2Accs, model: AmSgmm2,
                         num_iters: int = 100, min_count: float = 100.0):
    """-> (W [D, D+1] f64 on the model's device, auxf improvement per
    frame). Identity under min_count (ref: FmllrSgmm2Accs::Update). JAX's
    gradient ascent: from step 1 / beta, up to 25 halvings per iteration
    until the auxiliary rises, the step grown 1.5x after a success."""
    D = model.dim
    dev = model.device
    ident = torch.cat([torch.eye(D, dtype=F64, device=dev),
                       torch.zeros((D, 1), dtype=F64, device=dev)], 1)
    beta = accs.beta
    if beta < min_count:
        return ident, 0.0
    args = (model.Sigma_inv, accs.K, accs.G, beta)
    W = ident.clone()
    base = float(_auxf(W, *args))
    cur = base
    step = 1.0 / max(beta, 1.0)
    for _ in range(num_iters):
        gr = _grad(W, *args)
        improved = False
        s = step
        for _bt in range(25):
            cand = W + s * gr
            val = float(_auxf(cand, *args))
            if val > cur:
                W, cur = cand, val
                step = s * 1.5
                improved = True
                break
            s *= 0.5
        if not improved:
            break
    return W, (cur - base) / beta


def apply_fmllr(W, feats) -> torch.Tensor:
    """y = A x + b for every frame, in f64 on W's device."""
    W = torch.as_tensor(W, dtype=F64)
    x = torch.as_tensor(np.asarray(feats) if not isinstance(
        feats, torch.Tensor) else feats, dtype=F64, device=W.device)
    D = x.shape[1]
    return x @ W[:, :D].T + W[:, D]
