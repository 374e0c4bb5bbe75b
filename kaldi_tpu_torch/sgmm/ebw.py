"""SGMM2 discriminative (Extended Baum-Welch) estimation, on the model's
device in f64.

Counterpart of kaldi_tpu/sgmm/ebw.py (ref: sgmm2/estimate-am-sgmm2-ebw.h:56
EbwAmSgmm2Options and the update equations of estimate-am-sgmm2-ebw.cc as
JAX re-derives them: per-parameter smoothing D = E * denominator count +
tau, learning rates applied by inflating the quadratic term; no speaker
subspace updates). Numerator and denominator statistics are both
`Sgmm2Accs`.

JAX solves each substate's and each gaussian's floored quadratic problem
in a loop; here `_solve_quadratic` and `_solve_quadratic_matrix` are
batched: one `eigh` of all the problems' Q at once, the floored solve,
the improvement check and its fall-back (drop the floored directions)
selected per problem. The substate weights' 50 fixed-point iterations run
for all states at once over the padded substate table.
"""

from __future__ import annotations

import dataclasses

import torch

from kaldi_tpu_torch.sgmm.estimate import Sgmm2Accs
from kaldi_tpu_torch.sgmm.model import F64, AmSgmm2


@dataclasses.dataclass(frozen=True)
class EbwSgmm2Options:
    """(ref: sgmm2/estimate-am-sgmm2-ebw.h:56 — same defaults)"""

    tau_v: float = 50.0
    lrate_v: float = 0.5
    tau_M: float = 500.0
    lrate_M: float = 0.5
    tau_c: float = 10.0
    tau_w: float = 50.0
    lrate_w: float = 1.0
    tau_Sigma: float = 500.0
    lrate_Sigma: float = 0.5
    min_substate_weight: float = 1e-5
    cov_min_value: float = 0.5
    ridge: float = 1e-5


def _floored(Q: torch.Tensor, max_cond: float):
    """Batched eigh of 0.5 (Q + Q') [B, S, S] -> (w, V, floor [B], live [B]:
    the problems whose largest eigenvalue (at least 0) is positive)."""
    w, V = torch.linalg.eigh(0.5 * (Q + Q.transpose(-1, -2)))
    wmax = torch.clamp(w.max(dim=-1).values, min=0.0)
    return w, V, wmax / max_cond, wmax > 0.0


def _solve_quadratic(Q: torch.Tensor, g: torch.Tensor,
                     max_cond: float = 1e5):
    """Batched argmax g'd - 0.5 d'Q d (Q [B, S, S], g [B, S]) with
    eigenvalues floored at eig_max / max_cond; where the floored solution
    fails to improve the true objective the floored directions are
    dropped, and where that fails too the step is 0
    (ref: matrix/sp-matrix.h SolveQuadraticProblem): the one-row case of
    `_solve_quadratic_matrix`. -> (delta [B, S], improvement [B])."""
    d, im = _solve_quadratic_matrix(Q, g[:, None, :], max_cond)
    return d[:, 0], im


def _solve_quadratic_matrix(Q: torch.Tensor, L: torch.Tensor,
                            max_cond: float = 1e5):
    """Batched argmax tr(D'L) - 0.5 tr(D Q D') (Q [B, S, S], L [B, D, S])
    with Q's eigenvalues floored at eig_max / max_cond (at least 0); where
    the floored solution fails to improve the true objective the floored
    directions are dropped, and where that fails too the step is 0 (ref:
    sp-matrix.h SolveQuadraticMatrixProblem). -> (delta [B, D, S],
    improvement [B])."""
    w, V, floor, live = _floored(Q, max_cond)
    LV = L @ V
    wf = torch.maximum(w, floor[:, None])[:, None, :]

    def step(coef):
        d = coef @ V.transpose(-1, -2)
        im = (L * d).sum((-1, -2)) - 0.5 * (d * (d @ Q)).sum((-1, -2))
        return d, im

    d1, i1 = step(LV / wf)
    d2, i2 = step(torch.where((w >= floor[:, None])[:, None, :], LV / wf,
                              torch.zeros_like(LV)))
    first = i1 >= 0.0
    d = torch.where(first[:, None, None], d1, d2)
    im = torch.where(first, i1, i2)
    keep = live & (first | (i2 >= 0.0))
    return (torch.where(keep[:, None, None], d, torch.zeros_like(d)),
            torch.where(keep, im, torch.zeros_like(im)))


def _phone_vec_stats(model: AmSgmm2, gam, y, w_jm, gamma_jm, V):
    """Batched g_jm [B, S] / H_jm [B, S, S] from one acc's statistics
    (ref: EbwAmSgmm2Updater::ComputePhoneVecStats)."""
    I, S = model.w.shape
    q = torch.maximum(gam, gamma_jm[:, None] * w_jm)            # [B, I]
    scalar = gam - gamma_jm[:, None] * w_jm + q * (V @ model.w.T)
    g = y + scalar @ model.w
    ww = (model.w[:, :, None] * model.w[:, None, :]).reshape(I, S * S)
    H = ((gam @ model.H.reshape(I, S * S)) + q @ ww).view(-1, S, S)
    return g, H


def v_problems(model: AmSgmm2, num_accs: Sgmm2Accs, den_accs: Sgmm2Accs,
               opts: EbwSgmm2Options) -> tuple:
    """The v step's quadratic problems for all substates: (Q [Mtot, S, S],
    g [Mtot, S], live [Mtot]: the substates with any count)."""
    gn, gd = num_accs.gamma, den_accs.gamma
    cnt = gn.sum(1) + gd.sum(1)
    V = model.V
    w_jm = torch.softmax(V @ model.w.T, dim=1)
    g_n, H_n = _phone_vec_stats(model, gn, num_accs.y, w_jm, gn.sum(1), V)
    g_d, H_d = _phone_vec_stats(model, gd, den_accs.y, w_jm, gd.sum(1), V)
    Hv = lambda H: (H @ V[:, :, None])[:, :, 0]  # noqa: E731
    deriv = (g_n - Hv(H_n)) - (g_d - Hv(H_d))
    Q = (H_n + H_d) * ((cnt + opts.tau_v) / (cnt + 1e-10))[:, None, None] \
        / max(opts.lrate_v, 1e-10)
    return Q, deriv, cnt != 0.0


def w_problems(model: AmSgmm2, num_accs: Sgmm2Accs, den_accs: Sgmm2Accs,
               opts: EbwSgmm2Options) -> tuple:
    """The w step's quadratic problems for all gaussians: (Q [I, S, S],
    g [I, S])."""
    I, S = model.w.shape
    V = model.V
    w_cur = torch.softmax(V @ model.w.T, dim=1)                 # [Mtot, I]
    grad = torch.zeros((I, S), dtype=F64, device=model.device)
    q = torch.zeros_like(w_cur)
    for accs, sign in ((num_accs, 1.0), (den_accs, -1.0)):
        gam = accs.gamma
        gm = gam.sum(1, keepdim=True)
        grad += sign * ((gam - gm * w_cur).T @ V)
        q += torch.maximum(gam, gm * w_cur)
    VV = (V[:, :, None] * V[:, None, :]).reshape(-1, S * S)
    Hw = (q.T @ VV).view(I, S, S)
    c = num_accs.gamma.sum(0) + den_accs.gamma.sum(0) + 1e-10
    return (Hw * ((c + opts.tau_w) / c)[:, None, None]
            / max(opts.lrate_w, 1e-10), grad)


def M_problems(model: AmSgmm2, num_accs: Sgmm2Accs, den_accs: Sgmm2Accs,
               opts: EbwSgmm2Options) -> tuple:
    """The M step's matrix problems for all gaussians: (Q [I, S, S],
    L [I, D, S], live [I])."""
    cnt = num_accs.gamma.sum(0) + den_accs.gamma.sum(0)
    Mi = model.M
    L = (num_accs.Y - Mi @ num_accs.Q) - (den_accs.Y - Mi @ den_accs.Q)
    Q = (num_accs.Q + den_accs.Q) \
        * ((cnt + opts.tau_M) / (cnt + 1e-10))[:, None, None] \
        / max(opts.lrate_M, 1e-10)
    return Q, L, cnt != 0.0


def update_sgmm2_ebw(model: AmSgmm2, num_accs: Sgmm2Accs,
                     den_accs: Sgmm2Accs,
                     opts: EbwSgmm2Options = EbwSgmm2Options(),
                     update_flags: str = "vMwSc") -> dict:
    """In-place EBW M-step in JAX's order v, w, c, M, Sigma; -> the
    per-parameter auxiliary improvements (floats)."""
    I, D, S = model.M.shape
    dev = model.device
    impr: dict = {}
    gamma_i_num = num_accs.gamma.sum(0)
    gamma_i_den = den_accs.gamma.sum(0)

    if "v" in update_flags:
        Q, deriv, live = v_problems(model, num_accs, den_accs, opts)
        delta, im = _solve_quadratic(Q, deriv)
        model.V = torch.where(live[:, None], model.V + delta, model.V)
        impr["v"] = float(torch.where(live, im, torch.zeros_like(im)).sum())

    if "w" in update_flags:
        Q, grad = w_problems(model, num_accs, den_accs, opts)
        delta, im = _solve_quadratic(Q, grad)
        model.w = model.w + delta
        impr["w"] = float(im.sum())

    if "c" in update_flags:
        tab = model.substate_table()                            # [J, Mmax]
        pad = lambda v, fill: torch.cat(  # noqa: E731
            [v, v.new_full((1,), fill)])[tab]
        orig = pad(model.c, 1.0)
        real = tab < model.V.shape[0]
        num_occs = pad(num_accs.gamma.sum(1) + opts.tau_c * model.c, 0.0)
        den_occs = pad(den_accs.gamma.sum(1), 0.0)
        w = torch.where(real, orig, torch.zeros_like(orig))
        multi = torch.as_tensor(model.num_substates > 1, device=dev)
        ratio = den_occs / orig
        k = ratio.max(dim=1, keepdim=True).values - ratio
        for _ in range(50):
            w_new = num_occs + k * w
            w_new = w_new / w_new.sum(1, keepdim=True)
            w = torch.where(multi[:, None], w_new, w)
        w = torch.clamp(w, min=opts.min_substate_weight)
        w = torch.where(real, w, torch.zeros_like(w))
        w = w / w.sum(1, keepdim=True)
        model.c = w[real]
        impr["c"] = 0.0

    if "M" in update_flags:
        Q, L, live = M_problems(model, num_accs, den_accs, opts)
        delta, im = _solve_quadratic_matrix(Q, L)
        model.M = torch.where(live[:, None, None], model.M + delta, model.M)
        impr["M"] = float(torch.where(live, im, torch.zeros_like(im)).sum())

    if "S" in update_flags:
        inv_lrate = 1.0 / max(opts.lrate_Sigma, 1e-10)
        E_den = 1.0 + inv_lrate
        E_num = inv_lrate - 1.0
        n_cnt, d_cnt = gamma_i_num, gamma_i_den
        live = (n_cnt + d_cnt) != 0.0
        stats = num_accs.S_centered - den_accs.S_centered
        Sigma_old = torch.linalg.inv(model.Sigma_inv)
        smooth = (opts.tau_Sigma * inv_lrate + E_den * d_cnt
                  + E_num * n_cnt + 1e-10)
        stats = stats + smooth[:, None, None] * Sigma_old
        Sigma = stats / (n_cnt - d_cnt + smooth)[:, None, None]
        Sigma = 0.5 * (Sigma + Sigma.transpose(1, 2))
        # eigenvalues limited relative to the old covariance: whiten by
        # Sigma_old, clip to [cov_min, 1 / cov_min], unwhiten
        Lc = torch.linalg.cholesky(Sigma_old)
        Linv = torch.linalg.inv(Lc)
        W = Linv @ Sigma @ Linv.transpose(1, 2)
        w_eig, V_eig = torch.linalg.eigh(0.5 * (W + W.transpose(1, 2)))
        w_eig = torch.clamp(w_eig, opts.cov_min_value,
                            1.0 / opts.cov_min_value)
        Sigma = Lc @ ((V_eig * w_eig[:, None, :]) @ V_eig.transpose(1, 2)) \
            @ Lc.transpose(1, 2)
        model.Sigma_inv = torch.where(live[:, None, None],
                                      torch.linalg.inv(Sigma),
                                      model.Sigma_inv)
        impr["S"] = 0.0

    model._update_derived()
    return impr

