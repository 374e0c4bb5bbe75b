"""SGMM2 EM: accumulation and M-step updates, on the model's device in f64.

Counterpart of kaldi_tpu/sgmm/estimate.py (ref: sgmm2/estimate-am-sgmm2.h:126
MleAmSgmm2Accs, :253 MleAmSgmm2Updater; Povey et al. 2011 section 5):

   v_jm:  (sum_i gamma_jmi H_i + H^(w)_jm) v = y_jm + g^(w)_jm
   M_i :  M_i = Y_i Q_i^-1
   w_i :  a damped gradient step on the log-linear weight objective
   Sigma_i : S_i / gamma_i, eigenvalues floored
   c_jm:  gamma_jm / gamma_j (smoothed)
   spk :  (I + sum_i gamma_i(s) H'_i)^-1 sum of projected residuals

JAX loops over frames in Python. Here the (frame, state, weight) entries
are grouped by state, and per state (in chunks of entries) the component
posteriors over the substates and the K gselected gaussians come from the
normaliser form (`AmSgmm2.state_component_loglikes`); scattered into a
dense [E, M_j, I] block they give every statistic as an f64 GEMM:
gamma_jmi, the per-gaussian first moments Xbar_mi = sum_t P x_t (y, Y and
the centred scatter's cross terms come from it), Q_i, and the frames'
gaussian occupancies, whose GEMM against x x' gives the scatter's
second moment at the end:

   S_centered_i = sum_t G_ti x x' - sum_m (Xbar_mi mu_mi' + mu_mi Xbar_mi')
                  + sum_m gamma_mi mu_mi mu_mi'

(JAX's direct sum of (x - mu)(x - mu)' expanded). The updates batch the
per-substate solves (v), the per-gaussian products (M), the eigenvalue
floors (Sigma) and the substate weights (c) across substates, gaussians and
states: none of JAX's loops feeds one iteration into the next, except the
w step's three iterations, which stay a loop.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.sgmm.model import (F64, AmSgmm2, Sgmm2SpeakerState,
                                        CHUNK_ELEMS)


def state_entries(state_post, device) -> tuple:
    """state_post: per frame [(state j, weight)], or a tuple of arrays
    (frame [E], state [E], weight [E]) -> the three as tensors on
    `device` (int64, int64, f64)."""
    if isinstance(state_post, tuple) and len(state_post) == 3:
        t, j, w = (np.asarray(a) for a in state_post)
    else:
        n = sum(len(fr) for fr in state_post)
        t = np.empty(n, np.int64)
        j = np.empty(n, np.int64)
        w = np.empty(n, np.float64)
        k = 0
        for tt, fr in enumerate(state_post):
            for jj, ww in fr:
                t[k], j[k], w[k] = tt, jj, ww
                k += 1
    return (torch.as_tensor(t.astype(np.int64), device=device),
            torch.as_tensor(j.astype(np.int64), device=device),
            torch.as_tensor(w.astype(np.float64), device=device))


def by_state(j: torch.Tensor):
    """Entries' states [E] -> [(state, entry indices)] in state order."""
    order = torch.argsort(j, stable=True)
    js, counts = torch.unique_consecutive(j[order], return_counts=True)
    ends = np.cumsum(counts.cpu().numpy())
    return [(int(s), order[e - c:e]) for s, c, e
            in zip(js.cpu().numpy(), counts.cpu().numpy(), ends)]


def _dense(post: torch.Tensor, gsel: torch.Tensor, I: int) -> torch.Tensor:
    """post [E, M, K] over the gselected gaussians gsel [E, K] -> dense
    [E, M, I]."""
    E, M, K = post.shape
    out = post.new_zeros((E, M, I))
    return out.scatter_(2, gsel[:, None, :].expand(E, M, K), post)


def state_posteriors(model: AmSgmm2, x: torch.Tensor, entries: tuple,
                     gsel: torch.Tensor, spk=None, chunked: bool = True):
    """The component posteriors of (frame, state, weight) entries, state by
    state: yields (state s, entry indices e [E], gselect [E, K],
    post [E, M_s, K] times the entry's weight, the entries' loglikes
    [E]). Chunked so that a dense [E, M_s, I] block stays under
    CHUNK_ELEMS."""
    t, j, w = entries
    nrm = model.normalizers()
    for s, idx in by_state(j):
        n = (max(1, CHUNK_ELEMS // (model.num_substates[s] * model.num_gauss))
             if chunked else len(idx))
        for c in range(0, len(idx), n):
            e = idx[c:c + n]
            ge = gsel[t[e]]
            z, q = model.frame_terms(x[t[e]], ge, spk)
            ll = model.state_component_loglikes(s, z, q, ge, nrm)
            tot = torch.logsumexp(ll.reshape(len(e), -1), dim=1)
            yield s, e, ge, torch.exp(ll - tot[:, None, None]) \
                * w[e][:, None, None], tot


class Sgmm2Accs:
    """The E-step's statistics on the model's device: gamma [Mtot, I], y
    [Mtot, S] (flat substates, the model's layout), Y [I, D, S], Q [I, S, S],
    S_centered [I, D, D], tot_like, tot_frames."""

    def __init__(self, model: AmSgmm2):
        I, D, S = model.M.shape
        dev = model.device
        Mtot = model.V.shape[0]
        z = lambda *s: torch.zeros(s, dtype=F64, device=dev)  # noqa: E731
        self.gamma = z(Mtot, I)
        self.y = z(Mtot, S)
        self.Y = z(I, D, S)
        self.Q = z(I, S, S)
        self._S2 = z(I, D * D)          # sum_t G_ti x x'
        self._Sx = z(I, D, D)           # the cross and mean terms
        self._tot_like = z()
        self._tot_frames = z()
        self._offsets = model.offsets.copy()

    @property
    def tot_like(self) -> float:
        return float(self._tot_like)

    @property
    def tot_frames(self) -> float:
        return float(self._tot_frames)

    @property
    def S_centered(self) -> torch.Tensor:
        I, D, _ = self._Sx.shape
        return self._S2.view(I, D, D) + self._Sx

    def state_occs(self) -> np.ndarray:
        occ = self.gamma.sum(1).cpu().numpy()
        return np.array([occ[a:b].sum() for a, b
                         in zip(self._offsets[:-1], self._offsets[1:])])

    def accumulate(self, model: AmSgmm2, feats, state_post,
                   num_gselect: int = 10,
                   spk: Sgmm2SpeakerState | None = None):
        """state_post[t] = [(state j, weight)] (or (frame, state, weight)
        arrays): per frame the component posteriors within the aligned
        state, scattered into the statistics
        (ref: MleAmSgmm2Accs::Accumulate)."""
        x = model._x(feats)
        ent = state_entries(state_post, model.device)
        gsel = model.gselect(x, num_gselect)
        t, _j, w = ent
        for s, e, ge, post, tot in state_posteriors(model, x, ent, gsel, spk):
            self._tot_like += (tot * w[e]).sum()
            self._tot_frames += w[e].sum()
            self._add(model, s, x[t[e]], _dense(post, ge, model.num_gauss),
                      spk)

    def accumulate_gpost(self, model: AmSgmm2, feats, gpost,
                         spk: Sgmm2SpeakerState | None = None):
        """From precomputed gaussian-level posteriors
        (ref: sgmm2bin/sgmm2-acc-stats-gpost.cc): gpost[t] = [(state j,
        gselect [K], post [M_j, K])]; adds to tot_frames, not tot_like."""
        x = model._x(feats)
        rows: dict = {}
        for tt, fr in enumerate(gpost):
            for jj, g, p in fr:
                rows.setdefault(int(jj), []).append((tt, g, p))
        for s in sorted(rows):
            items = rows[s]
            e = torch.as_tensor([tt for tt, _g, _p in items],
                                device=model.device)
            ge = torch.as_tensor(np.stack([np.asarray(g, np.int64)
                                           for _t, g, _p in items]),
                                 device=model.device)
            post = torch.as_tensor(np.stack([np.asarray(p, np.float64)
                                             for _t, _g, p in items]),
                                   dtype=F64, device=model.device)
            self._tot_frames += post.sum()
            self._add(model, s, x[e], _dense(post, ge, model.num_gauss), spk)

    def _add(self, model: AmSgmm2, s: int, x: torch.Tensor,
             P: torch.Tensor, spk):
        """Dense posteriors P [E, M_s, I] of state s's frames x [E, D]."""
        a, b = int(model.offsets[s]), int(model.offsets[s + 1])
        E, M, I = P.shape
        D = x.shape[1]
        V = model.V[a:b]
        gam = P.sum(0)                                          # [M, I]
        self.gamma[a:b] += gam
        Xbar = (P.reshape(E, M * I).T @ x).view(M, I, D)
        mu = torch.einsum("ids,ms->mid", model.M, V)
        off = model.spk_offsets(spk)
        if off is not None:
            # y and Y take x - N_i s: the phonetic statistics must not
            # absorb the speaker offset; the scatter centres on mu + N_i s
            Xs = Xbar - gam[:, :, None] * off[None]
            mu = mu + off[None]
        else:
            Xs = Xbar
        self.y[a:b] += Xs.reshape(M, I * D) @ model.SinvM.reshape(I * D, -1)
        self.Y += torch.einsum("mid,ms->ids", Xs, V)
        self.Q += torch.einsum("mi,ms,mt->ist", gam, V, V)
        G = P.sum(1)                                            # [E, I]
        self._S2 += G.T @ (x[:, :, None] * x[:, None, :]).reshape(E, D * D)
        cross = torch.einsum("mid,mie->ide", Xbar, mu)
        self._Sx += (torch.einsum("mi,mid,mie->ide", gam, mu, mu)
                     - cross - cross.transpose(1, 2))


def state_sums(model: AmSgmm2, vals: torch.Tensor) -> torch.Tensor:
    """[Mtot] per-substate values -> [J] per-state sums, a fixed-order
    gathered reduction over `substate_table` (no atomics)."""
    return torch.cat([vals, vals.new_zeros(1)])[model.substate_table()].sum(1)


def v_system(model: AmSgmm2, accs: Sgmm2Accs,
             min_substate_occ: float = 1.0) -> tuple:
    """The v update's systems for all substates at once: (lhs [Mtot, S, S],
    rhs [Mtot, S], live [Mtot]) with lhs = sum_i gamma_jmi H_i + H^(w)_jm
    + 1e-6 I, rhs = y_jm + H^(w)_jm v_jm + g^(w)_jm, and live the substates
    whose occupancy reaches min_substate_occ."""
    I, D, S = model.M.shape
    gam = accs.gamma                                        # [Mtot, I]
    g_tot = gam.sum(1)
    w_cur = torch.softmax(model.V @ model.w.T, dim=1)
    Hsum = (gam @ model.H.reshape(I, S * S)).view(-1, S, S)
    g_w = (gam - g_tot[:, None] * w_cur) @ model.w
    a = torch.maximum(gam, g_tot[:, None] * w_cur)
    ww = (model.w[:, :, None] * model.w[:, None, :]).reshape(I, S * S)
    H_w = (a @ ww).view(-1, S, S)
    lhs = Hsum + H_w + 1e-6 * torch.eye(S, dtype=F64, device=model.device)
    rhs = accs.y + (H_w @ model.V[:, :, None])[:, :, 0] + g_w
    return lhs, rhs, g_tot >= min_substate_occ


def update_sgmm2(model: AmSgmm2, accs: Sgmm2Accs,
                 update_flags: str = "vMwSc",
                 min_substate_occ: float = 1.0,
                 w_newton_iters: int = 3,
                 cov_floor: float = 1e-3) -> AmSgmm2:
    """In-place M-step (returns model), JAX's equations batched. Flags as
    the reference's --update-flags: v (substate vectors), M (phonetic
    subspace), w (weight projections), S (covariances), c (substate
    weights)."""
    I, D, S = model.M.shape
    dev = model.device
    eye_S = torch.eye(S, dtype=F64, device=dev)

    if "v" in update_flags:
        lhs, rhs, live = v_system(model, accs, min_substate_occ)
        model.V = torch.where(live[:, None], torch.linalg.solve(lhs, rhs),
                              model.V)

    if "M" in update_flags:
        gi = accs.gamma.sum(0)
        Mt = torch.linalg.solve(accs.Q + 1e-4 * eye_S,
                                accs.Y.transpose(1, 2))         # Q M' = Y'
        model.M = torch.where((gi >= 1.0)[:, None, None],
                              Mt.transpose(1, 2), model.M)

    if "w" in update_flags:
        gam = accs.gamma
        gm = gam.sum(1, keepdim=True)
        for _ in range(w_newton_iters):
            w_cur = torch.softmax(model.V @ model.w.T, dim=1)
            grad = (gam - gm * w_cur).T @ model.V               # [I, S]
            model.w = model.w + 0.5 * grad / max(accs.tot_frames, 1.0)

    if "S" in update_flags:
        gamma_i = accs.gamma.sum(0)
        ok = gamma_i >= D
        Si = accs.S_centered / torch.clamp(gamma_i, min=1e-300)[:, None, None]
        Si = 0.5 * (Si + Si.transpose(1, 2))
        evals, evecs = torch.linalg.eigh(Si[ok])
        Si = (evecs * torch.clamp(evals, min=cov_floor)[:, None, :]) \
            @ evecs.transpose(1, 2)
        Sinv = model.Sigma_inv.clone()
        Sinv[ok] = torch.linalg.inv(Si)
        model.Sigma_inv = Sinv

    if "c" in update_flags:
        occ = accs.gamma.sum(1)
        st = model.state_of_substate()
        tot = state_sums(model, occ)
        cnt = torch.as_tensor(model.num_substates, dtype=F64, device=dev)
        c = (occ + 0.1) / (tot + 0.1 * cnt)[st]
        csum = state_sums(model, c)
        model.c = torch.where((tot > 0)[st], c / csum[st], model.c)

    model._update_derived()
    return model


def estimate_speaker_vector(model: AmSgmm2, feats, state_post,
                            num_gselect: int = 10,
                            num_iters: int = 2) -> Sgmm2SpeakerState:
    """Per-speaker point estimate of the speaker vector
    (ref: sgmm2/estimate-am-sgmm2.h MleSgmm2SpeakerAccs), JAX's two
    passes, each over all entries in state groups."""
    T_dim = model.spk_dim
    dev = model.device
    if T_dim == 0:
        return Sgmm2SpeakerState(v=torch.zeros(0, dtype=F64, device=dev))
    spk = Sgmm2SpeakerState(v=torch.zeros(T_dim, dtype=F64, device=dev))
    SinvN = torch.einsum("ide,iet->idt", model.Sigma_inv, model.N)
    Hspk = torch.einsum("idt,idu->itu", model.N, SinvN)
    x = model._x(feats)
    ent = state_entries(state_post, dev)
    gsel = model.gselect(x, num_gselect)
    for _ in range(num_iters):
        lhs = torch.eye(T_dim, dtype=F64, device=dev)
        rhs = torch.zeros(T_dim, dtype=F64, device=dev)
        for s, e, ge, post, _tot in state_posteriors(model, x, ent, gsel,
                                                     spk):
            P = _dense(post, ge, model.num_gauss)               # [E, M, I]
            mu = model.means(s)                                 # no speaker
            xe = x[ent[0][e]]
            resid = (torch.einsum("emi,ed->id", P, xe)
                     - torch.einsum("emi,mid->id", P, mu))
            rhs += torch.einsum("idt,id->t", SinvN, resid)
            lhs += torch.einsum("i,itu->tu", P.sum((0, 1)), Hspk)
        spk = Sgmm2SpeakerState(v=torch.linalg.solve(lhs, rhs))
    return spk


def train_sgmm2(model: AmSgmm2, feats, state_post,
                num_iters: int = 6, num_gselect: int = 10,
                split_substates_to: int | None = None,
                schedule=("vc", "Mc", "vwc", "Sc"),
                iter_stats: list | None = None, snapshot=None):
    """Block-coordinate EM (steps/train_sgmm2.sh's loop shape: one
    parameter group per iteration with fresh statistics), JAX's schedule.
    -> (model, per-iteration loglikes). iter_stats, if given, gets one dict
    per iteration: "iter", "flags", "loglike", "accumulate" and "update"
    seconds (after a device sync). snapshot, if given, is called as
    snapshot(iteration, flags, model, accs) before each update."""
    import time
    likes = []
    for it in range(num_iters):
        t0 = time.perf_counter()
        accs = Sgmm2Accs(model)
        accs.accumulate(model, feats, state_post, num_gselect)
        likes.append(accs.tot_like / max(accs.tot_frames, 1.0))
        t1 = time.perf_counter()
        flags = schedule[it % len(schedule)]
        if snapshot is not None:
            snapshot(it, flags, model, accs)
        model = update_sgmm2(model, accs, update_flags=flags)
        if split_substates_to and it == num_iters // 2:
            model.split_substates(split_substates_to,
                                  state_occs=accs.state_occs())
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        if iter_stats is not None:
            iter_stats.append(dict(iter=it, flags=flags, loglike=likes[-1],
                                   accumulate=t1 - t0,
                                   update=time.perf_counter() - t1))
    return model, likes
