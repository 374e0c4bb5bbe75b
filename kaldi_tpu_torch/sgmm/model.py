"""The SGMM2 acoustic model, its parameters as f64 tensors on a device.

Counterpart of kaldi_tpu/sgmm/model.py (ref: sgmm2/am-sgmm2.h — shared
full-covariance UBM (Sigma_i, unadapted means), phonetic subspace M_i
[D, S], speaker subspace N_i [D, T], log-weight projections w_i [S]; per
state substate vectors v_jm [S] and substate weights c_jm).

JAX keeps the model in host numpy (f64) and scores frame by frame. Here
every parameter lives on `device` in f64, the substates of all states in
one flat [Mtot, S] tensor `V` (state j's are rows `offsets[j]:offsets[j+1]`,
in JAX's order), and scoring uses Kaldi's normaliser form over only the
gselected gaussians (sgmm2/am-sgmm2.cc ComputeNormalizers, LogLikelihood):

    log p(x_t, m, i | j) = n_jmi + z_ti . v_jm - 0.5 x_t' Sigma_i^-1 x_t
    n_jmi = log c_jm + log w_jmi + gconst_i - 0.5 v_jm' H_i v_jm
    z_ti  = (Sigma_i^-1 M_i)' x_t,   H_i = M_i' Sigma_i^-1 M_i

which is JAX's direct -0.5 (x - mu)' Sigma^-1 (x - mu) expanded: no
[T, M, I, D] difference tensor is built. A speaker offset o_i = N_i s
enters as x - o_i in z and in the quadratic. The quadratic for all I at
once is one f64 GEMM of [x_d x_e] against the packed inverse covariances
(`_quad_pack`), z one GEMM against [D, I S], both cut to the K gselected
gaussians per frame.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.gmm.full_gmm import FullGmm

LOG_2PI = math.log(2.0 * math.pi)
F64 = torch.float64
CHUNK_ELEMS = 1 << 23      # f64 elements of the largest per-chunk block


@dataclasses.dataclass
class Sgmm2SpeakerState:
    """Per-speaker vector (ref: sgmm2/am-sgmm2.h Sgmm2PerSpkDerivedVars)."""
    v: torch.Tensor   # [T] f64


class AmSgmm2:
    def __init__(self, ubm: FullGmm, num_states: int, phn_dim: int,
                 spk_dim: int = 0, seed: int = 0, device="cuda"):
        """Initialize from a trained full-covariance UBM
        (ref: sgmm2bin/sgmm2-init.cc): M_i's first column the UBM mean,
        v_j0 = e_1, so the initial model is the UBM tied across states. The
        random columns are JAX's draws (RandomState(seed)), made on the
        host and moved to `device`."""
        self.device = resolve_device(device)
        I, D = ubm.means.shape
        S = phn_dim
        rng = np.random.RandomState(seed)
        M = np.zeros((I, D, S))
        M[:, :, 0] = ubm.means
        if S > 1:
            M[:, :, 1:] = rng.randn(I, D, S - 1) * 0.1
        w = np.zeros((I, S))
        w[:, 0] = np.log(np.maximum(ubm.weights, 1e-10))
        N = rng.randn(I, D, spk_dim) * 0.1 if spk_dim > 0 else None
        self.Sigma_inv = self._t(ubm.inv_covars())
        self.M = self._t(M)
        self.w = self._t(w)
        self.N = None if N is None else self._t(N)
        V = np.zeros((num_states, S))
        V[:, 0] = 1.0
        self.V = self._t(V)
        self.c = self._t(np.ones(num_states))
        self.offsets = np.arange(num_states + 1, dtype=np.int64)
        self.norm_set_ids = None
        self._update_derived()

    def _t(self, a) -> torch.Tensor:
        """A copy of `a` (an array or a tensor on any device) as f64 on the
        model's device, never a view of a host array."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=F64, copy=True)
        return torch.tensor(np.asarray(a), dtype=F64, device=self.device)

    # --- sizes ---

    @property
    def num_gauss(self) -> int:
        return self.M.shape[0]

    @property
    def dim(self) -> int:
        return self.M.shape[1]

    @property
    def phn_dim(self) -> int:
        return self.M.shape[2]

    @property
    def spk_dim(self) -> int:
        return 0 if self.N is None else self.N.shape[2]

    @property
    def num_states(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_substates(self) -> np.ndarray:
        return np.diff(self.offsets)

    def state_of_substate(self) -> torch.Tensor:
        """[Mtot] int64: the state each flat substate belongs to."""
        return torch.as_tensor(np.repeat(np.arange(self.num_states),
                                         self.num_substates),
                               device=self.device)

    def substate_table(self) -> torch.Tensor:
        """[J, Mmax] int64 flat substate indices per state, Mtot (a pad
        row's index) where a state has fewer."""
        n = self.num_substates
        Mmax = int(n.max())
        tab = np.full((self.num_states, Mmax), int(self.offsets[-1]),
                      np.int64)
        for j in range(self.num_states):
            tab[j, :n[j]] = np.arange(self.offsets[j], self.offsets[j + 1])
        return torch.as_tensor(tab, device=self.device)

    def v_of(self, j: int) -> torch.Tensor:
        return self.V[self.offsets[j]:self.offsets[j + 1]]

    def to(self, device) -> "AmSgmm2":
        """A copy with every tensor on `device`."""
        out = self.copy()
        out.device = resolve_device(device)
        for k, v in vars(out).items():
            if isinstance(v, torch.Tensor):
                setattr(out, k, v.to(out.device))
        return out

    def copy(self) -> "AmSgmm2":
        out = object.__new__(AmSgmm2)
        for k, v in vars(self).items():
            setattr(out, k, v.clone() if isinstance(v, torch.Tensor)
                    else (v.copy() if isinstance(v, np.ndarray) else v))
        return out

    # --- derived quantities ---

    def _update_derived(self):
        """(ref: AmSgmm2::ComputeDerivedVars) gconst_i = -0.5 (D log 2pi -
        log|Sigma_i^-1|), SinvM_i = Sigma_i^-1 M_i, H_i = M_i' SinvM_i;
        and the packs the scoring GEMMs use."""
        I, D, S = self.M.shape
        _sign, logdet = torch.linalg.slogdet(self.Sigma_inv)
        self.gconst = -0.5 * (D * LOG_2PI - logdet)
        self.SinvM = torch.einsum("ide,ies->ids", self.Sigma_inv, self.M)
        self.H = torch.einsum("ids,idt->ist", self.M, self.SinvM)
        self.quad_pack = _quad_pack(self.Sigma_inv)               # [P, I]
        self.z_pack = self.SinvM.permute(1, 0, 2).reshape(D, I * S)

    def gselect_pack(self) -> torch.Tensor:
        """[1 + D + P, I]: `full_features(x) @ pack` is JAX's gselect
        score gconst_i - 0.5 (x - mu_i)' Sigma_i^-1 (x - mu_i) + w_i0 with
        mu_i = M_i[:, 0]."""
        mu = self.M[:, :, 0]
        lin = torch.einsum("ide,ie->id", self.Sigma_inv, mu)
        const = self.gconst + self.w[:, 0] - 0.5 * (lin * mu).sum(1)
        return torch.cat([const[None], lin.T, self.quad_pack], dim=0)

    def log_weights(self) -> torch.Tensor:
        """[Mtot, I] log w_jmi: the softmax of V w' over i, renormalised
        within each `norm_set_ids` subset when set
        (ref: sgmm/am-sgmm.cc:822 ComputeNormalizersNormalized)."""
        logw = self.log_weights_plain()
        if self.norm_set_ids is not None:
            sets = np.asarray(self.norm_set_ids)
            for s in np.unique(sets):
                idx = torch.as_tensor(np.flatnonzero(sets == s),
                                      device=self.device)
                sub = logw[:, idx]
                logw[:, idx] = sub - torch.logsumexp(sub, dim=1, keepdim=True)
        return logw

    def log_weights_plain(self) -> torch.Tensor:
        """[Mtot, I] the softmax of V w' over i, without `norm_set_ids`
        (what JAX's updates and pre-transform use)."""
        return torch.log_softmax(self.V @ self.w.T, dim=1)

    def normalizers(self) -> torch.Tensor:
        """[Mtot, I] n_jmi = log c_jm + log w_jmi + gconst_i
        - 0.5 v_jm' H_i v_jm."""
        vHv = torch.einsum("ms,ist,mt->mi", self.V, self.H, self.V)
        return (torch.log(torch.clamp(self.c, min=1e-20))[:, None]
                + self.log_weights() + self.gconst[None] - 0.5 * vHv)

    def means(self, j: int | None = None, spk=None) -> torch.Tensor:
        """mu_jmi = M_i v_jm (+ N_i s): [M_j, I, D] for state j, or
        [Mtot, I, D]."""
        V = self.V if j is None else self.v_of(j)
        mu = torch.einsum("ids,ms->mid", self.M, V)
        off = self.spk_offsets(spk)
        return mu if off is None else mu + off[None]

    def spk_offsets(self, spk) -> torch.Tensor | None:
        """[I, D] o_i = N_i s, or None without a speaker subspace."""
        if spk is None or self.N is None:
            return None
        return torch.einsum("idt,t->id", self.N, self._t(spk.v))

    # --- likelihoods ---

    def gselect_scores(self, x: torch.Tensor) -> torch.Tensor:
        """x [T, D] f64 on the model's device -> [T, I] gselect scores."""
        from kaldi_tpu_torch.gmm.full_gmm import full_features
        pack = self.gselect_pack()
        n = max(1, CHUNK_ELEMS // pack.shape[0])
        return torch.cat([full_features(x[i:i + n]) @ pack
                          for i in range(0, len(x), n)])

    def gselect(self, feats, num_gselect: int = 10) -> torch.Tensor:
        """Top gaussians per frame by the UBM-style full-covariance loglike
        (ref: Sgmm2GselectConfig am-sgmm2.h:118) -> [T, K] int64 on the
        model's device, best first (JAX's order up to ties)."""
        x = self._x(feats)
        k = min(num_gselect, self.num_gauss)
        return torch.topk(self.gselect_scores(x), k, dim=1).indices

    def _x(self, feats) -> torch.Tensor:
        return torch.as_tensor(feats, dtype=F64, device=self.device) \
            if not isinstance(feats, torch.Tensor) else \
            feats.to(device=self.device, dtype=F64)

    def frame_terms(self, x: torch.Tensor, gsel: torch.Tensor, spk=None):
        """For frames x [T, D] and their gselect [T, K]: (z [T, K, S],
        q [T, K]) with z_tk = SinvM_i' (x_t - o_i) and q_tk = -0.5
        (x_t - o_i)' Sigma_i^-1 (x_t - o_i), i = gsel[t, k]."""
        from kaldi_tpu_torch.gmm.full_gmm import full_features
        I, D, S = self.M.shape
        ff = full_features(x)[:, 1 + D:]
        q = torch.gather(ff @ self.quad_pack, 1, gsel)
        zf = (x @ self.z_pack).view(len(x), I, S)
        z = torch.gather(zf, 1, gsel[:, :, None].expand(-1, -1, S))
        off = self.spk_offsets_terms(spk)
        if off is not None:
            so, sinv_o, oso = off
            z = z - so[gsel]
            q = q + torch.gather(x @ sinv_o.T, 1, gsel) - 0.5 * oso[gsel]
        return z, q

    def spk_offsets_terms(self, spk):
        """(SinvM_i' o_i [I, S], Sigma_i^-1 o_i [I, D], o_i' Sigma_i^-1 o_i
        [I]) for the speaker, or None."""
        o = self.spk_offsets(spk)
        if o is None:
            return None
        sinv_o = torch.einsum("ide,ie->id", self.Sigma_inv, o)
        return (torch.einsum("ids,id->is", self.M, sinv_o), sinv_o,
                (o * sinv_o).sum(1))

    def _chunk(self, K: int, width: int) -> int:
        I, D, S = self.M.shape
        per = max(I * S, K * width, I + D * D)
        return max(1, CHUNK_ELEMS // per)

    def loglikes_matrix(self, feats, num_gselect: int = 10,
                        spk=None) -> torch.Tensor:
        """[T, num_states] f64 pseudo-loglikes on the model's device for
        the decoder: per frame, each state's log-sum-exp over its
        substates and the frame's gselected gaussians (JAX masks every
        other gaussian to -inf, so the result is the same)."""
        x = self._x(feats)
        nrm_t = self.normalizers().T.contiguous()               # [I, Mtot]
        tab = self.substate_table()
        K = min(num_gselect, self.num_gauss)
        Mtot = self.V.shape[0]
        out = []
        n = self._chunk(K, Mtot)
        for i in range(0, len(x), n):
            xc = x[i:i + n]
            g = torch.topk(self.gselect_scores(xc), K, dim=1).indices
            z, q = self.frame_terms(xc, g, spk)
            ll = nrm_t[g] + z @ self.V.T + q[:, :, None]      # [t, K, Mtot]
            lm = torch.logsumexp(ll, dim=1)                    # [t, Mtot]
            pad = lm.new_full((len(xc), 1), float("-inf"))
            out.append(torch.logsumexp(torch.cat([lm, pad], 1)[:, tab],
                                       dim=2))
        return torch.cat(out) if out else x.new_zeros((0, self.num_states))

    def state_component_loglikes(self, j: int, z: torch.Tensor,
                                 q: torch.Tensor, gsel: torch.Tensor,
                                 nrm: torch.Tensor | None = None):
        """Frames aligned to state j (z [E, K, S], q [E, K], gsel [E, K]) ->
        [E, M_j, K] loglikes of (substate, gselected gaussian)."""
        a, b = int(self.offsets[j]), int(self.offsets[j + 1])
        nrm = self.normalizers() if nrm is None else nrm
        n_j = nrm[a:b]                                          # [M_j, I]
        return (n_j.T[gsel].permute(0, 2, 1)
                + torch.einsum("eks,ms->emk", z, self.V[a:b])
                + q[:, None, :])

    def component_posteriors(self, j: int, x, gsel=None, spk=None):
        """One frame x [D] -> (post [M_j, I] normalised, loglike), over the
        gselected gaussians `gsel` [K] (all when None)."""
        x = self._x(x)[None]
        g = (torch.arange(self.num_gauss, device=self.device) if gsel is None
             else torch.as_tensor(gsel, device=self.device).long())[None]
        z, q = self.frame_terms(x, g, spk)
        ll = self.state_component_loglikes(j, z, q, g)[0]       # [M_j, K]
        tot = torch.logsumexp(ll.reshape(-1), 0)
        post = torch.zeros((ll.shape[0], self.num_gauss), dtype=F64,
                           device=self.device)
        post[:, g[0]] = torch.exp(ll - tot)
        return post, tot

    def log_likelihood(self, j: int, x, gsel=None, spk=None) -> torch.Tensor:
        """log p(x|j) for one frame, optionally restricted to gselect."""
        return self.component_posteriors(j, x, gsel, spk)[1]

    # --- dimension surgery (ref: sgmmbin/sgmm-mixup.cc) ---

    def increase_phn_dim(self, new_S: int, seed: int = 0):
        """Grow the phonetic subspace to new_S columns: new M_i columns are
        JAX's small random draws, substate vectors zero-padded (so the
        likelihoods are unchanged)."""
        I, D, S = self.M.shape
        if new_S <= S:
            return
        if new_S > D + 1:
            raise ValueError(f"phn dim {new_S} > feature dim + 1 = {D + 1}")
        rng = np.random.RandomState(seed)
        extra = self._t(rng.randn(I, D, new_S - S) * 0.1)
        self.M = torch.cat([self.M, extra], dim=2)
        self.w = torch.cat([self.w, self.w.new_zeros((I, new_S - S))], 1)
        self.V = torch.cat([self.V, self.V.new_zeros((len(self.V),
                                                      new_S - S))], 1)
        self._update_derived()

    def increase_spk_dim(self, new_T: int, seed: int = 0):
        """Grow (or create) the speaker subspace to new_T columns."""
        I, D, _S = self.M.shape
        if new_T > D:
            raise ValueError(f"spk dim {new_T} > feature dim {D}")
        rng = np.random.RandomState(seed)
        T_old = self.spk_dim
        if new_T <= T_old:
            return
        extra = self._t(rng.randn(I, D, new_T - T_old) * 0.1)
        self.N = extra if self.N is None else torch.cat([self.N, extra], 2)

    def remove_speaker_space(self):
        self.N = None

    # --- substate splitting (ref: AmSgmm2::SplitSubstates) ---

    def split_substates(self, target_total: int, perturb: float = 0.01,
                        state_occs=None, seed: int = 0):
        """JAX's loop on host copies of V and c, in its RNG order: split
        the first substate of largest occ_j c_jm (v +- noise, c halved),
        the new one appended after its state's last."""
        rng = np.random.RandomState(seed)
        V = [list(r) for r in np.split(self.V.cpu().numpy(),
                                       self.offsets[1:-1])]
        c = [list(r) for r in np.split(self.c.cpu().numpy(),
                                       self.offsets[1:-1])]
        occ = (np.ones(self.num_states) if state_occs is None
               else np.asarray(state_occs, np.float64))
        total = int(self.offsets[-1])
        while total < target_total:
            flat = np.concatenate([occ[j] * np.asarray(c[j])
                                   for j in range(self.num_states)])
            best = int(np.argmax(flat))
            j = int(np.searchsorted(np.cumsum([len(cj) for cj in c]), best,
                                    side="right"))
            m = best - sum(len(cj) for cj in c[:j])
            v = V[j][m]
            noise = rng.randn(self.phn_dim) * perturb
            V[j][m] = v + noise
            V[j].append(v - noise)
            cc = c[j][m] / 2
            c[j][m] = cc
            c[j].append(cc)
            total += 1
        self.V = self._t(np.concatenate([np.stack(vj) for vj in V]))
        self.c = self._t(np.concatenate([np.asarray(cj) for cj in c]))
        self.offsets = np.concatenate([[0], np.cumsum([len(cj) for cj in c])]
                                      ).astype(np.int64)


def _quad_pack(Sinv: torch.Tensor) -> torch.Tensor:
    """[I, D, D] inverse covariances -> [P, I], P = D (D + 1) / 2: -0.5
    times each pair d <= e (off-diagonal pairs summed over both halves), so
    that `full_features(x)[:, 1 + D:] @ pack` is -0.5 x' Sigma_i^-1 x."""
    D = Sinv.shape[1]
    rows, cols = np.triu_indices(D)
    r = torch.as_tensor(rows, device=Sinv.device)
    c = torch.as_tensor(cols, device=Sinv.device)
    quad = Sinv[:, r, c] + torch.where(r != c, Sinv[:, c, r], 0.0)
    return (-0.5 * quad).T.contiguous()
