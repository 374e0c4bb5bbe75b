"""Raw fMLLR: fMLLR estimated on the pre-splice features of a model that
lives in the projected (LDA+MLLT) space, on a device.

Counterpart of kaldi_tpu/transform/fmllr_raw.py (ref: transform/fmllr-raw.h
FmllrRawAccs — the speaker transform W acts on the raw d-dim frames; the
model sees y_t = T [splice_k(W x^_{t+k}); 1] with T the fixed LDA+MLLT
projection). As in JAX the auxiliary

   Q(W) = beta log|det A| + sum_t sum_m gamma_tm (-0.5 (y_t - mu_m)'
          Sigma_m^-1 (y_t - mu_m))

is maximised directly, in f32, by gradient ascent: JAX's optax.adam steps
at its learning rate (the port's `nnet.optim.adam`, optax's arithmetic)
through autograd, keeping the best W seen. The accumulators hold, per
frame, the spliced raw window, the aligned pdf's means and inverse
variances padded to the largest pdf (means 0, inverse variances 1,
posteriors 0, as JAX pads them) and the gaussian posteriors from the
port's `AmDiagGmm` on its device.

Kaldi's FmllrRawAccs also models the LDA's rejected dimensions (a unit
gaussian on the rows the projection drops); JAX's objective, ported as it
is, does not.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.nnet.optim import adam, apply_updates
from kaldi_tpu_torch.ops.delta import splice_frames
from kaldi_tpu_torch.transform.fmllr import _posteriors_np

F32 = torch.float32


class FmllrRawAccs:
    """Frame-level statistics on `device`: spliced raw windows [T, n d] and
    the aligned pdf's padded gaussian terms (means and inverse variances
    [T, M, D_model], posteriors [T, M])."""

    def __init__(self, raw_dim: int, splice_left: int, splice_right: int,
                 device="cuda"):
        self.device = resolve_device(device)
        self.d = raw_dim
        self.L, self.R = splice_left, splice_right
        self._chunks: list = []

    @property
    def num_frames(self) -> int:
        return sum(len(c[0]) for c in self._chunks)

    def accumulate_from_alignment(self, am, raw_feats, transform_T,
                                  pdf_ids):
        """raw_feats [T, d]; transform_T [D_model, (L+R+1) d + 1]; pdf_ids
        [T] aligned pdfs. Splices on the device, projects in f64 as JAX
        does (f32 windows times the f64 transform), takes each frame's
        posteriors within its pdf from `am` on the AM's device."""
        x = torch.as_tensor(np.asarray(raw_feats, np.float32),
                            device=self.device)
        spliced = splice_frames(x, self.L, self.R).cpu().numpy()
        Tm = np.asarray(transform_T, np.float64)
        y = spliced @ Tm[:, :-1].T + Tm[:, -1]
        pdf_ids = np.asarray(pdf_ids)
        post = _posteriors_np(am, y.astype(np.float32), pdf_ids,
                              np.ones(len(y), np.float32))
        offsets = np.cumsum([0] + [p.num_gauss for p in am.pdfs])
        means, inv_vars, gammas = [], [], []
        for t, pdf in enumerate(pdf_ids):
            g = am.pdfs[int(pdf)]
            means.append(g.means)
            inv_vars.append(1.0 / g.vars)
            gammas.append(post[t, offsets[pdf]:offsets[pdf + 1]])
        self.add_frames(spliced, means, inv_vars, gammas)

    def add_frames(self, windows, means, inv_vars, gammas):
        """Per-frame windows [T, n d] and lists of each frame's means [M_t,
        D], inverse variances and posteriors [M_t], padded as JAX pads."""
        M = max(m.shape[0] for m in means)
        T, D = len(means), means[0].shape[1]
        mu = np.zeros((T, M, D))
        iv = np.ones((T, M, D))
        gam = np.zeros((T, M))
        for t in range(T):
            m = means[t].shape[0]
            mu[t, :m] = means[t]
            iv[t, :m] = inv_vars[t]
            gam[t, :m] = gammas[t]
        self._chunks.append(tuple(
            torch.tensor(a, dtype=F32, device=self.device)
            for a in (np.asarray(windows), mu, iv, gam)))

    def stacked(self) -> tuple:
        """(windows [T, n d], means [T, M, D], inverse variances, gammas
        [T, M]), f32, every chunk padded to the largest M."""
        M = max(c[1].shape[1] for c in self._chunks)
        out = [[], [], [], []]
        for X, mu, iv, gam in self._chunks:
            p = M - mu.shape[1]
            out[0].append(X)
            out[1].append(torch.nn.functional.pad(mu, (0, 0, 0, p)))
            out[2].append(torch.nn.functional.pad(iv, (0, 0, 0, p),
                                                  value=1.0))
            out[3].append(torch.nn.functional.pad(gam, (0, p)))
        return tuple(torch.cat(o) for o in out)

    def beta(self) -> float:
        return float(sum(c[3].double().sum() for c in self._chunks)) \
            if self._chunks else 0.0


def fmllr_raw_auxf(W, X, Tmat, mu, iv, gam, beta: float, d: int,
                   n_splice: int) -> torch.Tensor:
    """JAX's f32 auxiliary (fmllr_raw.py:90-101) at W [d, d+1]."""
    T = X.shape[0]
    A, b = W[:, :d], W[:, d]
    Xw = X.reshape(T, n_splice, d) @ A.T + b
    y = Xw.reshape(T, n_splice * d) @ Tmat[:, :-1].T + Tmat[:, -1]
    diff = y[:, None, :] - mu
    q = -0.5 * torch.sum(gam[:, :, None] * iv * diff * diff)
    _sign, logdet = torch.linalg.slogdet(A)
    return q + beta * logdet


def estimate_fmllr_raw(accs: FmllrRawAccs, transform_T,
                       num_steps: int = 150, lr: float = 0.02,
                       min_count: float = 100.0, history: list | None = None):
    """-> (W_raw [d, d+1] f32 numpy, objf improvement per frame), on the
    accumulators' device: JAX's Adam ascent, the best W kept (the
    objective of each W after its update, not before). Identity under
    min_count. history, if given, gets each step's objective."""
    d = accs.d
    n_splice = accs.L + accs.R + 1
    ident = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    beta = accs.beta()
    if beta < min_count or not accs._chunks:
        return ident.astype(np.float32), 0.0
    X, mu, iv, gam = accs.stacked()
    Tmat = torch.as_tensor(np.asarray(transform_T), dtype=F32,
                           device=accs.device)

    def auxf(W):
        return fmllr_raw_auxf(W, X, Tmat, mu, iv, gam, beta, d, n_splice)

    W = torch.as_tensor(ident, dtype=F32, device=accs.device)
    with torch.no_grad():
        base = float(auxf(W))
    tx = adam(lr)
    params = {"W": W}
    st = tx.init(params)
    best = (W, base)
    for _ in range(num_steps):
        w = params["W"].detach().requires_grad_(True)
        (-auxf(w)).backward()
        upd, st = tx.update({"W": w.grad}, st)
        params = apply_updates({"W": w.detach()}, upd)
        with torch.no_grad():
            val = float(auxf(params["W"]))
        if history is not None:
            history.append(val)
        if val > best[1]:
            best = (params["W"], val)
    W, final = best
    return W.cpu().numpy(), (final - base) / beta
