"""fMPE: discriminatively trained feature-space offsets.

(ref: transform/fmpe.h Fmpe — high-dimensional per-frame vector h_t of
 Gaussian posteriors (with left/right context blocks), projected by a big
 matrix M to a feature offset o_t = M h_t added to the features; M trained
 by gradient from the MPE/sMBR differential (Povey et al. 2005). The
 posterior/projection/update path here is jnp-matmul shaped: h is a dense
 [T, C*I] matrix (I small at recipe scale), every step is a GEMM.)

The port's copy of kaldi_tpu/transform/fmpe.py (host code: numpy
posteriors and products, as in JAX), carried verbatim so the port
imports nothing of kaldi_tpu; tests hold the two equal. `compose_transforms`
serves SAT; `Fmpe` serves fMMI (`steps/fmmi.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm


@dataclasses.dataclass
class FmpeOptions:
    context_windows: tuple = ((0,), (-1, 1), (-2, -3), (2, 3))
    post_scale: float = 5.0
    learning_rate: float = 0.005


class Fmpe:
    def __init__(self, gmm: DiagGmm, dim: int,
                 opts: FmpeOptions = FmpeOptions()):
        self.gmm = gmm
        self.opts = opts
        self.dim = dim
        C = len(opts.context_windows)
        I = gmm.num_gauss
        self.M = np.zeros((dim, C * I))

    def _h(self, feats: np.ndarray) -> np.ndarray:
        """Context-expanded Gaussian posteriors [T, C*I]."""
        post = self.gmm.posteriors(feats.astype(np.float32))  # [T, I]
        post = post * self.opts.post_scale
        T = len(feats)
        blocks = []
        for win in self.opts.context_windows:
            acc = np.zeros_like(post)
            for off in win:
                lo = max(0, -off)
                hi = min(T, T - off)
                acc[lo:hi] += post[lo + off: hi + off]
            blocks.append(acc / len(win))
        return np.concatenate(blocks, axis=1)

    def apply(self, feats: np.ndarray) -> np.ndarray:
        """feats + M h(feats) (ref: fmpe.h Fmpe::ComputeFeatures)."""
        return feats + self._h(feats) @ self.M.T

    def direct_differential(self, am, feats_out: np.ndarray, post) -> np.ndarray:
        """∂F/∂o_t from per-frame signed pdf posteriors `post[t] = [(pdf,w)]`
        (the MPE gammas): Σ w · Σ_m γ_m Σ⁻¹(μ_m − x)
        (ref: fmpe.cc ComputeStddevs/AccStats direct differential)."""
        T, D = feats_out.shape
        out = np.zeros((T, D))
        for t, frame in enumerate(post):
            x = feats_out[t]
            for pdf, w in frame:
                g = am.pdfs[pdf]
                cp = g.posteriors(x[None])[0]
                out[t] += w * (cp[:, None] * (g.means - x) / g.vars).sum(0)
        return out

    def train_step(self, feats_in: np.ndarray, dF_do: np.ndarray):
        """SGD on M from the accumulated differential."""
        h = self._h(feats_in)
        self.M += self.opts.learning_rate * (dF_do.T @ h) \
            / max(len(feats_in), 1)


def compose_transforms(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Affine composition: (a ∘ b)(x) = a(b(x)); a, b are [D, D+1]
    (ref: featbin/compose-transforms.cc, b-is-affine case)."""
    D = a.shape[0]
    A, abias = a[:, :D], a[:, D]
    B = np.concatenate([b, np.zeros((1, D + 1))], axis=0)
    B[D, D] = 1.0
    out = np.concatenate([A, abias[:, None]], axis=1) @ B
    return out
