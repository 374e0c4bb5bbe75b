"""Linear-approximation VTLN (LVTLN) and per-speaker class selection, on a
device in f64.

Counterpart of kaldi_tpu/transform/lvtln.py (ref: transform/lvtln.h
LinearVtln — one linear transform A_c per warp class, trained to mimic
the effect of mel-warp factor w_c on the features; per speaker, the class
maximizing the fMLLR auxiliary with a bias estimated in closed form;
gmmbin/gmm-est-lvtln-trans). The class matrices live on `device`; a class
is one least-squares solve there, and the selection scores every class at
once (one batched slogdet and quadratic form) from the port's
`FmllrStats`.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.transform.fmllr import FmllrStats

F64 = torch.float64


class LinearVtln:
    def __init__(self, dim: int, warps, device="cuda"):
        """warps: the warp factors, 1.0 among them (the identity class)."""
        self.device = resolve_device(device)
        self.warps = list(warps)
        self.default_class = self.warps.index(1.0)
        self.A = torch.eye(dim, dtype=F64, device=self.device).repeat(
            len(self.warps), 1, 1)

    @property
    def dim(self):
        return self.A.shape[1]

    def train_class(self, c: int, feats_orig, feats_warped,
                    ridge: float = 1e-6):
        """Least-squares A_c: feats_warped ~ feats_orig A_c' (ref: lvtln
        training from pairs of unwarped and warped features)."""
        X = torch.as_tensor(np.asarray(feats_orig) if not isinstance(
            feats_orig, torch.Tensor) else feats_orig, dtype=F64,
            device=self.device)
        Y = torch.as_tensor(np.asarray(feats_warped) if not isinstance(
            feats_warped, torch.Tensor) else feats_warped, dtype=F64,
            device=self.device)
        G = X.T @ X + ridge * torch.eye(X.shape[1], dtype=F64,
                                        device=self.device)
        self.A[c] = torch.linalg.solve(G, X.T @ Y).T

    def select_class(self, stats: FmllrStats, estimate_bias: bool = True):
        """-> (class, transform [D, D+1] f64 numpy, auxiliary per class):
        per class [A_c, b_c] with the bias maximizing the auxiliary given
        A_c (b_d = (K[d, D] - G_d[D, :D] a_d) / G_d[D, D] where that
        denominator is positive), the first class of the best auxiliary
        (ref: lvtln.cc ComputeTransform)."""
        D = self.dim
        C = self.A.shape[0]
        K = torch.as_tensor(stats.K, dtype=F64, device=self.device)
        G = torch.as_tensor(stats.G, dtype=F64, device=self.device)
        W = torch.cat([self.A, self.A.new_zeros((C, D, 1))], dim=2)
        if stats.beta <= 0:
            best = self.default_class
            return best, W[best].cpu().numpy(), [-np.inf] * C
        if estimate_bias:
            num = K[None, :, D] - torch.einsum("dj,cdj->cd", G[:, D, :D],
                                               self.A)
            den = G[:, D, D]
            W[:, :, D] = torch.where(den > 0, num / den, 0.0)
        _s, logdet = torch.linalg.slogdet(self.A)
        quad = torch.einsum("cdp,dpq,cdq->c", W, G, W)
        auxf = (stats.beta * logdet + (K[None] * W).sum((1, 2))
                - 0.5 * quad).cpu().numpy()
        best = int(np.argmax(auxf))
        return best, W[best].cpu().numpy(), [float(a) for a in auxf]

    def warp_of(self, c: int) -> float:
        return self.warps[c]
