"""KL-HMM layer: KL-divergence acoustic scores over posterior features.

Counterpart of kaldi_tpu/nnet1/kl_hmm.py (ref: nnet/nnet-kl-hmm.h): each
HMM state s keeps an accumulated categorical distribution y_s over the
posterior feature's dimensions; a posterior frame z scores
sum_d y_s[d] log z[d] (= -KL(y_s || z) - H(y_s)). Training is counting
(host numpy f64, as in JAX); scoring is one [T, D] x [D, S] matmul of
log-posteriors against the state distributions, where the posteriors
are.
"""

from __future__ import annotations

import numpy as np
import torch


class KlHmm:
    def __init__(self, dim: int, num_states: int):
        self.counts = np.zeros((num_states, dim), np.float64)

    @property
    def num_states(self) -> int:
        return self.counts.shape[0]

    def accumulate(self, posteriors: np.ndarray, state_ali: np.ndarray):
        """posteriors [T, D] (rows sum to 1), state_ali [T] int states."""
        posteriors = np.asarray(posteriors, np.float64)
        for s in np.unique(state_ali):
            self.counts[int(s)] += posteriors[state_ali == s].sum(axis=0)

    def state_dists(self) -> np.ndarray:
        """[S, D] normalized state distributions (uniform if untrained)."""
        tot = self.counts.sum(axis=1, keepdims=True)
        D = self.counts.shape[1]
        uni = np.full_like(self.counts, 1.0 / D)
        return np.where(tot > 0, self.counts / np.maximum(tot, 1e-20), uni)

    def scores(self, posteriors) -> torch.Tensor:
        """[..., T, D] posteriors -> [..., T, S] f32 per-state scores."""
        z = torch.as_tensor(posteriors, dtype=torch.float32)
        y = torch.as_tensor(self.state_dists(), dtype=torch.float32,
                            device=z.device)
        return torch.matmul(torch.log(torch.clamp(z, min=1e-20)), y.T)
