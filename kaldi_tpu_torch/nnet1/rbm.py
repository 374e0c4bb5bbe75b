"""RBM pretraining with CD-1.

Counterpart of kaldi_tpu/nnet1/rbm.py (ref: nnet/nnet-rbm.h Rbm/RbmBase,
bernoulli | gaussian visible and hidden units;
nnetbin/rbm-train-cd1-frmshuff.cc, contrastive divergence with one Gibbs
step, momentum and weight decay). The weights start from the same numpy
`RandomState(seed)` draw as JAX's. A step is split in two: the hidden
sample comes from `sample_hidden` (a `torch.Generator`; JAX draws from a
key, which torch cannot reproduce) and the update, `cd1_update`, is a
function of that sample, so a test can hand it JAX's draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device


@dataclasses.dataclass
class RbmConfig:
    visible_dim: int
    hidden_dim: int
    visible_type: str = "gaussian"   # 'bernoulli' | 'gaussian'
    hidden_type: str = "bernoulli"
    learning_rate: float = 0.01
    momentum: float = 0.5
    l2_penalty: float = 2e-4


class Rbm:
    """W [hidden, visible], vis_bias, hid_bias and the momentum velocities
    `_vel` (of W, vis_bias, hid_bias), all f32 on `device`."""

    def __init__(self, cfg: RbmConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        dev = resolve_device(device)
        rng = np.random.RandomState(seed)
        s = 0.1 if cfg.visible_type == "gaussian" else 0.01
        self.W = torch.as_tensor(
            rng.randn(cfg.hidden_dim, cfg.visible_dim) * s,
            dtype=torch.float32, device=dev)
        self.vis_bias = torch.zeros(cfg.visible_dim, device=dev)
        self.hid_bias = torch.zeros(cfg.hidden_dim, device=dev)
        self._vel = (torch.zeros_like(self.W), torch.zeros_like(self.vis_bias),
                     torch.zeros_like(self.hid_bias))

    @property
    def device(self) -> torch.device:
        return self.W.device

    def propagate(self, v: torch.Tensor) -> torch.Tensor:
        """P(h|v) (ref: Rbm::Propagate)."""
        a = torch.matmul(v, self.W.T) + self.hid_bias
        return torch.sigmoid(a) if self.cfg.hidden_type == "bernoulli" else a

    def reconstruct(self, h: torch.Tensor) -> torch.Tensor:
        """E[v|h] (ref: Rbm::Reconstruct)."""
        a = torch.matmul(h, self.W) + self.vis_bias
        return torch.sigmoid(a) if self.cfg.visible_type == "bernoulli" \
            else a

    def sample_hidden(self, h_pos: torch.Tensor,
                      generator: torch.Generator | None) -> torch.Tensor:
        """Hidden states from P(h|v): uniform < h_pos (bernoulli), or h_pos
        plus standard normal noise (gaussian); drawn on the generator's
        device."""
        gdev = generator.device if generator is not None else None
        if self.cfg.hidden_type == "bernoulli":
            u = torch.rand(h_pos.shape, generator=generator, device=gdev)
            return (u.to(h_pos.device) < h_pos).to(torch.float32)
        n = torch.randn(h_pos.shape, generator=generator, device=gdev)
        return h_pos + n.to(h_pos.device)

    @torch.no_grad()
    def cd1_update(self, v_pos: torch.Tensor, h_sample: torch.Tensor,
                   h_pos: torch.Tensor | None = None) -> float:
        """The CD-1 update on a minibatch [N, V] given the hidden sample;
        -> the reconstruction's mean squared error (ref:
        rbm-train-cd1-frmshuff.cc's main loop)."""
        cfg = self.cfg
        N = v_pos.shape[0]
        if h_pos is None:
            h_pos = self.propagate(v_pos)
        v_neg = self.reconstruct(h_sample)
        h_neg = self.propagate(v_neg)
        dW = (torch.matmul(h_pos.T, v_pos) - torch.matmul(h_neg.T, v_neg)) / N
        dvb = torch.mean(v_pos - v_neg, dim=0)
        dhb = torch.mean(h_pos - h_neg, dim=0)
        mW, mvb, mhb = self._vel
        mW = cfg.momentum * mW + dW - cfg.l2_penalty * self.W
        mvb = cfg.momentum * mvb + dvb
        mhb = cfg.momentum * mhb + dhb
        self._vel = (mW, mvb, mhb)
        self.W = self.W + cfg.learning_rate * mW
        self.vis_bias = self.vis_bias + cfg.learning_rate * mvb
        self.hid_bias = self.hid_bias + cfg.learning_rate * mhb
        return float(torch.mean((v_pos - v_neg) ** 2))

    @torch.no_grad()
    def cd1_step(self, v_pos: torch.Tensor,
                 generator: torch.Generator | None) -> float:
        """One CD-1 update on a minibatch [N, V] -> reconstruction MSE."""
        h_pos = self.propagate(v_pos)
        return self.cd1_update(v_pos, self.sample_hidden(h_pos, generator),
                               h_pos)

    def as_dbn_layer(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (W, b) of the sigmoid layer this RBM initializes (ref:
        rbm-convert-to-nnet.cc), as numpy."""
        return self.W.cpu().numpy(), self.hid_bias.cpu().numpy()
