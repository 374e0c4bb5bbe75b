"""Multiclass logistic regression (the LID classifier over i-vectors).

(ref: ivector/logistic-regression.h LogisticRegression — trained with
 L-BFGS on the multiclass log-loss with L2 prior ('normalizer'); supports
 class priors adjustment and mixture components per class via
 --mix-up (single-component here).)

Counterpart of kaldi_tpu/ivector/logistic_regression.py, which trains
full-batch Adam steps under jit with optax. The port takes the same steps
with torch autograd on `device` and its own `nnet/optim.adam`, in float32
as JAX does; scoring (`log_posteriors`, `classify`, `scale_priors`) is
host numpy, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.nnet import optim


@dataclasses.dataclass
class LogisticRegressionConfig:
    max_steps: int = 100
    normalizer: float = 0.0025    # L2 regularizer (ref default)
    learning_rate: float = 0.5


class LogisticRegression:
    def __init__(self, weights: np.ndarray | None = None):
        self.weights = weights    # [C, D+1]

    def train(self, X: np.ndarray, labels: np.ndarray,
              config: LogisticRegressionConfig = LogisticRegressionConfig(),
              device="cuda"):
        """X [N, D], labels [N] ints in [0, C). -> the loss of the final
        weights (f32 mean log-loss plus normalizer * sum w^2)."""
        dev = resolve_device(device)
        N, D = X.shape
        C = int(labels.max()) + 1
        Xp = torch.cat([torch.as_tensor(X, dtype=torch.float32, device=dev),
                        torch.ones((N, 1), dtype=torch.float32, device=dev)],
                       dim=1)
        y = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                            device=dev)

        def loss_fn(w):
            lp = torch.log_softmax(Xp @ w.T, dim=1)
            nll = -torch.mean(torch.take_along_dim(lp, y[:, None], 1))
            return nll + config.normalizer * torch.sum(w * w)

        tx = optim.adam(config.learning_rate)
        params = {"w": torch.zeros((C, D + 1), dtype=torch.float32,
                                   device=dev)}
        st = tx.init(params)
        for _ in range(config.max_steps):
            w = params["w"].detach().requires_grad_(True)
            g, = torch.autograd.grad(loss_fn(w), w)
            upd, st = tx.update({"w": g}, st)
            params = optim.apply_updates({"w": w.detach()}, upd)
        self.weights = params["w"].cpu().numpy()
        # loss of the FINAL weights (also well-defined for max_steps=0)
        with torch.no_grad():
            return float(loss_fn(params["w"]))

    def log_posteriors(self, X: np.ndarray) -> np.ndarray:
        Xp = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        logits = Xp @ self.weights.T
        m = logits.max(axis=1, keepdims=True)
        lse = m + np.log(np.exp(logits - m).sum(axis=1, keepdims=True))
        return logits - lse

    def classify(self, X: np.ndarray) -> np.ndarray:
        return np.argmax(self.log_posteriors(X), axis=1)

    def scale_priors(self, log_priors: np.ndarray):
        """Adjust the bias column by new class log-priors
        (ref: logistic-regression.cc ScalePriors)."""
        self.weights[:, -1] += np.asarray(log_priors)
