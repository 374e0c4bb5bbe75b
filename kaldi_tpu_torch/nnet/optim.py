"""Gradient transformations over dicts of tensors.

The port's counterpart of the optax transforms that kaldi_tpu's training
uses (optax is a JAX library; the port cannot import it). Each follows
optax 0.2.6's formulas:

- a transformation is `GradientTransformation(init, update)`:
  `init(params) -> state`, `update(updates, state, params=None) ->
  (updates, state)`; `apply_updates` adds the updates to the params;
- step counts stay host ints in the state, so an update never reads a
  device scalar and a schedule's rate is a host number;
- where optax computes a scalar in float32 from a weakly typed Python
  number (a schedule's rate, adam's bias corrections), the port does the
  same in numpy float32, so the scalars round as optax's do.

Updates are computed out of place: a step returns new tensors and never
writes into the params it was given.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

Params = dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params: Params, updates: Params) -> Params:
    """optax.apply_updates: p + u, in p's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def _f32(x) -> np.float32:
    return np.float32(x)


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, end_value: float | None = None
                      ) -> Callable[[int], float]:
    """count -> init * decay_rate ** (count / transition_steps) in float32,
    clipped at end_value (below if the rate decays, above if it grows);
    init_value at count <= 0."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: float(init_value)
    clip = np.maximum if decay_rate < 1.0 else np.minimum

    def schedule(count: int) -> float:
        if count <= 0:
            v = _f32(init_value)
        else:
            p = _f32(count) / _f32(transition_steps)
            v = _f32(init_value) * np.power(_f32(decay_rate), p)
        if end_value is not None:
            v = clip(v, _f32(end_value))
        return float(v)

    return schedule


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: None,
                                  lambda updates, state, params=None:
                                  (updates, state))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """Apply each transformation in order; the state is a tuple."""

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def global_norm(updates: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (a device
    scalar)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in updates.values()))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """select(norm < max_norm, g, (g / norm) * max_norm), leaf by leaf.

    Not torch.nn.utils.clip_grad_norm_: that scales by max_norm / (norm +
    1e-6), which shifts the result, and clips at norm == max_norm."""

    def update(updates, state, params=None):
        norm = global_norm(updates)
        keep = norm < max_norm
        return {k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: None, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """g + weight_decay * p."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return {k: g + weight_decay * params[k]
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: None, update)


def trace(decay: float) -> GradientTransformation:
    """Heavy-ball momentum: t = g + decay * t; the update is t."""

    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(updates, state, params=None):
        new = {k: g + decay * state[k] for k, g in updates.items()}
        return new, new

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """-lr * g; a schedule is evaluated at the count before this update
    (0 first), which the state holds as a host int."""
    if not callable(learning_rate):
        step = -float(_f32(learning_rate))
        return GradientTransformation(
            lambda params: None,
            lambda updates, state, params=None: (
                {k: g * step for k, g in updates.items()}, state))

    def update(updates, count, params=None):
        step = -learning_rate(count)
        return {k: g * step for k, g in updates.items()}, count + 1

    return GradientTransformation(lambda params: 0, update)


def sgd(learning_rate, momentum: float | None = None
        ) -> GradientTransformation:
    """optax.sgd: trace(momentum) (when given), then -lr."""
    return chain(trace(momentum) if momentum is not None else identity(),
                 scale_by_learning_rate(learning_rate))


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """mu and nu EMAs of g and g^2; the update is mu_hat / (sqrt(nu_hat) +
    eps) with the bias corrections 1 - b ** (count + 1) in float32."""

    def init(params):
        return AdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates, state, params=None):
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in updates.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k]
              for k, g in updates.items()}
        count = state.count + 1
        c1 = float(_f32(1) - _f32(b1) ** _f32(count))
        c2 = float(_f32(1) - _f32(b2) ** _f32(count))
        out = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
               for k in updates}
        return out, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def multi_transform(transforms: dict[str, GradientTransformation],
                    param_labels: dict[str, str]) -> GradientTransformation:
    """Each label's transformation sees only the leaves with that label."""

    def pick(tree, label):
        return None if tree is None else {
            k: v for k, v in tree.items() if param_labels[k] == label}

    def init(params):
        return {label: tx.init(pick(params, label))
                for label, tx in transforms.items()}

    def update(updates, state, params=None):
        out, new = {}, {}
        for label, tx in transforms.items():
            u, new[label] = tx.update(pick(updates, label), state[label],
                                      pick(params, label))
            out.update(u)
        return {k: out[k] for k in updates}, new

    return GradientTransformation(init, update)
