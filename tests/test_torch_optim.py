"""Port parity: kaldi_tpu_torch.nnet.optim against optax.

Each transform runs 24 steps on both sides over the same random tree (a
TDNN-shaped params dict and its JAX pytree) with the same random
gradients; each step's updates are compared, and the params carried
forward with apply_updates on each side. Tolerance: 1e-6 of the largest
update of each leaf (f32 arithmetic in the same order; the scalars that
optax computes in float32 are computed in float32). Schedules are compared
as host numbers against optax's float32 values at 1e-6 relative: numpy's
float32 power and XLA's differ by up to a few float32 ulps (measured
1.7e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from kaldi_tpu_torch.nnet import optim
from kaldi_tpu_torch.params import params_to_jax, tdnn_params_from_jax

STEPS = 24
SHAPES = {"layers.0.w": (6, 5), "layers.0.b": (5,), "layers.1.w": (10, 5),
          "layers.1.b": (5,), "final.w": (5, 7), "final.b": (7,)}


def _tree(rng, scale=1.0) -> dict:
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _to_jax(flat: dict):
    return jax.tree.map(jnp.asarray, params_to_jax(
        {k: torch.from_numpy(v) for k, v in flat.items()}))


def _from_jax(tree) -> dict:
    return {k: v.numpy() for k, v in
            tdnn_params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _run_both(ttx, jtx, grad_scale=lambda i: 1.0, seed=0):
    """Run both transforms for STEPS steps; assert every step's updates
    agree."""
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    tparams = {k: torch.from_numpy(v) for k, v in p0.items()}
    jparams = _to_jax(p0)
    tstate, jstate = ttx.init(tparams), jtx.init(jparams)
    for i in range(STEPS):
        g = _tree(rng, grad_scale(i))
        tu, tstate = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                                tstate, tparams)
        ju, jstate = jtx.update(_to_jax(g), jstate, jparams)
        ju = _from_jax(ju)
        for k in SHAPES:
            top = max(np.abs(ju[k]).max(), 1e-30)
            err = np.abs(tu[k].numpy() - ju[k]).max()
            assert err <= 1e-6 * top, (i, k, err, top)
        tparams = optim.apply_updates(tparams, tu)
        jparams = optax.apply_updates(jparams, _to_jax(ju))


SCHEDULES = {
    "decay": (0.1, 20, 0.2, 0.02),     # reaches end_value at count 20
    "decay, clipped early": (0.1, 10, 0.2, 0.05),
    "grow": (0.01, 10, 3.0, 0.05),      # clipped above
    "no end": (2e-3, 7, 0.25, None),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_exponential_decay_matches_optax(name):
    init, steps, rate, end = SCHEDULES[name]
    t = optim.exponential_decay(init, steps, rate, end_value=end)
    j = optax.exponential_decay(init, steps, rate, end_value=end)
    vals = [t(c) for c in range(40)]
    for c, v in enumerate(vals):
        assert v == pytest.approx(float(j(jnp.int32(c))), rel=1e-6), c
    if end is not None:
        assert vals[-1] == pytest.approx(end, rel=1e-6)
        assert min(vals) >= np.float32(end) or max(vals) <= np.float32(end)


def test_clip_by_global_norm_on_both_sides_of_the_threshold():
    """One gradient at 0.5, 1 and 3 times max_norm and exactly at it
    (where optax scales by max_norm / norm, not keeps), then a chain over
    steps of varying size."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    g = _tree(np.random.default_rng(1))
    norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                       for v in g.values()))
    ttx, jtx = optim.clip_by_global_norm(6.0), optax.clip_by_global_norm(6.0)
    seen = set()
    for factor in (0.5, 6.0 / norm, 1.0, 3.0):
        gs = {k: (v * factor).astype(np.float32) for k, v in g.items()}
        tu, _ = ttx.update({k: torch.from_numpy(v) for k, v in gs.items()},
                           ttx.init(None))
        ju = _from_jax(jtx.update(_to_jax(gs), jtx.init(_to_jax(p0)))[0])
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), ju[k], rtol=1e-6,
                                       atol=1e-7)
        tn = float(optim.global_norm(tu))
        seen.add(tn < 6.0 - 1e-4)
        assert tn <= 6.0 + 1e-5
    assert seen == {True, False}
    _run_both(optim.chain(optim.clip_by_global_norm(6.0), optim.sgd(0.1)),
              optax.chain(optax.clip_by_global_norm(6.0), optax.sgd(0.1)),
              grad_scale=lambda i: (0.3, 1.0, 2.0)[i % 3])


def _sched():
    return (optim.exponential_decay(0.1, 12, 0.2, end_value=0.02),
            optax.exponential_decay(0.1, 12, 0.2, end_value=0.02))


CASES = {
    "sgd const": lambda: (optim.sgd(0.05), optax.sgd(0.05)),
    "sgd schedule": lambda: (optim.sgd(_sched()[0]), optax.sgd(_sched()[1])),
    "sgd momentum": lambda: (optim.sgd(_sched()[0], momentum=0.9),
                             optax.sgd(_sched()[1], momentum=0.9)),
    "add_decayed_weights": lambda: (optim.add_decayed_weights(1e-2),
                                    optax.add_decayed_weights(1e-2)),
    "adam const": lambda: (optim.adam(1e-2), optax.adam(1e-2)),
    "adam schedule": lambda: (
        optim.adam(optim.exponential_decay(2e-3, 10, 0.25, end_value=5e-4)),
        optax.adam(optax.exponential_decay(2e-3, 10, 0.25, end_value=5e-4))),
    "chain clip l2 momentum": lambda: (
        optim.chain(optim.clip_by_global_norm(5.0),
                    optim.add_decayed_weights(1e-3),
                    optim.sgd(_sched()[0], momentum=0.5)),
        optax.chain(optax.clip_by_global_norm(5.0),
                    optax.add_decayed_weights(1e-3),
                    optax.sgd(_sched()[1], momentum=0.5))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_optax_over_steps(name):
    ttx, jtx = CASES[name]()
    _run_both(ttx, jtx)


def test_multi_transform_matches_optax():
    labels = {k: ("hidden" if k.startswith("layers.") else "out")
              for k in SHAPES}
    jlabels = {"layers": [{"w": "hidden", "b": "hidden"}] * 2,
               "final": {"w": "out", "b": "out"}}
    ttx = optim.multi_transform({"hidden": optim.sgd(0.1),
                                 "out": optim.adam(1e-2)}, labels)
    jtx = optax.multi_transform({"hidden": optax.sgd(0.1),
                                 "out": optax.adam(1e-2)}, jlabels)
    _run_both(ttx, jtx)


def test_steps_keep_host_counts_and_do_not_write_their_inputs():
    ttx = optim.chain(optim.clip_by_global_norm(1.0),
                      optim.sgd(optim.exponential_decay(0.1, 5, 0.5),
                                momentum=0.9),
                      optim.adam(1e-3))
    params = {k: torch.from_numpy(v) for k, v in
              _tree(np.random.default_rng(0)).items()}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    keep = {k: v.clone() for k, v in {**params}.items()}
    state = ttx.init(params)
    for _ in range(3):
        _, state = ttx.update(grads, state, params)
    assert state[1][1] == 3 and isinstance(state[1][1], int)
    assert state[2][0].count == 3
    assert all(torch.equal(params[k], keep[k]) for k in params)
    assert all(torch.equal(g, torch.ones_like(g)) for g in grads.values())
