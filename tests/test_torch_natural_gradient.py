"""Port parity: kaldi_tpu_torch.nnet.natural_gradient against JAX.

The same random gradients go through both transforms step by step, across
refreshes of the inverse-square-root factors. eigh's eigenvectors are not
unique, so only the preconditioned updates are compared (V w^-1/2 V^T is
unique), within 2e-5 of each leaf's largest update: LAPACK's eigh in
torch and in XLA agree to a few f32 ulps on these smoothed, well
conditioned factors, and the products after them sum in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from kaldi_tpu.nnet import natural_gradient as jng
from kaldi_tpu_torch.nnet import natural_gradient as tng
from kaldi_tpu_torch.nnet import optim
from kaldi_tpu_torch.params import (name_to_keystr, params_to_jax,
                                    tdnn_params_from_jax)

SHAPES = {"layers.0.w": (12, 8), "layers.0.b": (8,), "layers.1.w": (16, 8),
          "layers.1.b": (8,), "final.w": (8, 1), "final.b": (1,),
          "layers.2.w": (40, 6), "layers.2.b": (6,)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _to_jax(flat):
    return jax.tree.map(jnp.asarray, params_to_jax(
        {k: torch.from_numpy(v) for k, v in flat.items()}))


def _from_jax(tree):
    return {k: v.numpy() for k, v in
            tdnn_params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _run(ttx, jtx, steps, seed=0):
    """-> the steps at which some update differs from its plain gradient
    (so the test can check that refreshes happened)."""
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    jp = _to_jax(p0)
    ts, js = ttx.init(tp), jtx.init(jp)
    jupdate = jax.jit(jtx.update)
    changed = []
    for i in range(1, steps + 1):
        g = _tree(rng)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        ju, js = jupdate(_to_jax(g), js, jp)
        ju = _from_jax(ju)
        for k in SHAPES:
            top = np.abs(ju[k]).max()
            err = np.abs(tu[k].numpy() - ju[k]).max()
            assert err <= 2e-5 * top, (i, k, err, top)
        if any(not np.allclose(ju[k], g[k], rtol=1e-4, atol=1e-6)
               for k in SHAPES):
            changed.append(i)
        tp = optim.apply_updates(tp, tu)
        jp = optax.apply_updates(jp, _to_jax(ju))
    return changed


def test_preconditioned_updates_match_jax_across_refreshes():
    changed = _run(tng.natural_gradient(alpha=0.5, update_period=3),
                   jng.natural_gradient(alpha=0.5, update_period=3), 8)
    assert changed == [3, 4, 5, 6, 7, 8]      # plain until the first refresh


def test_param_filter_and_dims():
    """A filter on the port's names against the same filter on JAX's
    keystr names; min_dim drops final.w [8, 1], max_dim drops
    layers.2.w [40, 6]."""
    def keep(name):
        return not name.startswith("layers.1")

    ttx = tng.natural_gradient(alpha=1.0, update_period=2, min_dim=2,
                               max_dim=32, param_filter=keep)
    jtx = jng.natural_gradient(
        alpha=1.0, update_period=2, min_dim=2, max_dim=32,
        param_filter=lambda ks: keep(
            {name_to_keystr(n): n for n in SHAPES}[ks]))
    state = ttx.init({k: torch.zeros(s) for k, s in SHAPES.items()})
    assert sorted(state.factors) == ["layers.0.w"]
    jstate = jtx.init(_to_jax({k: np.zeros(s, np.float32)
                               for k, s in SHAPES.items()}))
    assert sorted(jstate.factors) == [name_to_keystr("layers.0.w")]
    _run(ttx, jtx, 5)


def test_preconditioning_keeps_each_gradient_norm():
    ttx = tng.natural_gradient(alpha=1.0, update_period=1)
    rng = np.random.default_rng(3)
    g = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    out, state = ttx.update(g, ttx.init(g))
    assert state.step == 1 and isinstance(state.step, int)
    for k in ("layers.0.w", "layers.1.w"):
        assert not torch.allclose(out[k], g[k], rtol=1e-3)
        assert float(out[k].norm()) == pytest.approx(float(g[k].norm()),
                                                     rel=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_ng_sgd_matches_jax_over_a_refresh(momentum):
    """12 steps of NG-SGD, update_period 10: the factors are refreshed at
    step 10 and used in steps 10-12."""
    _run(tng.ng_sgd(0.05, alpha=0.5, update_period=10, momentum=momentum),
         jng.ng_sgd(0.05, alpha=0.5, update_period=10, momentum=momentum),
         12, seed=1)
