"""Port parity: the nnet2 component zoo's tail (kaldi_tpu_torch.nnet
components and components_extra) against kaldi_tpu's on the CPU.

`maxout`, `fixed_affine` and the activations on the same
inputs; `dropout` given JAX's `jax.random.bernoulli` mask and
`additive_noise` given JAX's `jax.random.normal` draw (torch cannot
reproduce a jax.random key's stream, so the component takes the drawn
values); `dct_matrix` exact, `dct_component` in both layouts and the
block affine with JAX's init carried across, each within 1e-6 relative
(one f32 matmul).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.nnet import components as jc
from kaldi_tpu.nnet import components_extra as jx
from kaldi_tpu_torch.nnet import components as tc
from kaldi_tpu_torch.nnet import components_extra as tx


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rel=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("out_dim", [1, 3, 6])
def test_maxout_matches_jax(out_dim):
    x = _x(0, 2, 5, 12)
    _close(tc.maxout(torch.from_numpy(x), out_dim), jc.maxout(x, out_dim), 0)


@pytest.mark.parametrize("proportion", [0.1, 0.5])
def test_dropout_with_jax_mask_matches_jax(proportion):
    x = _x(1, 3, 7, 16)
    key = jax.random.PRNGKey(3)
    mask = np.array(jax.random.bernoulli(key, 1.0 - proportion, x.shape))
    want = jc.dropout(key, jnp.asarray(x), proportion)
    _close(tc.dropout_masked(torch.from_numpy(x), torch.from_numpy(mask),
                             proportion), want)
    # the port's own draw: its keep share and its scale
    g = torch.Generator().manual_seed(0)
    y = tc.dropout(g, torch.ones(200, 200), proportion)
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - proportion)) < 0.02
    assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - proportion)))
    y2 = tc.dropout(torch.Generator().manual_seed(0), torch.ones(200, 200),
                    proportion)
    assert torch.equal(y, y2)


def test_fixed_affine_and_activations_match_jax():
    x, m, b = _x(2, 4, 9, 6), _x(3, 6, 5), _x(4, 5)
    _close(tc.fixed_affine(torch.from_numpy(x), torch.from_numpy(m)),
           jc.fixed_affine(x, m))
    _close(tc.fixed_affine(torch.from_numpy(x), torch.from_numpy(m),
                           torch.from_numpy(b)), jc.fixed_affine(x, m, b))
    for name in ("relu", "sigmoid", "tanh", "softsign"):
        _close(tc.ACTIVATIONS[name](torch.from_numpy(x)),
               jc.ACTIVATIONS[name](jnp.asarray(x)))


@pytest.mark.parametrize("n", [1, 5, 13, 23])
def test_dct_matrix_exact(n):
    np.testing.assert_array_equal(tx.dct_matrix(n), jx.dct_matrix(n))


@pytest.mark.parametrize("dct_dim,keep,reorder", [
    (6, 0, False), (6, 4, False), (4, 3, True), (12, 0, True)])
def test_dct_component_matches_jax(dct_dim, keep, reorder):
    x = _x(5, 3, 8, 24)
    _close(tx.dct_component(torch.from_numpy(x), dct_dim, keep, reorder),
           jx.dct_component(jnp.asarray(x), dct_dim, keep, reorder))


@pytest.mark.parametrize("nb", [1, 3, 4])
def test_block_affine_matches_jax(nb):
    params = jax.tree_util.tree_map(np.asarray, jx.block_affine_init(
        jax.random.PRNGKey(nb), 12, 24, nb))
    params["b"] = _x(6, 24)
    x = _x(7, 2, 5, 12)
    _close(tx.block_affine_apply({k: torch.from_numpy(v)
                                  for k, v in params.items()},
                                 torch.from_numpy(x)),
           jx.block_affine_apply(params, jnp.asarray(x)))
    ours = tx.block_affine_init(torch.Generator().manual_seed(0), 12, 24, nb)
    assert ours["w"].shape == params["w"].shape
    assert ours["b"].shape == (24,) and not ours["b"].any()


def test_additive_noise_with_jax_draw_matches_jax():
    x = _x(8, 4, 10, 6)
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    want = jx.additive_noise(key, jnp.asarray(x), 0.3)
    _close(tx.add_noise(torch.from_numpy(x), torch.from_numpy(noise), 0.3),
           want)
    g = torch.Generator().manual_seed(1)
    y = tx.additive_noise(g, torch.zeros(100, 100), 0.3)
    assert abs(float(y.std()) - 0.3) < 0.01
    assert torch.equal(y, tx.additive_noise(torch.Generator().manual_seed(1),
                                            torch.zeros(100, 100), 0.3))
