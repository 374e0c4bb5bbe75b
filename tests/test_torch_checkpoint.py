"""Port parity: kaldi_tpu_torch.utils.checkpoint against
kaldi_tpu.utils.checkpoint, in one on-disk format.

A round trip through the port, pruning to `keep`, and cross-reading both
ways: a JAX-written checkpoint loads into the port (names mapped from
keystr), and a port-written one loads in JAX with `like=`. Arrays round
trip bit for bit, bf16 through f32.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_tpu.utils import checkpoint as jck
from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
from kaldi_tpu_torch.params import (keystr_to_name, name_to_keystr,
                                    params_to_jax, random_tdnn_params,
                                    tdnn_params_from_jax)
from kaldi_tpu_torch.utils import checkpoint as tck

CFG = TdnnConfig(feat_dim=6, num_pdfs=5, hidden_dim=8, nonlinearity="relu",
                 splice_indexes=((-1, 0, 1), (0,)))


def _params(seed=0):
    return tdnn_params_from_jax(random_tdnn_params(CFG,
                                                   np.random.default_rng(seed)))


def test_names_map_to_keystr_and_back():
    tree = params_to_jax(_params())
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(tree)]
    assert sorted(name_to_keystr(n) for n in _params()) == sorted(paths)
    for n in _params():
        assert keystr_to_name(name_to_keystr(n)) == n
    assert name_to_keystr("layers.0.w") == "['layers'][0]['w']"
    with pytest.raises(ValueError):
        keystr_to_name("layers.0")


def test_round_trip_and_pruning(tmp_path):
    d = str(tmp_path / "ck")
    params = _params()
    params["final.b"] = params["final.b"].to(torch.bfloat16)
    for step in (10, 20, 30, 40):
        out = tck.save_checkpoint(d, step, params, keep=2,
                                  extra={"lr": 0.1 * step,
                                         "loss": torch.tensor(1.5)})
    assert out.endswith("step_0000000040")
    assert tck.list_checkpoints(d) == [30, 40]
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_")]
    step, flat, extra = tck.load_checkpoint(d)
    assert step == 40 and extra["lr"] == pytest.approx(4.0)
    assert extra["loss"] == "tensor(1.5000)"        # default=str
    assert sorted(flat) == sorted(params)
    assert flat["final.b"].dtype == torch.float32   # stored as f32
    step, like, _ = tck.load_checkpoint(d, step=30, like=params)
    assert step == 30
    for k in params:
        assert like[k].dtype == params[k].dtype
        assert torch.equal(like[k], params[k])
    with open(os.path.join(d, "step_0000000030", "meta.json")) as f:
        meta = json.load(f)
    assert meta["keys"] == sorted(name_to_keystr(k) for k in params)
    with pytest.raises(FileNotFoundError):
        tck.load_checkpoint(str(tmp_path / "none"))


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    d = str(tmp_path / "j")
    tree = jax.tree.map(jnp.asarray, random_tdnn_params(
        CFG, np.random.default_rng(1)))
    jck.save_checkpoint(d, 7, tree, extra={"epoch": 2})
    step, flat, extra = tck.load_checkpoint(d, like=_params())
    assert step == 7 and extra == {"epoch": 2}
    want = tdnn_params_from_jax(jax.tree.map(np.asarray, tree))
    assert list(flat) == list(_params())
    for k in want:
        assert torch.equal(flat[k], want[k])


def test_port_checkpoint_loads_in_jax(tmp_path):
    d = str(tmp_path / "t")
    params = _params(2)
    tck.save_checkpoint(d, 3, params, extra={"note": "port"})
    like = jax.tree.map(jnp.asarray, params_to_jax(_params(0)))
    step, tree, extra = jck.load_checkpoint(d, like=like)
    assert step == 3 and extra == {"note": "port"}
    got = tdnn_params_from_jax(jax.tree.map(np.asarray, tree))
    for k in params:
        assert torch.equal(got[k], params[k])
    step, flat, _ = jck.load_checkpoint(d)
    assert sorted(flat) == sorted(name_to_keystr(k) for k in params)


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(v.shape)
                                .astype(np.float32))
            for k, v in _params().items()}


def _port_state(name, steps=2):
    from kaldi_tpu_torch.nnet import optim
    tx = {"sgd_momentum": lambda: optim.sgd(0.1, momentum=0.9),
          "adam": lambda: optim.adam(1e-2),
          "sgd_schedule": lambda: optim.sgd(
              optim.exponential_decay(0.1, 5, 0.5), momentum=0.9)}[name]()
    state = tx.init(_params())
    for i in range(steps):
        _, state = tx.update(_grads(i), state, _params())
    return state


def _optax_state(name, steps=2):
    import optax
    tx = {"sgd_momentum": lambda: optax.sgd(0.1, momentum=0.9),
          "adam": lambda: optax.adam(1e-2),
          "sgd_schedule": lambda: optax.sgd(
              optax.exponential_decay(0.1, 5, 0.5), momentum=0.9)}[name]()
    tree = jax.tree.map(jnp.asarray, params_to_jax(_params()))
    state = tx.init(tree)
    for i in range(steps):
        g = jax.tree.map(jnp.asarray, params_to_jax(_grads(i)))
        _, state = tx.update(g, state, tree)
    return state


def _paths(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


OPT_STATES = ["sgd_momentum", "adam", "sgd_schedule"]


@pytest.mark.parametrize("name", OPT_STATES)
def test_optimizer_state_round_trips_in_the_port(tmp_path, name):
    """A momentum or Adam state (tuples and NamedTuples over dicts, with
    host-int counts) saves and loads back equal with `like`."""
    state = _port_state(name)
    tck.save_checkpoint(str(tmp_path), 5, state)
    _step, got, _ = tck.load_checkpoint(str(tmp_path), like=_port_state(name, 0))
    assert type(got) is type(state)
    flat_got, flat_want = tck._flatten(got), tck._flatten(state)
    assert sorted(flat_got) == sorted(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k])
    assert isinstance(got[0], type(state[0]))


@pytest.mark.parametrize("name", OPT_STATES)
def test_optimizer_state_paths_are_optax_paths(name):
    assert sorted(tck._flatten(_port_state(name))) == \
        sorted(_paths(_optax_state(name)))


@pytest.mark.parametrize("name", OPT_STATES)
def test_optax_state_checkpoint_loads_into_the_port(tmp_path, name):
    d = str(tmp_path / "j")
    want = _optax_state(name)
    jck.save_checkpoint(d, 9, want)
    _step, got, _ = tck.load_checkpoint(d, like=_port_state(name, 0))
    flat = tck._flatten(got)
    for k, v in _paths(want).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    # and the port continues from it as optax does
    np.testing.assert_allclose(
        tck._flatten(_port_state(name))["[0]" + (".mu['final']['w']"
                                                if name == "adam" else
                                                ".trace['final']['w']")],
        flat["[0]" + (".mu['final']['w']" if name == "adam"
                      else ".trace['final']['w']")], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", OPT_STATES)
def test_port_state_checkpoint_loads_in_jax(tmp_path, name):
    d = str(tmp_path / "t")
    state = _port_state(name)
    tck.save_checkpoint(d, 4, state)
    _step, got, _ = jck.load_checkpoint(d, like=_optax_state(name, 0))
    want = tck._flatten(state)
    for k, v in _paths(got).items():
        np.testing.assert_array_equal(v, want[k].astype(v.dtype), err_msg=k)
