"""Port parity: kaldi_tpu_torch TDNN and its components against kaldi_tpu.

Both sides get the same numpy weights (the frameworks' RNGs differ, so
nothing is re-initialised). f32 tolerance 1e-5: the same products summed in
another order. The bf16 path rounds its products in both frameworks, in
places that may differ, so it is held at the decision level (argmax of the
log-posteriors on >= 99% of frames), as test_bf16_parity.py holds the JAX
bf16 path at the WER level.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_tpu.nnet import components as jc
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu_torch.nnet import components as tc
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.params import (random_tdnn_params, tdnn_params_from_jax,
                                    tdnn_params_to_jax)

torch.set_num_threads(2)

CONFIGS = {
    "relu": dict(feat_dim=12, num_pdfs=24, hidden_dim=32,
                 pnorm_output_dim=8, nonlinearity="relu"),
    "pnorm": dict(feat_dim=12, num_pdfs=24, hidden_dim=32,
                  pnorm_output_dim=8, nonlinearity="pnorm"),
}


def _feats(seed=0, B=2, T=40, D=12):
    return np.random.default_rng(seed).standard_normal((B, T, D)) \
        .astype(np.float32)


def _models(name):
    params = random_tdnn_params(TdnnConfig(**CONFIGS[name]),
                                np.random.default_rng(1))
    jm = JTdnn(JTdnnConfig(**CONFIGS[name]))
    tm = Tdnn(TdnnConfig(**CONFIGS[name])).load_jax_params(params)
    jparams = {"layers": [{k: jnp.asarray(v) for k, v in l.items()}
                          for l in params["layers"]],
               "final": {k: jnp.asarray(v) for k, v in params["final"].items()}}
    return jm, jparams, tm


@pytest.mark.parametrize("ctx", [(-2, -1, 0, 1, 2), (-7, 2), (0,), (-3, 3)])
def test_splice_matches_jax(ctx):
    x = _feats()
    np.testing.assert_allclose(tc.splice(torch.from_numpy(x), ctx).numpy(),
                               np.asarray(jc.splice(jnp.asarray(x), ctx)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tc.splice_valid(torch.from_numpy(x), ctx).numpy(),
        np.asarray(jc.splice_valid(jnp.asarray(x), ctx)), atol=1e-6, rtol=0)


def test_pnorm_normalize_relu_match_jax():
    x = _feats(D=32) * 3
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for p in (2.0, 3.0):
        np.testing.assert_allclose(tc.pnorm(xt, 8, p).numpy(),
                                   np.asarray(jc.pnorm(xj, 8, p)),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tc.normalize(xt).numpy(),
                               np.asarray(jc.normalize(xj)),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(tc.ACTIVATIONS["relu"](xt).numpy(),
                                  np.asarray(jc.ACTIVATIONS["relu"](xj)))


@pytest.mark.parametrize("name", ["relu", "pnorm"])
@pytest.mark.parametrize("pad_context", [True, False])
def test_tdnn_f32_matches_jax(name, pad_context):
    jm, jparams, tm = _models(name)
    x = _feats()
    want = np.asarray(jm.apply(jparams, jnp.asarray(x),
                               pad_context=pad_context))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), pad_context=pad_context).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["relu", "pnorm"])
def test_tdnn_bf16_decisions_match_jax(name):
    jm, jparams, tm = _models(name)
    x = _feats(seed=3, B=2, T=120)
    want = np.asarray(jm.apply(jparams, jnp.asarray(x), pad_context=True,
                               compute_dtype=jnp.bfloat16))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), pad_context=True,
                 compute_dtype=torch.bfloat16).numpy()
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    max_abs = float(np.abs(got - want).max())
    assert agree >= 0.99, (agree, max_abs)
    # bf16 keeps ~3 significant digits; the log-posteriors stay close
    assert max_abs < 0.25, max_abs


def test_param_converter_round_trip():
    cfg = TdnnConfig(**CONFIGS["pnorm"])
    params = random_tdnn_params(cfg, np.random.default_rng(2))
    sd = tdnn_params_from_jax(params)
    assert sd["layers.0.w"].shape == params["layers"][0]["w"].shape  # [in, out]
    back = tdnn_params_to_jax(Tdnn(cfg).load_jax_params(params))
    for a, b in zip(back["layers"] + [back["final"]],
                    params["layers"] + [params["final"]]):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])
    # the JAX init's own tree converts too (leaf shapes agree)
    import jax
    jtree = JTdnn(JTdnnConfig(**CONFIGS["pnorm"])).init(jax.random.PRNGKey(0))
    Tdnn(cfg).load_jax_params(jax.tree_util.tree_map(np.asarray, jtree))


@pytest.mark.parametrize("name", ["relu", "pnorm"])
@pytest.mark.parametrize("num_layers", [1, 3])
def test_num_layers_matches_jax(name, num_layers):
    """The first k hidden layers under the final affine, f32 within 1e-5
    and bf16 at its decision level, as the full net."""
    jm, jparams, tm = _models(name)
    x = _feats(seed=4, B=2, T=60)
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jm.apply(jparams, jnp.asarray(x), pad_context=False,
                                   compute_dtype=jdt, num_layers=num_layers))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), pad_context=False, compute_dtype=tdt,
                     num_layers=num_layers).numpy()
        assert got.shape == want.shape
        if tdt is None:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.99


@pytest.mark.parametrize("name", ["relu", "pnorm"])
def test_apply_logits_and_hidden_mean_abs_match_jax(name):
    jm, jparams, tm = _models(name)
    x = _feats(seed=5)
    for pad in (True, False):
        want = np.asarray(jm.apply_logits(jparams, jnp.asarray(x),
                                          pad_context=pad))
        got = tm.apply_logits(torch.from_numpy(x), pad_context=pad).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        wstats = jm.hidden_mean_abs(jparams, jnp.asarray(x), pad_context=pad)
        tstats = tm.hidden_mean_abs(torch.from_numpy(x), pad_context=pad)
        assert len(tstats) == len(wstats) == 5
        for g, w in zip(tstats, wstats):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)


def test_init_context_of_and_num_params():
    """The port draws with torch, so init is held by its stddevs: hidden
    weights 1/sqrt(in), biases 1, the final affine all zeros."""
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64, hidden_dim=256,
                     pnorm_output_dim=32)
    tm = Tdnn(cfg)
    params = tm.init(torch.Generator().manual_seed(0))
    assert list(params) == list(tm.state_dict())
    for i, ctx in enumerate(cfg.splice_indexes):
        w, b = params[f"layers.{i}.w"], params[f"layers.{i}.b"]
        assert float(w.std()) == pytest.approx(1 / np.sqrt(w.shape[0]),
                                               rel=0.05)
        assert float(b.std()) == pytest.approx(1.0, rel=0.25)
    assert float(params["final.w"].abs().max()) == 0.0
    assert float(params["final.b"].abs().max()) == 0.0
    assert torch.equal(tm.layers[0].w, params["layers.0.w"])
    assert not any(p.requires_grad for p in tm.parameters())
    again = Tdnn(cfg).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], params[k]) for k in params)
    jm = JTdnn(JTdnnConfig(**dataclasses.asdict(cfg)))
    jtree = jm.init(jax.random.PRNGKey(0))
    assert tm.num_params() == tm.num_params(params) == jm.num_params(jtree)
    for k in range(1, 6):
        assert tm.context_of(k) == jm.context_of(k)
    assert tm.context_of(5) == (cfg.left_context, cfg.right_context)
