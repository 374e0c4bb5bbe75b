"""Port parity: kaldi_tpu_torch TDNN and its components against kaldi_tpu.

Both sides get the same numpy weights (the frameworks' RNGs differ, so
nothing is re-initialised). f32 tolerance 1e-5: the same products summed in
another order. The bf16 path rounds its products in both frameworks, in
places that may differ, so it is held at the decision level (argmax of the
log-posteriors on >= 99% of frames), as test_bf16_parity.py holds the JAX
bf16 path at the WER level.
"""

import numpy as np
import pytest
import torch

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
