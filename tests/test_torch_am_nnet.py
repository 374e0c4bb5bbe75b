"""Port parity: kaldi_tpu_torch's AmNnet and group log-sum-exp against
kaldi_tpu's, on the same numpy weights, priors and features. Tolerance
1e-5: the same f32 products summed in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.nnet.am_nnet import AmNnet as JAmNnet
from kaldi_tpu.nnet.combine import (sum_group_log_posteriors as
                                    j_sum_group_log_posteriors)
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.nnet.combine import sum_group_log_posteriors
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.params import random_tdnn_params

torch.set_num_threads(2)

TDNN = dict(feat_dim=12, num_pdfs=24, hidden_dim=32, pnorm_output_dim=8,
            nonlinearity="pnorm")
TOL = dict(atol=1e-5, rtol=1e-5)


def _jparams(params):
    return {"layers": [{k: jnp.asarray(v) for k, v in l.items()}
                       for l in params["layers"]],
            "final": {k: jnp.asarray(v) for k, v in params["final"].items()}}


def _pair(seed=0, **kw):
    params = random_tdnn_params(TdnnConfig(**TDNN), np.random.default_rng(seed))
    jam = JAmNnet(JTdnn(JTdnnConfig(**TDNN)), _jparams(params), **kw)
    am = AmNnet(Tdnn(TdnnConfig(**TDNN)).load_jax_params(params), **kw)
    return jam, am


def _feats(seed, B=2, T=30):
    return np.random.default_rng(seed).standard_normal((B, T, 12)) \
        .astype(np.float32)


def test_loglikes_match_jax():
    priors = np.random.default_rng(1).dirichlet(np.ones(24))
    priors[3] = 0.0                          # floored at 1e-20
    jam, am = _pair(priors=priors)
    x = _feats(2)
    np.testing.assert_allclose(am.loglikes(x).numpy(),
                               np.asarray(jam.loglikes(x)), **TOL)
    np.testing.assert_allclose(am.loglikes_np(x, scale=0.1),
                               jam.loglikes_np(x, scale=0.1), **TOL)
    assert am.num_pdfs == jam.num_pdfs == 24


@pytest.mark.parametrize("pad_context", [True, False])
def test_log_posteriors_with_group_ids_match_jax(pad_context):
    gid = np.repeat(np.arange(8), 3)        # 24 mixture rows -> 8 pdfs
    gid[[0, 5]] = gid[[5, 0]]
    jam, am = _pair(group_ids=gid)
    x = _feats(3)
    got = am.log_posteriors(x, pad_context=pad_context).numpy()
    want = np.asarray(jam.log_posteriors(x, pad_context=pad_context))
    assert got.shape[-1] == am.num_pdfs == jam.num_pdfs == 8
    np.testing.assert_allclose(got, want, **TOL)


def test_sum_group_log_posteriors_empty_group():
    lp = np.log(np.random.default_rng(4).dirichlet(np.ones(6), size=(3, 5))) \
        .astype(np.float32)
    gid = np.array([0, 0, 2, 2, 2, 3])      # group 1 is empty
    got = sum_group_log_posteriors(torch.from_numpy(lp), gid, 4).numpy()
    want = np.asarray(j_sum_group_log_posteriors(jnp.asarray(lp), gid, 4))
    assert np.isneginf(got[..., 1]).all() and np.isneginf(want[..., 1]).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_priors_from_posteriors_match_jax():
    jam, am = _pair()
    batches = [_feats(5), _feats(6, B=1, T=17)]
    jam.set_priors_from_posteriors(batches)
    am.set_priors_from_posteriors(batches)
    assert am.priors.dtype == jam.priors.dtype == np.float64
    np.testing.assert_allclose(am.priors, jam.priors, **TOL)


def test_priors_from_alignment_counts_match_jax():
    jam, am = _pair()
    counts = np.random.default_rng(7).integers(0, 50, 24)
    jam.set_priors_from_alignment_counts(counts)
    am.set_priors_from_alignment_counts(counts)
    np.testing.assert_array_equal(am.priors, jam.priors)


def test_replace_params_matches_jax():
    priors = np.random.default_rng(8).dirichlet(np.ones(24))
    jam, am = _pair(priors=priors, lr_scales={"final": 0.5})
    am.meta["k"] = 1
    new = random_tdnn_params(TdnnConfig(**TDNN), np.random.default_rng(9))
    jam2, am2 = jam.replace_params(_jparams(new)), am.replace_params(new)
    assert am2.model is not am.model and am2.meta == {} and \
        am2.lr_scales == {"final": 0.5}
    x = _feats(10)
    np.testing.assert_allclose(am2.loglikes(x).numpy(),
                               np.asarray(jam2.loglikes(x)), **TOL)
    # the original keeps its weights
    np.testing.assert_allclose(am.loglikes(x).numpy(),
                               np.asarray(jam.loglikes(x)), **TOL)


RELU = TdnnConfig(feat_dim=12, num_pdfs=10, hidden_dim=8,
                  nonlinearity="relu",
                  splice_indexes=((-1, 0, 1), (-2, 2), (0,)))


def _surgery(kind: str, params: dict):
    """JAX surgery on a numpy params tree -> (new tree, group_ids)."""
    import jax
    from kaldi_tpu.nnet import surgery as jsurgery
    from kaldi_tpu.nnet.combine import mixup_softmax_layer as jmixup
    jcfg = JTdnnConfig(**{f: getattr(RELU, f) for f in (
        "feat_dim", "num_pdfs", "hidden_dim", "nonlinearity",
        "splice_indexes")})
    key = jax.random.PRNGKey(3)
    if kind == "widen":
        new = jsurgery.widen(_jparams(params), jcfg, 12, key,
                             new_unit_stddev_scale=0.5)
        return jax.tree.map(np.asarray, new), None
    if kind == "replace_last_layers":
        new = jsurgery.replace_last_layers(_jparams(params), jcfg, 7, key)
        new = jax.tree.map(np.asarray, new)
        rng = np.random.default_rng(4)         # a trained-looking output
        new["final"] = {"w": rng.standard_normal(new["final"]["w"].shape)
                        .astype(np.float32),
                        "b": rng.standard_normal(7).astype(np.float32)}
        return new, None
    w, b, gid = jmixup(params["final"]["w"].T, params["final"]["b"], 25,
                       perturb=0.3, seed=2)
    return ({"layers": params["layers"],
             "final": {"w": w.T.astype(np.float32),
                       "b": b.astype(np.float32)}}, gid)


@pytest.mark.parametrize("form", ["jax_tree", "port_dict"])
@pytest.mark.parametrize("kind", ["widen", "replace_last_layers", "mixup"])
def test_replace_params_of_another_shape_matches_jax(kind, form):
    """After surgery the params' widths differ from the model's: JAX's
    replace_params reads them from the params, and so must the port's."""
    from kaldi_tpu_torch.params import tdnn_params_from_jax
    params = random_tdnn_params(RELU, np.random.default_rng(11))
    new, gid = _surgery(kind, params)
    jcfg = JTdnnConfig(**{f: getattr(RELU, f) for f in (
        "feat_dim", "num_pdfs", "hidden_dim", "nonlinearity",
        "splice_indexes")})
    jam = JAmNnet(JTdnn(jcfg), _jparams(params), group_ids=gid)
    am = AmNnet(Tdnn(RELU).load_jax_params(params), group_ids=gid)
    jam2 = jam.replace_params(_jparams(new))
    am2 = am.replace_params(new if form == "jax_tree"
                            else tdnn_params_from_jax(new))
    if kind == "replace_last_layers":            # a new pdf inventory
        for a in (jam2, am2):
            a.set_priors_from_alignment_counts(np.arange(7))
    x = _feats(12)
    got, want = am2.loglikes(x).numpy(), np.asarray(jam2.loglikes(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    # the original keeps its model (a mixed-up AM's group_ids need the
    # mixed-up output layer, so its original is not a model to score)
    if kind != "mixup":
        np.testing.assert_allclose(am.loglikes(x).numpy(),
                                   np.asarray(jam.loglikes(x)), **TOL)
