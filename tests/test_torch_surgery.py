"""Port parity: kaldi_tpu_torch.nnet.surgery and the rest of combine.py
against kaldi_tpu.

Both sides get the same numpy params. jax.random draws cannot be
reproduced, so `widen` is held to JAX exactly at new_unit_stddev_scale=0
and by function preservation at a nonzero scale, and `replace_last_layers`
draws nothing (zero weights). Tolerances: 1e-6 of a leaf's max |p| where
the arithmetic is the same elementwise scaling (widen, fix,
average_params); 1e-5 where an SVD or a forward pass sums in another
order (limit_rank, the forward passes); `combine_params` runs 50 Adam
steps through a forward pass, held at 1e-4; `shrink` is held by what it
can identify (its test says why), not by the index of its best step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from kaldi_tpu.nnet import combine as jcombine, surgery as jsurgery
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu_torch.nnet import combine as tcombine, optim
from kaldi_tpu_torch.nnet import surgery as tsurgery
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.params import (params_to_jax, random_tdnn_params,
                                    tdnn_params_from_jax)

torch.set_num_threads(2)

CFG = dict(feat_dim=5, num_pdfs=7, splice_indexes=((-1, 0, 1), (-1, 1), (0,)),
           hidden_dim=16, nonlinearity="relu")


def _net(seed=0):
    tree = random_tdnn_params(TdnnConfig(**CFG), np.random.default_rng(seed))
    return TdnnConfig(**CFG), tree


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(jtree):
    return tdnn_params_from_jax(jax.tree.map(np.asarray, jtree))


def _assert_close(tparams, jtree, rel):
    want = _flat(jtree)
    assert sorted(tparams) == sorted(want)
    for k, v in tparams.items():
        assert v.shape == want[k].shape, k
        err = float((v.detach().cpu() - want[k]).abs().max())
        assert err <= rel * max(float(want[k].abs().max()), 1e-30), (k, err)


def _feats(seed=1, B=2, T=12):
    return np.random.default_rng(seed).standard_normal(
        (B, T, CFG["feat_dim"])).astype(np.float32)


def _apply(cfg, params, x, pad_context=True):
    model = Tdnn(cfg)
    return torch.func.functional_call(model, params, (x,),
                                      {"pad_context": pad_context})


def test_widen_at_zero_scale_equals_jax():
    cfg, tree = _net()
    want = jsurgery.widen(_j(tree), JTdnnConfig(**CFG), 24,
                          jax.random.PRNGKey(2), new_unit_stddev_scale=0.0)
    got = tsurgery.widen(tdnn_params_from_jax(tree), cfg, 24,
                         torch.Generator().manual_seed(2),
                         new_unit_stddev_scale=0.0)
    _assert_close(got, want, 1e-6)


def test_widen_preserves_function_and_rejects_pnorm():
    cfg, tree = _net()
    params = tdnn_params_from_jax(tree)
    x = torch.from_numpy(_feats())
    wide = tsurgery.widen(params, cfg, 24, torch.Generator().manual_seed(2))
    assert wide["layers.0.w"].shape == (15, 24)
    assert wide["layers.1.w"].shape == (48, 24)        # 2 splice offsets
    assert float(wide["layers.0.w"][:, 16:].abs().max()) > 0
    cfg2 = TdnnConfig(**{**CFG, "hidden_dim": 24})
    torch.testing.assert_close(_apply(cfg2, wide, x), _apply(cfg, params, x),
                               atol=2e-5, rtol=0)
    pcfg = TdnnConfig(**{**CFG, "nonlinearity": "pnorm",
                         "pnorm_output_dim": 4})
    with pytest.raises(ValueError):
        tsurgery.widen(params, pcfg, 32)


@pytest.mark.parametrize("rank", [3, 10_000])
def test_limit_rank_equals_jax(rank):
    cfg, tree = _net()
    want, wf = jsurgery.limit_rank(_j(tree), rank=rank)
    got, tf = tsurgery.limit_rank(tdnn_params_from_jax(tree), rank=rank)
    _assert_close(got, want, 1e-5)
    assert sorted(tf) == sorted(wf)
    for i in wf:
        for a, b in zip(tf[i], wf[i]):
            np.testing.assert_allclose(np.abs(a), np.abs(b), atol=1e-5)


def test_fix_equals_jax():
    cfg, tree = _net()
    tree["layers"][0]["w"][:, 0] *= 1e-6       # a dead unit
    tree["layers"][0]["b"][0] = 0.0
    tree["layers"][1]["w"][:, 3] *= 8.0        # a saturated one
    x = _feats(B=4, T=20)
    jm = JTdnn(JTdnnConfig(**CFG))
    want = jsurgery.fix(_j(tree), JTdnnConfig(**CFG), jm.hidden_mean_abs,
                        jnp.asarray(x), parameter_factor=4.0)

    def stats(p, f):
        model = Tdnn(cfg)
        model.load_state_dict(p)
        return model.hidden_mean_abs(f)

    got = tsurgery.fix(tdnn_params_from_jax(tree), cfg, stats,
                       torch.from_numpy(x), parameter_factor=4.0)
    _assert_close(got, want, 1e-6)
    ratio = (got["layers.0.w"][:, 0] / tdnn_params_from_jax(tree)
             ["layers.0.w"][:, 0])
    torch.testing.assert_close(ratio, torch.full_like(ratio, 4.0))


def test_shrink_equals_jax():
    """A hidden layer's scale is not identifiable: RMS normalize after a
    relu (or a p-norm) cancels any positive scale, so its gradient is zero
    up to rounding and Adam walks it by the rounding noise's sign, in JAX
    as here. Held: the final layer's chosen scale within 1e-4, and the
    shrunk nets' log-posteriors and loss within 1e-5."""
    cfg, tree = _net()
    big = jax.tree.map(lambda p: p * 3.0, tree)
    x = _feats(seed=3, B=3, T=15)
    labels = np.random.default_rng(4).integers(0, 7, (3, 15))
    jm = JTdnn(JTdnnConfig(**CFG))
    want = _flat(jsurgery.shrink(jm.apply, _j(big), jnp.asarray(x),
                                 jnp.asarray(labels), num_steps=40))
    tbig = tdnn_params_from_jax(big)
    got = tsurgery.shrink(lambda p, f: _apply(cfg, p, f), tbig,
                          torch.from_numpy(x), labels, num_steps=40)
    torch.testing.assert_close(got["final.w"], want["final.w"], rtol=1e-4,
                               atol=0)
    xt = torch.from_numpy(x)
    lp_got, lp_want = _apply(cfg, got, xt), _apply(cfg, want, xt)
    torch.testing.assert_close(lp_got, lp_want, rtol=1e-5, atol=1e-5)

    def loss(lp):
        return float(-torch.gather(lp, -1, torch.from_numpy(labels)[..., None])
                     .mean())
    assert loss(lp_got) == pytest.approx(loss(lp_want), rel=1e-5)
    assert loss(lp_got) <= loss(_apply(cfg, tbig, xt)) + 1e-6


def test_replace_last_layers_and_layerwise_optimizer_equal_jax():
    cfg, tree = _net()
    params = tdnn_params_from_jax(tree)
    out = tsurgery.replace_last_layers(params, cfg, 11)
    assert out["final.w"].shape == (16, 11) and out["final.b"].shape == (11,)
    assert float(out["final.w"].abs().max()) == 0.0
    assert float(out["final.b"].abs().max()) == 0.0
    assert out["layers.0.w"] is params["layers.0.w"]
    want = jsurgery.replace_last_layers(_j(tree), JTdnnConfig(**CFG), 11,
                                        jax.random.PRNGKey(3))
    _assert_close(out, want, 0.0)

    labels = tsurgery.layerwise_lr_labels(params)
    jlabels = jsurgery.layerwise_lr_labels(_j(tree))
    assert params_to_jax({k: torch.zeros(()) for k in labels}).keys() \
        == jlabels.keys()
    for k, lab in labels.items():
        parts = k.split(".")
        node = jlabels[parts[0]]
        for p in parts[1:]:
            node = node[int(p)] if p.isdigit() else node[p]
        assert node == lab, k

    scales = {"final": 0.0, "layer0": 1.0, "layer2": 0.25}
    ttx = tsurgery.layerwise_optimizer(params, 0.1, scales)
    jtx = jsurgery.layerwise_optimizer(_j(tree), 0.1, scales)
    ts, js = ttx.init(params), jtx.init(_j(tree))
    jp = _j(tree)
    rng = np.random.default_rng(5)
    for _ in range(3):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                         .astype(np.float32), tree)
        tu, ts = ttx.update(tdnn_params_from_jax(g), ts, params)
        ju, js = jtx.update(_j(g), js, jp)
        _assert_close(tu, ju, 1e-6)
        params = optim.apply_updates(params, tu)
        jp = optax.apply_updates(jp, ju)
    assert float(tu["final.w"].abs().max()) == 0.0
    assert float(tu["layers.0.w"].abs().max()) > 0.0


def test_average_params_equals_jax():
    trees = [_net(s)[1] for s in range(3)]
    got = tcombine.average_params([tdnn_params_from_jax(t) for t in trees])
    want = jcombine.average_params([_j(t) for t in trees])
    _assert_close(got, want, 1e-6)


def test_combine_params_equals_jax():
    """Three models of the small TDNN: the weight logits are fitted per
    (model, leaf) on a validation loss. The port's leaves come in its own
    order ("layers.0.w" first), JAX's in tree_flatten order ("final"
    first): each column of the [N, L] weights must map to its leaf."""
    cfg = TdnnConfig(**CFG)
    trees = [_net(s)[1] for s in range(3)]
    trees[1] = jax.tree.map(lambda p: p * 0.2, trees[1])   # a weak model
    x = _feats(seed=6, B=2, T=10)
    labels = np.random.default_rng(7).integers(0, 7, (2, 10))
    jm = JTdnn(JTdnnConfig(**CFG))

    def jloss(p):
        lp = jm.apply(p, jnp.asarray(x))
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(labels)[..., None],
                                             axis=-1))

    def tloss(p):
        lp = _apply(cfg, p, torch.from_numpy(x))
        return -torch.mean(torch.gather(
            lp, -1, torch.from_numpy(labels)[..., None]))

    want, wl = jcombine.combine_params([_j(t) for t in trees], jloss)
    got, gl = tcombine.combine_params([tdnn_params_from_jax(t) for t in trees],
                                      tloss)
    assert gl == pytest.approx(wl, rel=1e-4)
    _assert_close(got, want, 1e-4)
    avg = tcombine.average_params([tdnn_params_from_jax(t) for t in trees])
    assert gl < float(tloss(avg))


def test_mixup_softmax_layer_equals_jax():
    rng = np.random.RandomState(1)
    w, b = rng.randn(3, 5), rng.randn(3)
    for n, perturb in ((6, 0.0), (7, 0.01), (2, 0.01)):
        got = tcombine.mixup_softmax_layer(w, b, n, perturb=perturb, seed=3)
        want = jcombine.mixup_softmax_layer(w, b, n, perturb=perturb, seed=3)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
