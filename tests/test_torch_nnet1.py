"""Port parity: the nnet1 family (kaldi_tpu_torch.nnet1) against
kaldi_tpu.nnet1 on the CPU, at small widths.

- The proto: parse and `to_proto` equal JAX's; `Nnet1.apply` over every
  component kind with JAX's params carried across
  (`params.nnet1_params_from_jax`) within 1e-5 relative; `save_nnet1`
  files of each package load in the other, equal to the bit.
- `train_frmshuff` (2 epochs, momentum) and `train_lstm_streams` (2
  epochs, 3 streams with resets, clipping) from the same params: params
  and history within 1e-5 (the frame shuffles are JAX's numpy ones).
- The projected LSTM and BLSTM forwards with JAX's params
  (`params.lstm_params_from_jax`), and the chunked state carry, within
  1e-5; `LstmProjected.init` has JAX's layout.
- RBM: the same numpy init; `cd1_update` given JAX's hidden sample (its
  uniform draw from the same key, against its own P(h|v)): W, biases and
  velocities within 1e-6 over three steps, bernoulli and gaussian hidden
  units; `params.rbm_from_jax` carries a stepped RBM.
- conv1d (`F.conv1d`) and max pooling, and KL-HMM scores.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.nnet1 import conv as jconv
from kaldi_tpu.nnet1 import kl_hmm as jkl
from kaldi_tpu.nnet1 import lstm as jlstm
from kaldi_tpu.nnet1 import nnet as jnnet
from kaldi_tpu.nnet1 import rbm as jrbm
from kaldi_tpu.nnet1 import train as jtrain
from kaldi_tpu_torch.nnet1 import conv as tconv
from kaldi_tpu_torch.nnet1 import kl_hmm as tkl
from kaldi_tpu_torch.nnet1 import lstm as tlstm
from kaldi_tpu_torch.nnet1 import nnet as tnnet
from kaldi_tpu_torch.nnet1 import rbm as trbm
from kaldi_tpu_torch.nnet1 import train as ttrain
from kaldi_tpu_torch.params import (lstm_params_from_jax,
                                    nnet1_params_from_jax, rbm_from_jax)

torch.set_num_threads(2)

PROTO = """<NnetProto>
<Splice> <InputDim> 3 <OutputDim> 9 <BuildVector> -1:0:2
<AddShift> <InputDim> 9 <OutputDim> 9
<Rescale> <InputDim> 9 <OutputDim> 9
<AffineTransform> <InputDim> 9 <OutputDim> 12
<Sigmoid> <InputDim> 12 <OutputDim> 12
<AffineTransform> <InputDim> 12 <OutputDim> 10
<Tanh> <InputDim> 10 <OutputDim> 10
<AffineTransform> <InputDim> 10 <OutputDim> 8
<ReLU> <InputDim> 8 <OutputDim> 8
<AffineTransform> <InputDim> 8 <OutputDim> 5
<Softmax> <InputDim> 5 <OutputDim> 5
</NnetProto>
"""


# a frame-level net for the frame-shuffled trainer (no splice)
FRAME_PROTO = """<AffineTransform> <InputDim> 3 <OutputDim> 12
<Sigmoid> <InputDim> 12 <OutputDim> 12
<AddShift> <InputDim> 12 <OutputDim> 12
<AffineTransform> <InputDim> 12 <OutputDim> 5
<Softmax> <InputDim> 5 <OutputDim> 5
"""


def _rel(got, want) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-30))


def _jnet(seed=0):
    """JAX's net with every param moved off its init (shifts and rescales
    included), and the port's net."""
    jn = jnnet.Nnet1.from_proto(PROTO)
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jn.init(jax.random.PRNGKey(seed), param_stddev=0.4)]
    rng = np.random.RandomState(seed)
    for p in params:
        for k in p:
            if k != "w":
                p[k] = (p[k] + 0.3 * rng.randn(*p[k].shape)) \
                    .astype(np.float32)
    return jn, params, tnnet.Nnet1.from_proto(PROTO, device="cpu")


def test_proto_round_trip_matches_jax():
    j, t = jnnet.parse_proto(PROTO), tnnet.parse_proto(PROTO)
    assert [dataclasses.astuple(c) for c in t] == \
        [dataclasses.astuple(c) for c in j]
    tn = tnnet.Nnet1(t, device="cpu")
    assert tn.to_proto() == jnnet.Nnet1(j).to_proto()
    assert tnnet.parse_proto(tn.to_proto()) == t
    assert (tn.input_dim, tn.output_dim) == (3, 5)
    assert len(tn.concat(tn).components) == 2 * len(t)
    with pytest.raises(ValueError, match="bad proto line"):
        tnnet.parse_proto("AffineTransform 3 4")


def test_apply_every_kind_matches_jax():
    jn, params, tn = _jnet()
    tp = nnet1_params_from_jax(params)
    assert set(tp) == {f"{i}.{k}" for i, p in enumerate(params) for k in p}
    x = np.random.RandomState(1).randn(2, 7, 3).astype(np.float32)
    want = np.asarray(jn.apply(params, jnp.asarray(x)))
    assert _rel(tn.apply(tp, torch.from_numpy(x)), want) <= 1e-5
    # the port's init: JAX's layout, affine stddev, zero shifts, unit scales
    ours = tn.init(torch.Generator().manual_seed(0), param_stddev=0.4)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert not ours["1.b"].any() and torch.all(ours["2.s"] == 1)
    with pytest.raises(ValueError, match="unknown component"):
        tnnet.Nnet1([tnnet.Component("Foo", 3, 3)], device="cpu").apply(
            {}, torch.zeros(1, 3))


def test_save_load_cross_packages(tmp_path):
    jn, params, tn = _jnet(1)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jnnet.save_nnet1(jpath, jn, params)
    net, tp = tnnet.load_nnet1(jpath, device="cpu")
    assert net.to_proto() == jn.to_proto()
    want = nnet1_params_from_jax(params)
    assert set(tp) == set(want)
    for k in want:
        torch.testing.assert_close(tp[k], want[k], rtol=0, atol=0)
    tnnet.save_nnet1(tpath, tn, want)
    jnet2, jp2 = jnnet.load_nnet1(tpath)
    assert jnet2.to_proto() == tn.to_proto()
    assert len(jp2) == len(params)
    for a, b in zip(jp2, params):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])


def test_train_frmshuff_matches_jax():
    jn = jnnet.Nnet1.from_proto(FRAME_PROTO)
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jn.init(jax.random.PRNGKey(2), param_stddev=0.4)]
    tn = tnnet.Nnet1.from_proto(jn.to_proto(), device="cpu")
    rng = np.random.RandomState(3)
    feats = rng.randn(70, 3).astype(np.float32)
    targets = rng.randint(0, 5, 70)
    jout, jhist = jnnet.train_frmshuff(jn, params, feats, targets,
                                       learn_rate=0.1, minibatch=16,
                                       num_epochs=2, momentum=0.5, seed=4)
    tout, thist = tnnet.train_frmshuff(tn, nnet1_params_from_jax(params),
                                       feats, targets, learn_rate=0.1,
                                       minibatch=16, num_epochs=2,
                                       momentum=0.5, seed=4)
    np.testing.assert_allclose(np.array(thist), np.array(jhist), rtol=1e-5)
    want = nnet1_params_from_jax(jax.tree_util.tree_map(np.asarray, jout))
    for k, v in tout.items():
        assert _rel(v, want[k]) <= 1e-5, k


def test_frame_shuffler_matches_jax():
    f = np.arange(30, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
    t = np.arange(30)
    for mb in (4, 7, 30, 40):
        js = list(jtrain.FrameShuffler(f, t, minibatch=mb, seed=5))
        shuf = ttrain.FrameShuffler(f, t, minibatch=mb, seed=5)
        ts = list(shuf)
        assert len(ts) == len(js)
        for (a, b), (c, d) in zip(ts, js):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        # tensors are indexed on their own device, in the same order
        tt = list(ttrain.FrameShuffler(torch.from_numpy(f),
                                       torch.from_numpy(t), mb, seed=5))
        for (a, b), (c, _d) in zip(tt, js):
            np.testing.assert_array_equal(a.numpy(), c)


def _lstm_pair(seed, cfg, num_pdfs=6, num_layers=2, bidirectional=False):
    jm = jlstm.LstmProjected(cfg, num_pdfs, num_layers, bidirectional)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = tlstm.LstmProjected(cfg, num_pdfs, num_layers, bidirectional,
                             device="cpu")
    return jm, jp, tm, lstm_params_from_jax(jp)


@pytest.mark.parametrize("peep", [True, False])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_stack_forward_matches_jax(peep, bidirectional):
    cfg = tlstm.LstmConfig(input_dim=4, cell_dim=8, proj_dim=3,
                           with_peepholes=peep)
    jcfg = jlstm.LstmConfig(**dataclasses.asdict(cfg))
    jm, jp, tm, tp = _lstm_pair(1, jcfg, bidirectional=bidirectional)
    tm.cfg = cfg
    # the peepholes' o weights are zero at init: move them
    for k in tp:
        if k.endswith("peep_o"):
            tp[k] = torch.randn(tp[k].shape, generator=torch.Generator()
                                .manual_seed(0)) * 0.2
            li, d = k.split(".")[1:3]
            jp["layers"][int(li)][d]["peep_o"] = tp[k].numpy()
    assert set(tp) == set(tm.init(torch.Generator().manual_seed(0)))
    x = np.random.RandomState(2).randn(2, 9, 4).astype(np.float32)
    jy, jst = jm.apply(jp, jnp.asarray(x))
    ty, tst = tm.apply(tp, torch.from_numpy(x))
    assert _rel(ty, np.asarray(jy)) <= 1e-5
    for a, b in zip(tst, jst):
        if b is None:
            assert a is None
        else:
            for u, v in zip(a, b):
                assert _rel(u, np.asarray(v)) <= 1e-5


def test_lstm_chunked_state_carry_matches_full_and_jax():
    cfg = tlstm.LstmConfig(input_dim=4, cell_dim=8, proj_dim=3)
    jcfg = jlstm.LstmConfig(**dataclasses.asdict(cfg))
    jparams = jax.tree_util.tree_map(
        np.asarray, jlstm.lstm_init(jax.random.PRNGKey(0), jcfg))
    tparams = lstm_params_from_jax(jparams)
    x = np.random.RandomState(1).randn(2, 10, 4).astype(np.float32)
    xt = torch.from_numpy(x)
    y_full, st_full = tlstm.lstm_apply(tparams, xt, cfg)
    y1, st1 = tlstm.lstm_apply(tparams, xt[:, :6], cfg)
    y2, st2 = tlstm.lstm_apply(tparams, xt[:, 6:], cfg, state=st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0,
                               atol=1e-6)
    for a, b in zip(st2, st_full):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    jy1, jst1 = jlstm.lstm_apply(jparams, jnp.asarray(x[:, :6]), jcfg)
    jy2, jst2 = jlstm.lstm_apply(jparams, jnp.asarray(x[:, 6:]), jcfg,
                                 state=jst1)
    assert _rel(y2, np.asarray(jy2)) <= 1e-5
    for a, b in zip(st2, jst2):
        assert _rel(a, np.asarray(b)) <= 1e-5
    # BLSTM
    kf, kb = jax.random.split(jax.random.PRNGKey(2))
    fwd, bwd = (jax.tree_util.tree_map(np.asarray, jlstm.lstm_init(k, jcfg))
                for k in (kf, kb))
    want = np.asarray(jlstm.blstm_apply(fwd, bwd, jnp.asarray(x), jcfg))
    got = tlstm.blstm_apply(lstm_params_from_jax(fwd),
                            lstm_params_from_jax(bwd), xt, cfg)
    assert _rel(got, want) <= 1e-5


def test_train_lstm_streams_matches_jax():
    cfg = jlstm.LstmConfig(input_dim=3, cell_dim=6, proj_dim=4)
    jm, jp, tm, tp = _lstm_pair(3, cfg, num_pdfs=4, num_layers=2)
    tm.cfg = tlstm.LstmConfig(**dataclasses.asdict(cfg))
    rng = np.random.RandomState(6)
    utts = [(rng.randn(n, 3).astype(np.float32), rng.randint(0, 4, n))
            for n in (13, 7, 25, 9, 4, 18)]
    jopts = jtrain.StreamTrainOpts(num_streams=3, bptt_chunk=5,
                                   learning_rate=0.2, num_epochs=2,
                                   grad_clip=1.0)
    topts = ttrain.StreamTrainOpts(**dataclasses.asdict(jopts))
    jout, jhist = jtrain.train_lstm_streams(jm, jp, utts, jopts)
    tout, thist = ttrain.train_lstm_streams(tm, tp, utts, topts)
    np.testing.assert_allclose(thist, jhist, rtol=1e-5)
    want = lstm_params_from_jax(jax.tree_util.tree_map(np.asarray, jout))
    for k, v in tout.items():
        assert _rel(v, want[k]) <= 1e-5, k


def test_losses_match_jax():
    rng = np.random.RandomState(7)
    lp = np.log(rng.dirichlet(np.ones(5), (3, 4))).astype(np.float32)
    t = rng.randint(0, 5, (3, 4)).astype(np.int32)
    w = (rng.rand(3, 4) > 0.3).astype(np.float32)
    jl, ja = jtrain.xent_loss(jnp.asarray(lp), jnp.asarray(t), jnp.asarray(w))
    tl, ta = ttrain.xent_loss(*(torch.from_numpy(a) for a in (lp, t, w)))
    assert _rel(tl, np.asarray(jl)) <= 1e-6
    assert _rel(ta, np.asarray(ja)) <= 1e-6
    pred, tgt = rng.randn(3, 4, 2).astype(np.float32), \
        rng.randn(3, 4, 2).astype(np.float32)
    for p, q, ww in ((pred, tgt, w), (pred[0], tgt[0], w[0])):
        want = jtrain.mse_loss(jnp.asarray(p), jnp.asarray(q),
                               jnp.asarray(ww))
        got = ttrain.mse_loss(*(torch.from_numpy(a) for a in (p, q, ww)))
        assert _rel(got, np.asarray(want)) <= 1e-6


@pytest.mark.parametrize("hidden_type", ["bernoulli", "gaussian"])
def test_rbm_cd1_given_jax_sample_matches_jax(hidden_type):
    cfg = dict(visible_dim=10, hidden_dim=16, visible_type="gaussian",
               hidden_type=hidden_type, learning_rate=0.05)
    jr = jrbm.Rbm(jrbm.RbmConfig(**cfg), seed=3)
    tr = trbm.Rbm(trbm.RbmConfig(**cfg), seed=3, device="cpu")
    np.testing.assert_array_equal(tr.W.numpy(), np.asarray(jr.W))
    data = np.random.RandomState(4).randn(3, 32, 10).astype(np.float32)
    for i, v in enumerate(data):
        key = jax.random.PRNGKey(10 + i)
        h_pos = jr.propagate(jnp.asarray(v))
        # JAX's own draw from the key, as its cd1_step makes it
        if hidden_type == "bernoulli":
            sample = (jax.random.uniform(key, h_pos.shape)
                      < h_pos).astype(jnp.float32)
        else:
            sample = h_pos + jax.random.normal(key, h_pos.shape)
        want = jr.cd1_step(jnp.asarray(v), key)
        got = tr.cd1_update(torch.from_numpy(v),
                            torch.from_numpy(np.array(sample)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)
    for a, b in ((tr.W, jr.W), (tr.vis_bias, jr.vis_bias),
                 (tr.hid_bias, jr.hid_bias)) + tuple(zip(tr._vel, jr._vel)):
        assert _rel(a, np.asarray(b)) <= 1e-6
    # the converter carries the stepped RBM, velocities included
    cr = rbm_from_jax(jr, device="cpu")
    for a, b in ((cr.W, jr.W), (cr.hid_bias, jr.hid_bias)) \
            + tuple(zip(cr._vel, jr._vel)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    W, b = tr.as_dbn_layer()
    assert W.shape == (16, 10) and b.shape == (16,)
    # the port's own sampling: one generator seed, one step
    mse = [trbm.Rbm(trbm.RbmConfig(**cfg), seed=3, device="cpu").cd1_step(
        torch.from_numpy(data[0]), torch.Generator().manual_seed(0))
        for _ in range(2)]
    assert mse[0] == mse[1]


def test_conv1d_and_pooling_match_jax():
    cfg = tconv.Conv1dConfig(input_dim=12, patch_dim=4, patch_step=2,
                             num_filters=3)
    jcfg = jconv.Conv1dConfig(**dataclasses.asdict(cfg))
    assert (cfg.num_patches, cfg.output_dim) == (jcfg.num_patches,
                                                 jcfg.output_dim)
    params = jax.tree_util.tree_map(np.array, jconv.conv1d_init(
        jax.random.PRNGKey(8), jcfg))
    params["bias"] = np.random.RandomState(0).randn(3).astype(np.float32)
    x = np.random.RandomState(9).randn(2, 7, 12).astype(np.float32)
    want = np.asarray(jconv.conv1d_apply(params, jnp.asarray(x), jcfg))
    got = tconv.conv1d_apply({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x), cfg)
    assert _rel(got, want) <= 1e-6
    for size, step, stride in ((2, 1, 3), (3, 2, 3), (1, 1, 5)):
        assert _rel(tconv.max_pooling_apply(got, size, step, stride),
                    np.asarray(jconv.max_pooling_apply(
                        jnp.asarray(want), size, step, stride))) <= 1e-6
    ours = tconv.conv1d_init(torch.Generator().manual_seed(0), cfg)
    assert ours["filters"].shape == params["filters"].shape


def test_kl_hmm_scores_match_jax():
    rng = np.random.RandomState(11)
    post = rng.dirichlet(np.ones(6), 40)
    ali = rng.randint(0, 4, 40)
    j, t = jkl.KlHmm(6, 5), tkl.KlHmm(6, 5)     # state 4 stays untrained
    j.accumulate(post, ali)
    t.accumulate(post, ali)
    np.testing.assert_array_equal(t.state_dists(), j.state_dists())
    z = rng.dirichlet(np.ones(6), (2, 9))
    z[0, 0, 2] = 0.0                             # log floor
    assert _rel(t.scores(z), np.asarray(j.scores(z))) <= 1e-6
    assert t.num_states == 5
