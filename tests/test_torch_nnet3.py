"""Port parity: the nnet3 family (kaldi_tpu_torch.nnet3) against
kaldi_tpu.nnet3 on the CPU, at small widths.

- Descriptors: the parse tree, context, referenced names, ref_offsets
  and dims equal JAX's for every operator (Append, Sum, Offset, Scale,
  Round, IfDefined).
- Config strings of make_tdnn_config / make_lstm_config byte-equal.
- Networks built from the same config have JAX's dims, contexts and
  recurrence flag; the dense forward of a TDNN config and the recurrent
  forward of RNN / LSTM configs, with JAX's weights carried across by
  `params.nnet3_params_from_jax`, agree within 1e-5 relative; the error
  cases (required cycle, positive offset into a recurrence, zero-delay
  cycle, a descriptor of the wrong dim, an unknown type) raise as JAX's.
- `nnet3_objective` (linear and quadratic) and its gradients within 1e-5
  of `jax.grad`'s; 8 f32 steps of `make_nnet3_train_step` with NG-SGD
  (two refreshes), clipping and momentum within 1e-5, the NG filter
  picking exactly the NaturalGradientAffineComponent weights;
  `train_nnet3`'s loss history over 2 epochs within 1e-5.
- An explicit param-stddev=0 is a zero init; `AmNnet3.loglikes` within
  1e-5 (`params.am_nnet3_from_jax`), `replace_params` taking either
  package's params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.nnet3 import configs as jconfigs
from kaldi_tpu.nnet3 import descriptors as jdesc
from kaldi_tpu.nnet3 import training as jtrain
from kaldi_tpu.nnet3.network import Nnet3 as JNnet3
from kaldi_tpu_torch.nnet3 import configs as tconfigs
from kaldi_tpu_torch.nnet3 import descriptors as tdesc
from kaldi_tpu_torch.nnet3 import training as ttrain
from kaldi_tpu_torch.nnet3.network import (Nnet3, component_of_key,
                                           param_key, param_name,
                                           split_param_name)
from kaldi_tpu_torch.params import (am_nnet3_from_jax, nnet3_params_from_jax,
                                    nnet3_params_to_jax)

torch.set_num_threads(2)

TDNN_CONFIG = """
input-node name=input dim=5
component name=l1.affine type=NaturalGradientAffineComponent input-dim=15 output-dim=8
component-node name=l1a component=l1.affine input=Append(Offset(input,-1), input, Offset(input,1))
component name=l1.relu type=RectifiedLinearComponent dim=8
component-node name=l1 component=l1.relu input=l1a
component name=l2.affine type=AffineComponent input-dim=16 output-dim=6 bias-stddev=0.5
component-node name=l2a component=l2.affine input=Append(Offset(l1,-2), Offset(l1,2))
component name=out.log type=LogSoftmaxComponent dim=6
component-node name=outl component=out.log input=l2a
output-node name=output input=outl
"""

# Sum, Scale and Round in a dense net, with per-element scale / offset,
# maxout, normalize, tanh, fixed scale / bias and dropout (inference)
ZOO_CONFIG = """
input-node name=input dim=6
component name=a type=AffineComponent input-dim=12 output-dim=8 bias-stddev=1.0
component-node name=an component=a input=Append(Offset(input,-2), Round(input, 2))
component name=s type=PerElementScaleComponent dim=8
component-node name=sn component=s input=Sum(an, Scale(0.5, Offset(an,1)))
component name=o type=PerElementOffsetComponent dim=8
component-node name=on component=o input=sn
component name=mx type=MaxoutComponent input-dim=8 output-dim=4
component-node name=mxn component=mx input=on
component name=th type=TanhComponent dim=4
component-node name=thn component=th input=mxn
component name=nm type=NormalizeComponent dim=4 target-rms=2.0
component-node name=nmn component=nm input=thn
component name=fs type=FixedScaleComponent dim=4 scale=1.5
component-node name=fsn component=fs input=nmn
component name=fb type=FixedBiasComponent dim=4 bias=-0.25
component-node name=fbn component=fb input=fsn
component name=dr type=DropoutComponent dim=4 dropout-proportion-scale=0.8
component-node name=drn component=dr input=fbn
component name=sg type=SigmoidComponent dim=4
component-node name=sgn component=sg input=drn
component name=cg type=ClipGradientComponent dim=4
component-node name=cgn component=cg input=sgn
component name=ep type=ElementwiseProductComponent input-dim=8 output-dim=4
component-node name=epn component=ep input=Append(cgn, Offset(cgn,-1))
component name=sm type=SoftmaxComponent dim=4
component-node name=smn component=sm input=epn
output-node name=output input=smn objective=quadratic
"""

RNN_CFG = """
input-node name=input dim=2
component name=a type=AffineComponent input-dim=3 output-dim=1 bias-stddev=1.0
component-node name=h component=a input=Append(input, IfDefined(Offset(h, -1)))
output-node name=output input=h
"""

# an IfDefined read past the input's end in an acyclic node (zeros out of
# range), beside a feed-forward output
IFDEF_CFG = """
input-node name=input dim=3
component name=a type=AffineComponent input-dim=6 output-dim=4 bias-stddev=1.0
component-node name=an component=a input=Append(input, IfDefined(Offset(input, 2)))
component name=b type=AffineComponent input-dim=3 output-dim=4
component-node name=bn component=b input=Offset(input, -1)
output-node name=output input=an
output-node name=side input=bn
"""

DESCRIPTORS = [
    "Append(Offset(input,-2), input, Offset(input,2))",
    "Sum(Offset(a,-1), Scale(0.5, b))",
    "IfDefined(Offset(x,3))",
    "Append(input, IfDefined(Offset(lstm0.r, -1)))",
    "Round(Offset(a, -3), 3)",
    "Sum(Append(a, Offset(b, 2)), Scale(-1.5, Append(Offset(a,-1), b)))",
    "Append(Offset(IfDefined(Offset(c, -2)), 1), Offset(d,-4))",
]


def _tree(d):
    return (d.op, d.name, d.t, d.scale, d.modulus,
            tuple(_tree(a) for a in d.args))


def _jp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(cfg: str, seed: int = 0):
    """JAX's net and params, and the port's net holding them."""
    jn = JNnet3(cfg)
    jparams = _jp(jn.init(jax.random.PRNGKey(seed)))
    tn = Nnet3(cfg, device="cpu")
    tn.load_state_dict(nnet3_params_from_jax(jparams))
    return jn, jparams, tn


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-30))


@pytest.mark.parametrize("text", DESCRIPTORS)
def test_descriptors_match_jax(text):
    j, t = jdesc.parse_descriptor(text), tdesc.parse_descriptor(text)
    assert _tree(t) == _tree(j)
    assert t.context() == j.context()
    assert t.referenced() == j.referenced()
    assert t.referenced(required_only=True) == \
        j.referenced(required_only=True)
    assert t.ref_offsets() == j.ref_offsets()
    dims = {n: 3 for n in ("input", "a", "b", "x", "c", "d", "lstm0.r")}
    assert t.dim(dims) == j.dim(dims)


@pytest.mark.parametrize("bad", ["Append(a,", "Offset(a)", "Sum(a,,b)",
                                 "a)", "(a"])
def test_descriptor_parse_errors_match_jax(bad):
    with pytest.raises(Exception) as je:
        jdesc.parse_descriptor(bad)
    with pytest.raises(type(je.value)):
        tdesc.parse_descriptor(bad)


@pytest.mark.parametrize("kw", [
    dict(feat_dim=40, num_targets=300),
    dict(feat_dim=13, num_targets=21, splice_indexes=((-1, 0, 1), (0,)),
         hidden_dim=64, nonlinearity="PnormComponent"),
    dict(feat_dim=30, num_targets=200, hidden_dim=512, pnorm_output_dim=128,
         nonlinearity="PnormComponent", final_logsoftmax=False)])
def test_tdnn_config_byte_equal(kw):
    assert tconfigs.make_tdnn_config(**kw) == jconfigs.make_tdnn_config(**kw)


@pytest.mark.parametrize("kw", [
    dict(feat_dim=40, num_targets=300),
    dict(feat_dim=30, num_targets=200, cell_dim=1024, proj_dim=256,
         num_layers=3),
    dict(feat_dim=4, num_targets=5, cell_dim=8, proj_dim=6, delay=-2,
         splice=(0,), final_logsoftmax=False)])
def test_lstm_config_byte_equal(kw):
    assert tconfigs.make_lstm_config(**kw) == jconfigs.make_lstm_config(**kw)


def test_param_names_round_trip():
    for c in ("tdnn0.affine", "final.affine", "lstm0.W_i", "a%2Eb.c", "x"):
        assert "." not in param_key(c)
        assert component_of_key(param_key(c)) == c
        assert split_param_name(param_name(c, "w")) == (c, "w")


NETS = [TDNN_CONFIG, ZOO_CONFIG, RNN_CFG, IFDEF_CFG,
        RNN_CFG.replace("Offset(h, -1)", "Offset(h, -3)"),
        tconfigs.make_tdnn_config(4, 6, hidden_dim=16,
                                  nonlinearity="PnormComponent",
                                  pnorm_output_dim=4),
        tconfigs.make_lstm_config(4, 5, cell_dim=8, proj_dim=6,
                                  splice=(-1, 0, 1), num_layers=2)]


@pytest.mark.parametrize("i", range(len(NETS)))
def test_static_analysis_matches_jax(i):
    jn, tn = JNnet3(NETS[i]), Nnet3(NETS[i], device="cpu")
    assert tn.dims == jn.dims
    assert tn.contexts == jn.contexts
    assert (tn.left_context, tn.right_context) == (jn.left_context,
                                                   jn.right_context)
    assert tn.is_recurrent == jn.is_recurrent
    assert [(n.kind, n.name, n.component, n.dim, n.objective)
            for n in tn.nodes] == [(n.kind, n.name, n.component, n.dim,
                                    n.objective) for n in jn.nodes]
    jparams = _jp(jn.init(jax.random.PRNGKey(0)))
    assert tn.num_params() == jn.num_params(jparams)
    assert set(tn.state_dict()) == set(nnet3_params_from_jax(jparams))
    for k, v in tn.state_dict().items():
        c, leaf = split_param_name(k)
        assert tuple(v.shape) == jparams[c][leaf].shape


@pytest.mark.parametrize("i", range(len(NETS)))
@pytest.mark.parametrize("pad", [True, False])
def test_forward_matches_jax(i, pad):
    jn, jparams, tn = _pair(NETS[i])
    x = np.random.RandomState(i).randn(3, 14, jn.dims["input"]) \
        .astype(np.float32)
    want = np.asarray(jn.apply(jparams, jnp.asarray(x), pad_context=pad))
    got = tn(torch.from_numpy(x), pad_context=pad)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


def test_side_output_and_ifdef_zeros_match_jax():
    jn, jparams, tn = _pair(IFDEF_CFG)
    x = np.random.RandomState(1).randn(2, 9, 3).astype(np.float32)
    for out in ("output", "side"):
        for pad in (True, False):
            want = np.asarray(jn.apply(jparams, jnp.asarray(x), output=out,
                                       pad_context=pad))
            got = tn(torch.from_numpy(x), output=out, pad_context=pad)
            assert _rel(got.numpy(), want) <= 1e-5, (out, pad)
    # the last two frames read IfDefined(Offset(input, 2)) out of range:
    # their second half of the affine's input is zero
    W = jparams["a"]["w"]
    y = tn(torch.from_numpy(x), pad_context=False).numpy()
    np.testing.assert_allclose(y[:, -1], x[:, -1] @ W[:, :3].T
                               + jparams["a"]["b"], rtol=1e-5, atol=1e-6)


def test_errors_raise_as_jax():
    cyc = RNN_CFG.replace("IfDefined(Offset(h, -1))", "Offset(h, -1)")
    for net in (JNnet3, lambda c: Nnet3(c, device="cpu")):
        with pytest.raises(ValueError, match="cycle"):
            net(cyc)
        with pytest.raises(ValueError, match="input-dim"):
            net(RNN_CFG.replace("input-dim=3", "input-dim=4"))
        with pytest.raises(ValueError, match="unknown component type"):
            net(RNN_CFG.replace("AffineComponent", "FooComponent"))
    x = np.zeros((1, 5, 2), np.float32)
    for cfg, match in ((RNN_CFG.replace("Offset(h, -1)", "Offset(h, 1)"),
                        "positive"),
                       (RNN_CFG.replace("Offset(h, -1)", "h"), "zero-delay")):
        jn, jparams, tn = _pair(cfg)
        with pytest.raises(ValueError, match=match):
            jn.apply(jparams, jnp.asarray(x))
        with pytest.raises(ValueError, match=match):
            tn(torch.from_numpy(x))
        with pytest.raises(ValueError, match=match):      # raises again
            tn(torch.from_numpy(x))


def test_zero_param_stddev_is_respected():
    cfg = TDNN_CONFIG.replace("output-dim=6 bias-stddev=0.5",
                              "output-dim=6 param-stddev=0 bias-stddev=0")
    tn = Nnet3(cfg, device="cpu")
    p = tn.init(torch.Generator().manual_seed(0))
    assert torch.count_nonzero(p[param_name("l2.affine", "w")]) == 0
    assert torch.count_nonzero(p[param_name("l2.affine", "b")]) == 0
    assert torch.count_nonzero(p[param_name("l1.affine", "w")]) > 0
    j = _jp(JNnet3(cfg).init(jax.random.PRNGKey(0)))
    assert not j["l2.affine"]["w"].any() and j["l1.affine"]["w"].any()
    # init draws the JAX init's stddevs; one seed gives one net
    q = Nnet3(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for k in p:
        torch.testing.assert_close(q[k], p[k], rtol=0, atol=0)
    w = Nnet3(cfg, device="cpu").init(torch.Generator().manual_seed(1))[
        param_name("l1.affine", "w")]
    assert abs(float(w.std()) - 1 / np.sqrt(15)) < 0.1 / np.sqrt(15)


def _batch(jn, seed, B=4, T=6, quadratic=False):
    rng = np.random.RandomState(seed)
    lc, rc = jn.left_context, jn.right_context
    feats = rng.randn(B, T + lc + rc, jn.dims["input"]).astype(np.float32)
    P = jn.dims["output"]
    targets = (rng.rand(B, T, P).astype(np.float32) if quadratic
               else rng.randint(0, P, (B, T)).astype(np.int32))
    weights = (rng.rand(B, T) > 0.2).astype(np.float32)
    return feats, targets, weights


LOSS_NETS = [(TDNN_CONFIG, False), (ZOO_CONFIG, True),
             (tconfigs.make_lstm_config(4, 5, cell_dim=8, proj_dim=6,
                                        splice=(-1, 0, 1)), False)]


@pytest.mark.parametrize("i", range(len(LOSS_NETS)))
def test_objective_and_gradients_match_jax(i):
    cfg, quad = LOSS_NETS[i]
    jn, jparams, tn = _pair(cfg, seed=i)
    feats, targets, weights = _batch(jn, i, quadratic=quad)

    def jloss(p):
        return jtrain.nnet3_objective(jn, p, jnp.asarray(feats),
                                      jnp.asarray(targets),
                                      jnp.asarray(weights))

    (jl, ja), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tn.params().items()}
    tl, ta = ttrain.nnet3_objective(tn, leaves, torch.from_numpy(feats),
                                    torch.from_numpy(targets),
                                    torch.from_numpy(weights))
    assert _rel(tl.item(), float(jl)) <= 1e-5
    assert abs(ta.item() - float(ja)) <= 1e-6
    grads = torch.autograd.grad(tl, list(leaves.values()))
    jflat = nnet3_params_from_jax(_jp(jg))
    for (k, _v), g in zip(leaves.items(), grads):
        assert _rel(g.numpy(), jflat[k].numpy()) <= 1e-5, k


def _run_steps(jn, jparams, tn, opts, batches):
    """n steps of each package's train step from the same params; ->
    (JAX params, port params, JAX losses, port losses, port state)."""
    jopt = jtrain.make_nnet3_optimizer(jn, opts, len(batches))
    jstep = jtrain.make_nnet3_train_step(jn, jopt)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jst = jopt.init(jp)
    topt = ttrain.make_nnet3_optimizer(tn, opts, len(batches))
    tstep = ttrain.make_nnet3_train_step(tn, topt)
    tp = tn.params()
    tst = topt.init(tp)
    jl, tl = [], []
    for f, t, w in batches:
        jp, jst, loss, _acc = jstep(jp, jst, jnp.asarray(f), jnp.asarray(t),
                                    jnp.asarray(w))
        jl.append(float(loss))
        tp, tst, loss, _acc = tstep(tp, tst, torch.from_numpy(f),
                                    torch.from_numpy(t), torch.from_numpy(w))
        tl.append(float(loss))
    return _jp(jp), tp, jl, tl, tst


@pytest.mark.parametrize("i", range(len(LOSS_NETS)))
def test_eight_ng_steps_match_jax(i):
    cfg, quad = LOSS_NETS[i]
    jn, jparams, tn = _pair(cfg, seed=10 + i)
    opts = ttrain.Nnet3TrainOpts(initial_lr=0.05, final_lr=0.01,
                                 momentum=0.5, max_grad_norm=1.0,
                                 ng_update_period=4)
    batches = [_batch(jn, 100 + k, quadratic=quad) for k in range(8)]
    jp, tp, jl, tl, tst = _run_steps(jn, jparams, tn, opts, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jflat = nnet3_params_from_jax(jp)
    for k, v in tp.items():
        assert _rel(v.numpy(), jflat[k].numpy()) <= 1e-5, k
    # the NG factors are on exactly the NaturalGradientAffineComponent
    # weights (JAX: their keystr holds the component name)
    ng = {param_name(c, "w") for c, cfg_ in tn.components.items()
          if cfg_["type"] == "NaturalGradientAffineComponent"}
    if ng:
        assert set(tst[0].factors) == ng
        assert tst[0].step == 8
    else:                      # no NG components: no preconditioner
        assert len(tst) == 2


def test_train_nnet3_history_matches_jax():
    cfg = tconfigs.make_tdnn_config(4, 6, splice_indexes=((-1, 0, 1), (0,)),
                                    hidden_dim=16,
                                    nonlinearity="PnormComponent",
                                    pnorm_output_dim=4)
    jn, jparams, tn = _pair(cfg, seed=3)
    rng = np.random.RandomState(5)
    N, T = 21, 4
    egs = {"feats": rng.randn(N, T + 2, 4).astype(np.float32),
           "targets": rng.randint(0, 6, (N, T)).astype(np.int32),
           "weights": np.ones((N, T), np.float32)}
    opts = ttrain.Nnet3TrainOpts(initial_lr=0.05, final_lr=0.01,
                                 num_epochs=2, minibatch_size=8,
                                 momentum=0.9, ng_update_period=2)
    jout, jhist = jtrain.train_nnet3(jn, jax.tree_util.tree_map(
        jnp.asarray, jparams), egs, jtrain.Nnet3TrainOpts(
        **vars(opts)), log_every=1)
    tout, thist = ttrain.train_nnet3(tn, tn.params(), egs, opts, log_every=1)
    assert [h[:2] for h in thist] == [h[:2] for h in jhist]
    np.testing.assert_allclose([h[2] for h in thist], [h[2] for h in jhist],
                               rtol=1e-5)
    np.testing.assert_allclose([h[3] for h in thist], [h[3] for h in jhist],
                               atol=1e-6)
    jflat = nnet3_params_from_jax(_jp(jout))
    for k, v in tout.items():
        assert _rel(v.numpy(), jflat[k].numpy()) <= 1e-5, k


def test_am_nnet3_loglikes_and_replace_params_match_jax():
    cfg = tconfigs.make_lstm_config(4, 7, cell_dim=8, proj_dim=6,
                                    splice=(-1, 0, 1))
    jn, jparams, _tn = _pair(cfg, seed=4)
    priors = np.random.RandomState(0).dirichlet(np.ones(7))
    jam = jtrain.AmNnet3(jn, jax.tree_util.tree_map(jnp.asarray, jparams),
                         priors)
    tam = am_nnet3_from_jax(jam, device="cpu")
    assert tam.num_pdfs == jam.num_pdfs == 7
    assert tam.device.type == "cpu"
    np.testing.assert_array_equal(tam.priors, priors)
    x = np.random.RandomState(2).randn(2, 11, 4).astype(np.float32)
    want = jam.loglikes_np(x)
    assert _rel(tam.loglikes_np(x), want) <= 1e-5
    assert _rel(tam.log_posteriors(x, pad_context=False).numpy(),
                np.asarray(jam.log_posteriors(x, pad_context=False))) <= 1e-5
    # replace_params from a JAX tree and from the port's dict
    moved = jax.tree_util.tree_map(lambda a: a * 0.5, jparams)
    want2 = jam.replace_params(jax.tree_util.tree_map(jnp.asarray, moved)) \
        .loglikes_np(x)
    for p in (moved, nnet3_params_from_jax(moved)):
        got = tam.replace_params(p)
        assert isinstance(got, ttrain.AmNnet3)
        assert _rel(got.loglikes_np(x), want2) <= 1e-5
    # the round trip through the JAX layout is exact
    back = nnet3_params_from_jax(nnet3_params_to_jax(tam.model.params()))
    for k, v in tam.model.params().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
