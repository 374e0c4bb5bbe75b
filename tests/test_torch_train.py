"""Port parity: kaldi_tpu_torch.nnet.train against kaldi_tpu.nnet.train.

Both sides get the same numpy params and batches. Tolerances:
- f32: 1e-5 relative on the loss and on the params fingerprint (sum of
  |p| over the leaves) after N steps, the bar PARITY.md pins for the train
  step; each leaf within 1e-5 of its own max |p|. Gradients within 2e-5 of
  the largest gradient of their leaf (the same products summed in
  another order).
- bf16: the products are rounded to bf16 in both frameworks, and the
  partial products and the cotangents of the splice's slices are summed
  in bf16, in an order that may differ: where an f32 sum lands on the
  other side of a bf16 rounding boundary, that element moves by a bf16
  ulp (2^-8 relative), and after a step so does any weight that rounds
  to bf16 differently. Held at 2e-2 of the leaf's largest gradient or
  param, 1e-3 relative on the loss and on the fingerprint. Measured on
  this file's shapes: one step 1.2e-7 (gradients) and 1.6e-7 (loss);
  after 6 steps the loss within 3.5e-4, the leaves within 5.9e-3, the
  fingerprint within 3.4e-5.
- Adam (train_progressive): 1e-5 as for f32, on uneven frame weights.
  Adam's first step moves every element by about lr whatever the size of
  its gradient, so an element whose gradient is zero up to rounding (a
  bias whose class is hit exactly as often as the uniform softmax
  predicts) moves by the sign of the rounding noise; uneven weights leave
  no such element.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu.nnet import train as jtrain
from kaldi_tpu_torch.nnet import train as ttrain
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.params import random_tdnn_params, tdnn_params_from_jax

torch.set_num_threads(2)

CFG = dict(feat_dim=8, num_pdfs=12, hidden_dim=16, pnorm_output_dim=4,
           nonlinearity="relu", splice_indexes=((-2, -1, 0, 1, 2), (-1, 2),
                                                (0,)))


def _setup(nonlinearity="relu", B=3, T=10, seed=0):
    cfg = dict(CFG, nonlinearity=nonlinearity)
    tree = random_tdnn_params(TdnnConfig(**cfg), np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    lc, rc = 3, 4
    feats = rng.standard_normal((B, T + lc + rc, cfg["feat_dim"])) \
        .astype(np.float32)
    tgt = rng.integers(0, cfg["num_pdfs"], (B, T)).astype(np.int32)
    w = (rng.random((B, T)) > 0.2).astype(np.float32)
    return cfg, tree, feats, tgt, w


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def fingerprint(leaves) -> float:
    return float(sum(np.abs(np.asarray(l, np.float64)).sum() for l in leaves))


def _assert_params_close(tparams, jparams, rel, fp_rel=None):
    jflat = tdnn_params_from_jax(jax.tree.map(np.asarray, jparams))
    for k, v in tparams.items():
        want = jflat[k].numpy()
        err = np.abs(v.detach().numpy() - want).max()
        assert err <= rel * max(np.abs(want).max(), 1e-30), (k, err)
    assert fingerprint(tparams.values()) == pytest.approx(
        fingerprint(jax.tree_util.tree_leaves(jparams)), rel=fp_rel or rel)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_acc_and_gradients_of_one_step(dtype):
    cfg, tree, feats, tgt, w = _setup()
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JTdnn(JTdnnConfig(**cfg))
    (jl, ja), jg = jax.jit(jax.value_and_grad(
        lambda p: jtrain.cross_entropy_loss(
            jm, p, jnp.asarray(feats), jnp.asarray(tgt), jnp.asarray(w),
            compute_dtype=jdt), has_aux=True))(_jtree(tree))
    tm = Tdnn(TdnnConfig(**cfg))
    params = {k: v.requires_grad_(True)
              for k, v in tdnn_params_from_jax(tree).items()}
    tl, ta = ttrain.cross_entropy_loss(
        tm, params, torch.from_numpy(feats), torch.from_numpy(tgt),
        torch.from_numpy(w), compute_dtype=tdt)
    grads = dict(zip(params, torch.autograd.grad(tl, list(params.values()))))
    assert float(tl.detach()) == pytest.approx(
        float(jl), rel=1e-5 if tdt is None else 1e-3)
    assert float(ta) == float(ja)
    tol = 2e-5 if tdt is None else 2e-2
    jflat = tdnn_params_from_jax(jax.tree.map(np.asarray, jg))
    for k, g in grads.items():
        want = jflat[k].numpy()
        err = np.abs(g.numpy() - want).max()
        assert err <= tol * np.abs(want).max(), (k, err)


def test_accuracy_takes_the_first_index_of_a_tied_max():
    lp = torch.log_softmax(torch.tensor([[[0.0, 1.0, 1.0]]]), -1)
    for tgt, want in ((1, 1.0), (2, 0.0)):
        _, acc = ttrain._ce(lp, torch.tensor([[tgt]]), torch.ones(1, 1))
        assert float(acc) == want


OPTIONS = list(itertools.product([0.0, 0.5], [0.0, 1e-2], [0.0, 0.9]))


@pytest.mark.parametrize("clip,l2,momentum", OPTIONS)
def test_n_f32_steps_match_jax_for_every_optimizer_option(clip, l2,
                                                          momentum):
    """make_optimizer with clip, l2 and momentum each on or off: the loss
    of each of 8 steps and the params after them within 1e-5 relative.
    max_grad_norm 0.5 clips some steps and not others."""
    cfg, tree, feats, tgt, w = _setup(seed=3)
    opts = ttrain.NnetTrainOpts(initial_lr=0.2, final_lr=0.05,
                                max_grad_norm=clip, l2_regularize=l2,
                                momentum=momentum)
    n = 8
    jm = JTdnn(JTdnnConfig(**cfg))
    jopt = jtrain.make_optimizer(jtrain.NnetTrainOpts(
        **dataclasses.asdict(opts)), n)
    jparams = _jtree(tree)
    jstate = jopt.init(jparams)
    jstep = jtrain.make_train_step(jm, jopt)
    topt = ttrain.make_optimizer(opts, n)
    tparams = tdnn_params_from_jax(tree)
    tstate = topt.init(tparams)
    tstep = ttrain.make_train_step(Tdnn(TdnnConfig(**cfg)), topt)
    batch = [torch.from_numpy(a) for a in (feats, tgt, w)]
    for _ in range(n):
        jparams, jstate, jl, ja = jstep(jparams, jstate, jnp.asarray(feats),
                                        jnp.asarray(tgt), jnp.asarray(w))
        tparams, tstate, tl, ta = tstep(tparams, tstate, *batch)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
        assert float(ta) == float(ja)
    _assert_params_close(tparams, jparams, 1e-5)


def test_n_bf16_steps_match_jax():
    cfg, tree, feats, tgt, w = _setup(seed=4)
    opts = ttrain.NnetTrainOpts(initial_lr=0.1, final_lr=0.02,
                                max_grad_norm=5.0)
    n = 6
    jm = JTdnn(JTdnnConfig(**cfg))
    jopt = jtrain.make_optimizer(jtrain.NnetTrainOpts(
        **dataclasses.asdict(opts)), n)
    jparams = _jtree(tree)
    jstate = jopt.init(jparams)
    jstep = jtrain.make_train_step(jm, jopt, compute_dtype=jnp.bfloat16)
    topt = ttrain.make_optimizer(opts, n)
    tparams = tdnn_params_from_jax(tree)
    tstate = topt.init(tparams)
    tstep = ttrain.make_train_step(Tdnn(TdnnConfig(**cfg)), topt,
                                   compute_dtype=torch.bfloat16)
    batch = [torch.from_numpy(a) for a in (feats, tgt, w)]
    for _ in range(n):
        jparams, jstate, jl, _ = jstep(jparams, jstate, jnp.asarray(feats),
                                       jnp.asarray(tgt), jnp.asarray(w))
        tparams, tstate, tl, _ = tstep(tparams, tstate, *batch)
        assert float(tl) == pytest.approx(float(jl), rel=1e-3)
    _assert_params_close(tparams, jparams, 2e-2, fp_rel=1e-3)


class _JaxNoDtypeNet:
    """A net with JAX's apply signature but no compute_dtype: a linear
    layer over the frames inside one frame of context each side."""

    def apply(self, params, feats, pad_context=True):
        x = feats if pad_context else feats[:, 1:-1]
        return jax.nn.log_softmax(x @ params["w"], axis=-1)


class _NoDtypeNet(torch.nn.Module):
    """The same net as a torch module whose forward takes no
    compute_dtype."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w), requires_grad=False)

    def forward(self, feats, pad_context=True):
        x = feats if pad_context else feats[:, 1:-1]
        return torch.log_softmax(x @ self.w, dim=-1)


def test_loss_passes_compute_dtype_only_when_set():
    """JAX's loss passes compute_dtype to the model only when it is set,
    so a net whose apply has no such keyword shares it; the port's loss
    does the same (it raised TypeError before) and gives JAX's loss and
    accuracy."""
    rng = np.random.RandomState(0)
    w = rng.randn(6, 4).astype(np.float32)
    feats = rng.randn(3, 7, 6).astype(np.float32)
    targets = rng.randint(0, 4, (3, 5)).astype(np.int32)
    weights = rng.uniform(0.5, 1.0, (3, 5)).astype(np.float32)
    jl, ja = jtrain.cross_entropy_loss(
        _JaxNoDtypeNet(), {"w": jnp.asarray(w)}, jnp.asarray(feats),
        jnp.asarray(targets), jnp.asarray(weights))
    tl, ta = ttrain.cross_entropy_loss(
        _NoDtypeNet(w), {"w": torch.as_tensor(w)}, torch.as_tensor(feats),
        torch.as_tensor(targets), torch.as_tensor(weights))
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)


def test_train_step_returns_new_tensors_and_rejects_a_mesh():
    cfg, tree, feats, tgt, w = _setup()
    model = Tdnn(TdnnConfig(**cfg))
    opt = ttrain.make_optimizer(ttrain.NnetTrainOpts(), 4)
    params = tdnn_params_from_jax(tree)
    before = {k: v.clone() for k, v in params.items()}
    step = ttrain.make_train_step(model, opt)
    new, _, loss, acc = step(params, opt.init(params),
                             *(torch.from_numpy(a) for a in (feats, tgt, w)))
    assert all(torch.equal(params[k], before[k]) for k in params)
    assert not any(torch.equal(new[k], before[k]) for k in ("final.w",))
    assert loss.dim() == 0 and acc.dim() == 0 and not loss.requires_grad
    assert not any(v.requires_grad for v in new.values())
    # a mesh is a parallel.mesh DeviceMesh (tests/test_torch_parallel_train.py
    # runs the mesh step); anything else is rejected
    with pytest.raises(TypeError):
        ttrain.make_train_step(model, opt, mesh=object())


def _egs(seed=0, n_utts=2, D=8, P=12):
    rng = np.random.default_rng(seed)
    utts = [(rng.standard_normal((T, D)).astype(np.float32),
             rng.integers(0, P, T).astype(np.int32)) for T in (11, 5)[:n_utts]]
    return utts


def test_make_egs_equals_jax():
    utts = _egs()
    for chunk in (4, 8):
        want = jtrain.make_egs(utts, 3, 4, chunk=chunk)
        got = ttrain.make_egs(utts, 3, 4, chunk=chunk)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("num_epochs,mb", [(2, 8), (1, 2)])
def test_train_epochs_matches_jax(num_epochs, mb):
    """5 egs: with mb 8 every batch is the tiled permutation (a corpus
    smaller than a minibatch); with mb 2, two full batches per epoch."""
    cfg, tree, _, _, _ = _setup()
    egs = ttrain.make_egs(_egs(), 3, 4, chunk=4)
    assert egs["feats"].shape[0] == 5
    opts = ttrain.NnetTrainOpts(initial_lr=0.1, final_lr=0.05,
                                num_epochs=num_epochs, minibatch_size=mb,
                                momentum=0.5)
    jparams, jhist = jtrain.train_epochs(
        JTdnn(JTdnnConfig(**cfg)), _jtree(tree), egs,
        jtrain.NnetTrainOpts(**dataclasses.asdict(opts)),
        rng=np.random.RandomState(7), log_every=1)
    tparams, thist = ttrain.train_epochs(
        Tdnn(TdnnConfig(**cfg)), tdnn_params_from_jax(tree), egs, opts,
        rng=np.random.RandomState(7), log_every=1, device="cpu")
    assert [h[:2] for h in thist] == [h[:2] for h in jhist]
    for (_, _, tl, ta), (_, _, jl, ja) in zip(thist, jhist):
        assert tl == pytest.approx(jl, rel=1e-5) and ta == ja
    _assert_params_close(tparams, jparams, 1e-5)


def test_train_progressive_stages_match_jax():
    cfg = dict(CFG, nonlinearity="pnorm")
    tree = random_tdnn_params(TdnnConfig(**cfg), np.random.default_rng(5))
    tree["final"]["w"][:] = 0.0
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 12 + 7, 8)).astype(np.float32)
    tgt = rng.integers(0, 12, (2, 12)).astype(np.int32)
    w = rng.uniform(0.5, 1.5, (2, 12)).astype(np.float32)
    kw = dict(steps_per_stage=4, final_steps=6)
    jparams, jhist = jtrain.train_progressive(
        JTdnn(JTdnnConfig(**cfg)), _jtree(tree), jnp.asarray(feats),
        jnp.asarray(tgt), jnp.asarray(w), **kw)
    tparams, thist = ttrain.train_progressive(
        Tdnn(TdnnConfig(**cfg)), tdnn_params_from_jax(tree), feats, tgt, w,
        device="cpu", **kw)
    assert [h[0] for h in thist] == [h[0] for h in jhist] == [1, 2, 3]
    for (_, tl, ta), (_, jl, ja) in zip(thist, jhist):
        assert tl == pytest.approx(jl, rel=1e-5)
        assert ta == pytest.approx(ja, rel=1e-6)
    _assert_params_close(tparams, jparams, 1e-5)


def _spike_task(rng, cfg, B=4, T=100):
    """tests/test_progressive_training.py's task: one spike per frame at
    the target's feature, targets uniform."""
    lc, rc = cfg.left_context, cfg.right_context
    feats = np.zeros((B, T + lc + rc, cfg.feat_dim), np.float32)
    tgt = rng.randint(0, cfg.num_pdfs, (B, T)).astype(np.int32)
    for b in range(B):
        for t in range(T):
            feats[b, t + lc, tgt[b, t] % cfg.feat_dim] = 5.0
    return feats, tgt, np.ones((B, T), np.float32)


def test_port_deep_pnorm_progressive_converges_where_flat_stalls():
    """The claim of tests/test_progressive_training.py, on the port alone
    with its own init: flat training of a 5-layer p-norm stack from the
    zero final affine stalls at the class prior, growing it converges."""
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64, hidden_dim=256,
                     pnorm_output_dim=32)
    model = Tdnn(cfg)
    feats, tgt, w = _spike_task(np.random.RandomState(0), cfg)
    batch = [torch.from_numpy(a) for a in (feats, tgt, w)]
    opts = ttrain.NnetTrainOpts(initial_lr=0.05, final_lr=0.01)
    params = model.init(torch.Generator().manual_seed(0))
    opt = ttrain.make_optimizer(opts, 300)
    state = opt.init(params)
    step = ttrain.make_train_step(model, opt)
    for _ in range(300):
        params, state, loss, acc = step(params, state, *batch)
    assert float(acc) < 0.3, float(acc)

    params = model.init(torch.Generator().manual_seed(0))
    params, hist = ttrain.train_progressive(model, params, feats, tgt, w,
                                            opts, steps_per_stage=120,
                                            final_steps=240, device="cpu")
    assert hist[-1][0] == 5
    assert hist[-1][2] > 0.9, hist
    model.load_state_dict(params)
    with torch.no_grad():
        pred = model(batch[0], pad_context=False).argmax(-1).numpy()
    assert (pred == tgt).mean() > 0.9
