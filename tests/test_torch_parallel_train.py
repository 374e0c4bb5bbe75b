"""Port parity: the mesh train step against kaldi_tpu's and the port's own.

At test_multihost_launch.py's config (feat 8, pdfs 32, hidden 32, pnorm
16) with JAX's `Tdnn.init(PRNGKey(0))` carried across, 3 steps of the
global batch (16 rows x 4 frames; the second half of the rows, all of one
data rank's, carry zero weights, so JAX's global normaliser differs from a
mean of per-rank losses) on the meshes (2, 1) and (1, 2) over 2 gloo
ranks and (2, 2) over 4, as __graft_entry__.py:25-60 runs JAX's. Losses,
accuracies and params agree across ranks, with the port's single-process
step and with JAX's mesh step on the conftest's virtual devices, within
1e-5. Each rank's `shard_params` shard equals the slice JAX's
`tdnn_param_sharding` puts on that device; `train_epochs(mesh=)` equals
JAX's and the port's single-process run. `train_tdnn(mesh=(2, 1))` trains
the net that `train_tdnn` trains without a mesh from the same monophone,
and a one-rank mesh made in this process steps as the step without one.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu.nnet.train import (NnetTrainOpts as JOpts,
                                  make_optimizer as j_make_optimizer,
                                  make_train_step as j_make_train_step,
                                  shard_params as j_shard_params,
                                  train_epochs as j_train_epochs)
from kaldi_tpu.parallel.mesh import (batch_sharding as j_batch_sharding,
                                     make_mesh as j_make_mesh)
from kaldi_tpu_torch.nnet import train as ttrain
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.params import tdnn_params_from_jax

from torch_gang import run_gang

torch.set_num_threads(2)

CFG = dict(feat_dim=8, num_pdfs=32, hidden_dim=32, pnorm_output_dim=16,
           splice_indexes=((-1, 0, 1), (-1, 1), (0,)))
OPTS = dict(initial_lr=0.1, final_lr=0.02)
STEPS = 3
EPOCHS = dict(initial_lr=0.1, final_lr=0.02, minibatch_size=16, num_epochs=2)
TOL = 1e-5


def _init_tree():
    tree = JTdnn(JTdnnConfig(**CFG)).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch():
    B, chunk = 16, 4
    ctx = 2 + 2                        # left and right context
    rng = np.random.RandomState(7)
    feats = rng.randn(B, chunk + ctx, CFG["feat_dim"]).astype(np.float32)
    tgt = rng.randint(0, CFG["num_pdfs"], (B, chunk)).astype(np.int32)
    w = np.ones((B, chunk), np.float32)
    w[B // 2:] = 0.0                   # the second data rank's rows
    return feats, tgt, w


def _egs():
    rng = np.random.RandomState(3)
    N = 40
    return {"feats": rng.randn(N, 8, CFG["feat_dim"]).astype(np.float32),
            "targets": rng.randint(0, CFG["num_pdfs"], (N, 4)).astype(np.int32),
            "weights": (rng.rand(N, 4) > 0.2).astype(np.float32)}


WORKER = r'''
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                        make_train_step, shard_params,
                                        train_epochs)
from kaldi_tpu_torch.params import tdnn_params_from_jax
from kaldi_tpu_torch.parallel.mesh import make_mesh, axis_index
out = {}
for shape in ARGS["shapes"]:
    mesh = make_mesh(*shape, device="cpu")
    model = Tdnn(TdnnConfig(**ARGS["cfg"]))
    params = tdnn_params_from_jax(ARGS["tree"])
    opt = make_optimizer(NnetTrainOpts(**ARGS["opts"]), ARGS["steps"])
    state = opt.init(params)
    step = make_train_step(model, opt, mesh=mesh)
    batch = [torch.from_numpy(a) for a in ARGS["batch"]]
    losses, accs = [], []
    for _ in range(ARGS["steps"]):
        params, state, loss, acc = step(params, state, *batch)
        losses.append(float(loss))
        accs.append(float(acc))
    local, _place = shard_params(tdnn_params_from_jax(ARGS["tree"]), mesh)
    res = {"losses": losses, "accs": accs,
           "params": {k: v.numpy() for k, v in params.items()},
           "shards": {k: v.numpy() for k, v in local.items()},
           "coords": (axis_index(mesh, "data"), axis_index(mesh, "model"))}
    if ARGS["egs"] is not None and shape[1] == 1:
        p, hist = train_epochs(model, tdnn_params_from_jax(ARGS["tree"]),
                               ARGS["egs"], NnetTrainOpts(**ARGS["epochs"]),
                               mesh=mesh, rng=np.random.RandomState(5),
                               log_every=1, device="cpu")
        res["epochs"] = ({k: v.numpy() for k, v in p.items()}, hist)
    out[shape] = res
save(out)
'''


def _args(shapes, egs):
    return {"shapes": shapes, "cfg": CFG, "tree": _init_tree(),
            "opts": OPTS, "steps": STEPS, "batch": _batch(), "egs": egs,
            "epochs": EPOCHS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{shape: [each rank's result]} for the three meshes."""
    tmp = tmp_path_factory.mktemp("train")
    two = run_gang(tmp, "two", WORKER, 2, _args([(2, 1), (1, 2)], _egs()))
    four = run_gang(tmp, "four", WORKER, 4, _args([(2, 2)], None))
    out = {s: [r[s] for r in two] for s in [(2, 1), (1, 2)]}
    out[(2, 2)] = [r[(2, 2)] for r in four]
    return out


def _leaves(tree, prefix=""):
    """JAX pytree -> {state-dict name: leaf}."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _flat(tree):
    return {k: np.asarray(v) for k, v in _leaves(tree).items()}


def _jax_mesh_run(shape):
    D = shape[0] * shape[1]
    mesh = j_make_mesh(data=shape[0], model=shape[1],
                       devices=jax.devices()[:D])
    params, _ = j_shard_params(
        jax.tree_util.tree_map(jnp.asarray, _init_tree()), mesh)
    opt = j_make_optimizer(JOpts(**OPTS), STEPS)
    state = opt.init(params)
    step = j_make_train_step(JTdnn(JTdnnConfig(**CFG)), opt, mesh)
    feats, tgt, w = _batch()
    args = [jax.device_put(a, j_batch_sharding(mesh, a.ndim))
            for a in (feats, tgt, w)]
    losses, accs = [], []
    for _ in range(STEPS):
        params, state, loss, acc = step(params, state, *args)
        losses.append(float(loss))
        accs.append(float(acc))
    return losses, accs, _flat(params)


def _port_single():
    params = tdnn_params_from_jax(_init_tree())
    opt = ttrain.make_optimizer(ttrain.NnetTrainOpts(**OPTS), STEPS)
    state = opt.init(params)
    step = ttrain.make_train_step(Tdnn(TdnnConfig(**CFG)), opt)
    batch = [torch.from_numpy(a) for a in _batch()]
    losses, accs = [], []
    for _ in range(STEPS):
        params, state, loss, acc = step(params, state, *batch)
        losses.append(float(loss))
        accs.append(float(acc))
    return losses, accs, {k: v.numpy() for k, v in params.items()}


def _close(a: dict, b: dict, what: str):
    assert a.keys() == b.keys(), what
    for k in a:
        scale = max(float(np.abs(b[k]).max()), 1.0)
        err = float(np.abs(a[k] - b[k]).max())
        assert err <= TOL * scale, (what, k, err)


def _fingerprint(p: dict) -> float:
    return float(sum(np.abs(v).sum() for v in p.values()))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_mesh_step_matches_jax_and_single(ranks, shape):
    res = ranks[shape]
    M = shape[1]
    assert [r["coords"] for r in res] == [(i // M, i % M)
                                          for i in range(len(res))]
    single = _port_single()
    jl, ja, jp = _jax_mesh_run(shape)
    for r in res:
        for ref, what in ((res[0], "rank 0"), (single, "single"),
                          ((jl, ja, jp), "jax")):
            rl, ra, rp = ((ref["losses"], ref["accs"], ref["params"])
                          if isinstance(ref, dict) else ref)
            np.testing.assert_allclose(r["losses"], rl, rtol=TOL, atol=0,
                                       err_msg=what)
            np.testing.assert_allclose(r["accs"], ra, rtol=TOL, atol=TOL,
                                       err_msg=what)
            _close(r["params"], rp, what)
            assert _fingerprint(r["params"]) == pytest.approx(
                _fingerprint(rp), rel=TOL), what
    # a DDP-style mean of per-rank losses would differ: rank 1's rows are
    # all weight 0, so the global normaliser is the first half's sum
    assert single[0][0] == pytest.approx(res[0]["losses"][0], rel=TOL)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_shard_params_match_jax_shards(ranks, shape):
    """Rank r's shard of each carried-across param equals the slice of
    JAX's param that tdnn_param_sharding puts on device r."""
    D = shape[0] * shape[1]
    mesh = j_make_mesh(data=shape[0], model=shape[1],
                       devices=jax.devices()[:D])
    jparams, _ = j_shard_params(
        jax.tree_util.tree_map(jnp.asarray, _init_tree()), mesh)
    leaves = _leaves(jparams)
    for rank, r in enumerate(ranks[shape]):
        dev = mesh.devices.flat[rank]
        for name, arr in leaves.items():
            (shard,) = [s for s in arr.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(r["shards"][name],
                                          np.asarray(shard.data), err_msg=name)
        w = r["shards"]["final.w"]
        assert w.shape == (16, CFG["num_pdfs"] // shape[1])


def test_train_epochs_on_a_mesh(ranks):
    """train_epochs(mesh=(2, 1)) on both ranks == JAX's train_epochs on its
    (2, 1) mesh == the port's single-process train_epochs."""
    egs = _egs()
    j_mesh = j_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    jp, jhist = j_train_epochs(
        JTdnn(JTdnnConfig(**CFG)),
        jax.tree_util.tree_map(jnp.asarray, _init_tree()), egs,
        JOpts(**EPOCHS), mesh=j_mesh, rng=np.random.RandomState(5),
        log_every=1)
    sp, shist = ttrain.train_epochs(
        Tdnn(TdnnConfig(**CFG)), tdnn_params_from_jax(_init_tree()), egs,
        ttrain.NnetTrainOpts(**EPOCHS), rng=np.random.RandomState(5),
        log_every=1, device="cpu")
    sp = {k: v.numpy() for k, v in sp.items()}
    for r in ranks[(2, 1)]:
        p, hist = r["epochs"]
        assert [h[:2] for h in hist] == [h[:2] for h in jhist]
        for ref in (jhist, shist):
            np.testing.assert_allclose([h[2:] for h in hist],
                                       [h[2:] for h in ref], rtol=TOL,
                                       atol=TOL)
        _close(p, _flat(jp), "jax")
        _close(p, sp, "single")


def test_one_rank_mesh_in_process_equals_no_mesh():
    """A (1, 1) mesh made in this process (a world of one over gloo, as
    init_distributed's one-process no-op leaves it to make_mesh) trains
    to the same params and losses as the step without a mesh."""
    from kaldi_tpu_torch.parallel.mesh import make_mesh
    try:
        mesh = make_mesh(1, 1, device="cpu")
        params = tdnn_params_from_jax(_init_tree())
        opt = ttrain.make_optimizer(ttrain.NnetTrainOpts(**OPTS), STEPS)
        step = ttrain.make_train_step(Tdnn(TdnnConfig(**CFG)), opt,
                                      mesh=mesh)
        state = opt.init(params)
        batch = [torch.from_numpy(a) for a in _batch()]
        losses = []
        for _ in range(STEPS):
            params, state, loss, _acc = step(params, state, *batch)
            losses.append(float(loss))
    finally:
        dist.destroy_process_group()
    sl, _sa, sp = _port_single()
    assert losses == sl
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), sp[k], err_msg=k)


TDNN_WORKER = r'''
import chip_smoke as cs
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
from kaldi_tpu_torch.nnet.train import NnetTrainOpts
from kaldi_tpu_torch.parallel.mesh import make_mesh
from kaldi_tpu_torch.steps.mono import MonoTrainOpts, train_mono
from kaldi_tpu_torch.steps.tdnn import train_tdnn
lang = prepare_lang(Lexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                    num_sil_states=3)
mono = train_mono(lang, ARGS["utts"], MonoTrainOpts(
    num_iters=6, totgauss=30, max_iter_inc=4,
    realign_iters=tuple(range(1, 6))), device="cpu")
config = TdnnConfig(feat_dim=0, num_pdfs=0, hidden_dim=32,
                    pnorm_output_dim=8, nonlinearity="relu",
                    splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
out = {}
for name, mesh in (("mesh", make_mesh(2, 1, device="cpu")), ("none", None)):
    res = train_tdnn(mono, ARGS["utts"], config=config,
                     train_opts=NnetTrainOpts(num_epochs=2), mesh=mesh,
                     seed=3)
    out[name] = ({k: v.numpy() for k, v in res.am.model.state_dict().items()},
                 res.history, np.asarray(res.am.priors))
save(out)
'''


def test_train_tdnn_on_a_mesh(tmp_path):
    """train_tdnn passes its mesh to train_epochs: on a (2, 1) mesh of two
    ranks it trains the net it trains without a mesh (same monophone,
    same seed), with the same history and priors on both ranks."""
    import chip_smoke as cs
    rng = np.random.RandomState(8)
    utts = []
    for i in range(12):
        ws = [str(rng.choice(["YES", "NO"])) for _ in range(rng.randint(2, 5))]
        utts.append((f"u{i}", cs.mfcc_deltas(cs.yesno_synth(ws, rng), "cpu"),
                     ws))
    out = run_gang(tmp_path, "tdnn", TDNN_WORKER, 2, {"utts": utts})
    for r in out:
        mp, mh, mpri = r["mesh"]
        sp, sh, spri = r["none"]
        _close(mp, sp, "mesh vs none")
        _close(mp, out[0]["mesh"][0], "rank vs rank 0")
        assert [h[:2] for h in mh] == [h[:2] for h in sh]
        np.testing.assert_allclose([h[2:] for h in mh], [h[2:] for h in sh],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(mpri, spri)
