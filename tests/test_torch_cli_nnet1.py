"""Port parity: the CLI's fourth slice, nnet1 (kaldi_tpu_torch/cli.py and
the nnet1 commands of cli_tail.py) against kaldi_tpu's CLI, on the CPU,
over files that JAX wrote (`nnet1_system`: tests/test_gmmbin_cli.py's
`_tiny_corpus` of 12 yesno utterances, JAX's train-mono model, its
alignments as pdfs, graph and raw lattices, global CMVN statistics, a
JAX-initialised sigmoid net, RBM and LSTM files).
- Host commands write JAX's bytes and print JAX's lines: nnet-info,
  nnet-copy, nnet-concat, rbm-convert-to-nnet, cmvn-to-nnet,
  transf-to-nnet (plain and --affine), nnet-kl-hmm-acc,
  nnet-kl-hmm-sum-accs, nnet-kl-hmm-mat-to-component.
- nnet-initialize draws from a torch.Generator: held by outcome, JAX's
  proto, shapes and zero leaves, each drawn leaf's stddev within
  `std_ratio_ok`'s bound of JAX's draw.
- nnet-forward (exp, --apply-log, --class-frame-counts) within 1e-5
  (tests/test_torch_nnet1.py's forward bound).
- nnet-train-frmshuff from JAX's init: every leaf within 1e-5 of its
  largest |value| (chip_smoke.TRAIN_LIMITS["f32"], JAX's shuffles).
- rbm-train-cd1-frmshuff draws its hidden samples from a
  torch.Generator; handed JAX's draws (its key sequence, replayed here)
  the port's RBM file is within 1e-5 of each array's largest |value|
  (the CD-1 update is a function of the sample, `Rbm.cd1_update`). With its
  own draws: held by outcome, the reconstruction error falls.
- nnet-train-lstm-streams and -blstm-streams from JAX's file: within
  1e-5 of each leaf's largest |value| (tests/test_torch_nnet1.py's
  train_lstm_streams bound); from `init`: held by outcome (JAX's
  structure and shapes, std_ratio_ok, JAX loads the file).
- nnet-train-mmi-sequential and -mpe-sequential rescore the lattices
  with the net's outputs and step on lattice posteriors: the parameter
  update within 1e-3 of its largest |value|, and the printed objective
  within 1e-4 of its magnitude, the bound that the outputs' 1e-5
  difference (acoustic scale 0.1) sets on the posteriors, summed over
  the corpus.
- The port alone runs steps/nnet/pretrain_dbn.sh -> train.sh ->
  decode.sh through its files at a tiny width: each RBM's
  reconstruction error falls, fine-tuning raises the frame accuracy,
  and latgen-faster-mapped decodes every utterance (its WER is
  reported, as phase 39's is).
"""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark
from test_gmmbin_cli import _tiny_corpus
from test_torch_cli_features import (run_both, same_arks, same_bytes,
                                     tol)
from test_torch_cli_gmm import rel_close, same_files, same_leaves
from test_torch_cli_nnet2 import SEARCH, jok, std_ratio_ok, tok

torch.set_num_threads(2)

FWD = dict(rtol=1e-5, atol=1e-5)     # tests/test_torch_nnet1.py
TRAIN_REL = 1e-5        # chip_smoke.TRAIN_LIMITS["f32"]
SEQ_UPDATE_REL = 1e-3   # the sequence trainers' update (docstring)
HIDDEN = 24


def proto(*layers) -> str:
    """An nnet1 proto from (kind, in, out[, build vector]) rows."""
    rows = ["<NnetProto>"]
    for kind, i, o, *extra in layers:
        rows.append(f"<{kind}> <InputDim> {i} <OutputDim> {o}"
                    + (f" <BuildVector> {extra[0]}" if extra else ""))
    return "\n".join(rows + ["</NnetProto>"]) + "\n"


def nnet1_system(root):
    """JAX-written inputs -> P(name) -> path."""
    _tiny_corpus(root, n_utts=12, seed=7)
    P = lambda *n: str(root.joinpath(*n))                    # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    for argv in (
            ["train-mono", P("lexicon.txt"), P("text"), feats, P("mono.npz"),
             "--num-iters", "6", "--totgauss", "40"],
            ["gmm-align", P("mono.npz"), P("text"), feats,
             f"ark:{P('ali.ark')}"],
            ["ali-to-pdf", P("mono.npz"), f"ark:{P('ali.ark')}",
             f"ark:{P('pdf.ark')}"],
            ["analyze-counts", f"ark:{P('pdf.ark')}", P("counts.ark")],
            ["mkgraph", P("mono.npz"), P("lm.arpa"), P("hclg.npz")],
            ["gmm-latgen-faster", P("mono.npz"), P("hclg.npz"), feats,
             "--lattice-out", P("lat.ark")] + SEARCH,
            ["compute-cmvn-stats", feats, f"ark:{P('cmvn.ark')}"]):
        jok(argv)
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    pdfs = load_gmm_system(P("mono.npz"), device="cpu").am.num_pdfs
    with open(P("net.proto"), "w") as f:
        f.write(proto(("AffineTransform", 39, HIDDEN),
                      ("Sigmoid", HIDDEN, HIDDEN),
                      ("AffineTransform", HIDDEN, pdfs),
                      ("Softmax", pdfs, pdfs)))
    rng = np.random.RandomState(0)
    write_ark(P("transf.ark"), {"m": rng.randn(5, 39).astype(np.float32)})
    write_ark(P("affine.ark"), {"m": rng.randn(5, 40).astype(np.float32)})
    for argv in (
            ["nnet-initialize", P("net.proto"), P("init.nnet")],
            ["nnet-forward", P("init.nnet"), feats, f"ark:{P('post.ark')}"],
            ["rbm-train-cd1-frmshuff", feats, P("rbm.npz"), "--hidden-dim",
             "16", "--num-epochs", "1", "--minibatch-size", "64"],
            ["nnet-train-lstm-streams", feats, f"ark:{P('pdf.ark')}",
             "init", P("lstm0.npz"), "--cell-dim", "8", "--proj-dim", "4",
             "--num-epochs", "1"],
            ["nnet-train-blstm-streams", feats, f"ark:{P('pdf.ark')}",
             "init", P("blstm0.npz"), "--cell-dim", "6", "--proj-dim", "4",
             "--num-epochs", "1"],
            ["nnet-kl-hmm-acc", f"ark:{P('post.ark')}",
             f"ark:{P('pdf.ark')}", P("kl.npz"), "--num-states",
             str(pdfs)]):
        jok(argv)
    write_ark(P("klmat.ark"), {"m": np.load(P("kl.npz"))["counts"]
                               .astype(np.float32)})
    return P


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    return nnet1_system(tmp_path_factory.mktemp("nnet1_sys"))


def _run(sysd, tmp, argv_fn, device=False):
    return run_both(str(tmp), lambda O: argv_fn(sysd, O), device)


def _o(O, *n):
    return os.path.join(O, *n)


HOST_CASES = {
    "nnet-info": lambda P, O: ["nnet-info", P("init.nnet")],
    "nnet-copy": lambda P, O: ["nnet-copy", P("init.nnet"), _o(O, "c")],
    "nnet-concat": lambda P, O: [
        "nnet-concat", _o(O, "c"), P("init.nnet"), P("init.nnet")],
    "rbm-convert-to-nnet": lambda P, O: [
        "rbm-convert-to-nnet", P("rbm.npz"), _o(O, "r.nnet")],
    "cmvn-to-nnet": lambda P, O: [
        "cmvn-to-nnet", f"ark:{P('cmvn.ark')}", _o(O, "c.nnet")],
    "transf-to-nnet": lambda P, O: [
        "transf-to-nnet", P("transf.ark"), _o(O, "t.nnet")],
    "transf-to-nnet --affine": lambda P, O: [
        "transf-to-nnet", P("affine.ark"), _o(O, "t.nnet"), "--affine"],
    "nnet-kl-hmm-acc": lambda P, O: [
        "nnet-kl-hmm-acc", f"ark:{P('post.ark')}", f"ark:{P('pdf.ark')}",
        _o(O, "kl.npz"), "--num-states", "40"],
    "nnet-kl-hmm-sum-accs": lambda P, O: [
        "nnet-kl-hmm-sum-accs", _o(O, "s.npz"), P("kl.npz"), P("kl.npz")],
    "nnet-kl-hmm-mat-to-component": lambda P, O: [
        "nnet-kl-hmm-mat-to-component", _o(O, "c.npz"), P("klmat.ark")],
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_commands_write_jax_bytes(sysd, tmp_path, name):
    same_bytes(_run(sysd, tmp_path, HOST_CASES[name]))


def test_kl_hmm_component_loads_in_both_packages(sysd, tmp_path):
    """The port's KL-HMM component unpickles in JAX and in the port."""
    import pickle
    from kaldi_tpu_torch.io.model_io import _loads
    tok(["nnet-kl-hmm-mat-to-component", str(tmp_path / "c.npz"),
         sysd("klmat.ark")], device=False)
    blob = np.load(tmp_path / "c.npz")["__host__"].tobytes()
    want = np.load(sysd("kl.npz"))["counts"].astype(np.float32)
    assert np.array_equal(pickle.loads(blob).counts, want)
    assert np.array_equal(_loads(blob).counts, want)


def test_initialize_matches_jax_by_outcome(sysd, tmp_path):
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet-initialize", P("net.proto"), _o(O, "n"), "--seed", "9"])
    (jd, jout, jc), (td, tout, tc) = res["jax"], res["port"]
    assert jc == tc == 0 and jout == tout
    zj, zt = np.load(_o(jd, "n")), np.load(_o(td, "n"))
    assert zj.files == zt.files
    for k in zj.files:
        assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
        if zj[k].dtype.kind == "f" and zj[k].std() > 0:
            assert std_ratio_ok(zt[k], zj[k]), k
        else:
            assert np.array_equal(zt[k], zj[k]), k


@pytest.mark.parametrize("mode", ["exp", "log", "priors"])
def test_forward_within_bound(sysd, tmp_path, mode):
    extra = {"exp": [], "log": ["--apply-log"],
             "priors": ["--apply-log", "--class-frame-counts",
                        sysd("counts.ark")]}[mode]
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet-forward", P("init.nnet"), f"ark:{P('feats.ark')}",
        f"ark:{_o(O, 'y.ark')}"] + extra, device=True)
    same_arks(res, "y.ark", tol(**FWD))


def test_train_frmshuff_matches_jax_step_for_step(sysd, tmp_path):
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet-train-frmshuff", P("init.nnet"), f"ark:{P('feats.ark')}",
        f"ark:{P('pdf.ark')}", _o(O, "t.nnet"), "--num-epochs", "2",
        "--minibatch-size", "64", "--learn-rate", "0.02", "--momentum",
        "0.5", "--seed", "3"], device=True)
    same_files(res, close=rel_close(TRAIN_REL), printed=False)


def _jax_hidden_samples(monkeypatch, seed: int):
    """Make the port's Rbm draw JAX's hidden samples: the key sequence of
    JAX's rbm-train-cd1-frmshuff handler (PRNGKey(seed), one split per
    minibatch), each uniform compared with the port's P(h|v)."""
    import jax
    from kaldi_tpu_torch.nnet1 import rbm as trbm
    state = {"key": jax.random.PRNGKey(seed)}

    def sample_hidden(self, h_pos, generator):
        state["key"], sub = jax.random.split(state["key"])
        u = np.asarray(jax.random.uniform(sub, tuple(h_pos.shape)))
        return (torch.as_tensor(u, device=h_pos.device)
                < h_pos).to(torch.float32)

    monkeypatch.setattr(trbm.Rbm, "sample_hidden", sample_hidden)


def test_rbm_train_matches_jax_given_its_samples(sysd, tmp_path,
                                                 monkeypatch):
    _jax_hidden_samples(monkeypatch, seed=5)
    res = _run(sysd, tmp_path, lambda P, O: [
        "rbm-train-cd1-frmshuff", f"ark:{P('feats.ark')}", _o(O, "r.npz"),
        "--hidden-dim", "16", "--num-epochs", "2", "--minibatch-size", "64",
        "--seed", "5"], device=True)
    same_files(res, close=rel_close(TRAIN_REL), printed=False)


def recon_mse(rbm_file: str, feats, seed: int | None = None) -> float:
    """Mean-field reconstruction error of an RBM over a [N, V] matrix: of
    the file's weights, or (seed) of the init that the training command
    starts from."""
    from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
    z = np.load(rbm_file)
    H, V = z["W"].shape
    rbm = Rbm(RbmConfig(V, H), seed=seed or 0, device="cpu")
    if seed is None:
        rbm.W, rbm.vis_bias, rbm.hid_bias = (
            torch.as_tensor(z[k]) for k in ("W", "vis_bias", "hid_bias"))
    v = torch.as_tensor(feats)
    return float(torch.mean((rbm.reconstruct(rbm.propagate(v)) - v) ** 2))


def test_rbm_train_own_draws_lower_the_reconstruction_error(sysd, tmp_path):
    tok(["rbm-train-cd1-frmshuff", f"ark:{sysd('feats.ark')}",
         str(tmp_path / "r.npz"), "--hidden-dim", "16", "--num-epochs", "2",
         "--minibatch-size", "64", "--seed", "5"])
    X = np.concatenate([v for _k, v in read_ark(sysd("feats.ark"))])
    assert recon_mse(str(tmp_path / "r.npz"), X) < \
        recon_mse(str(tmp_path / "r.npz"), X, seed=5)


LSTM = ["--num-epochs", "1", "--num-streams", "3", "--bptt-chunk", "7",
        "--learn-rate", "0.005"]


@pytest.mark.parametrize("name,init", [
    ("nnet-train-lstm-streams", "lstm0.npz"),
    ("nnet-train-blstm-streams", "blstm0.npz")])
def test_lstm_streams_from_jax_file_match_jax(sysd, tmp_path, name, init):
    res = _run(sysd, tmp_path, lambda P, O: [
        name, f"ark:{P('feats.ark')}", f"ark:{P('pdf.ark')}", P(init),
        _o(O, "l.npz")] + LSTM, device=True)
    (jd, jout, jc), (td, tout, tc) = res["jax"], res["port"]
    assert jc == tc == 0
    _same_lstm(_o(td, "l.npz"), _o(jd, "l.npz"),
               lambda g, w, k: rel_close(TRAIN_REL)(k, g, w))


def _lstm_tree(path):
    import pickle
    z = np.load(path)
    return pickle.loads(z["__host__"].tobytes())


def _same_lstm(got_path, want_path, close):
    """Two lstm1 files: JAX's header (config, pdfs, layers, direction)
    and every parameter within close(got, want, name)."""
    import jax
    g, w = _lstm_tree(got_path), _lstm_tree(want_path)
    assert type(g[0]).__module__ == "kaldi_tpu.nnet1.lstm"
    assert g[0] == w[0] and g[1:4] == w[1:4]
    gl = jax.tree_util.tree_leaves_with_path(g[4])
    wl = jax.tree_util.tree_leaves_with_path(w[4])
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (p, a), (_p, b) in zip(gl, wl):
        assert a.shape == b.shape and a.dtype == b.dtype, p
        close(a, b, jax.tree_util.keystr(p))


@pytest.mark.parametrize("name", ["nnet-train-lstm-streams",
                                  "nnet-train-blstm-streams"])
def test_lstm_streams_init_matches_jax_by_outcome(sysd, tmp_path, name):
    res = _run(sysd, tmp_path, lambda P, O: [
        name, f"ark:{P('feats.ark')}", f"ark:{P('pdf.ark')}", "init",
        _o(O, "l.npz"), "--cell-dim", "32", "--proj-dim", "16",
        "--num-epochs", "0"], device=True)
    (jd, _jo, jc), (td, _to, tc) = res["jax"], res["port"]
    assert jc == tc == 0

    def close(g, w, k):
        if w.std() > 0:
            assert std_ratio_ok(g, w), k
        else:
            assert np.array_equal(g, w), k
    _same_lstm(_o(td, "l.npz"), _o(jd, "l.npz"), close)


@pytest.mark.parametrize("name", ["nnet-train-mmi-sequential",
                                  "nnet-train-mpe-sequential"])
def test_sequential_within_the_posteriors_bound(sysd, tmp_path, name):
    res = _run(sysd, tmp_path, lambda P, O: [
        name, P("init.nnet"), P("mono.npz"), f"ark:{P('feats.ark')}",
        P("lat.ark"), f"ark:{P('ali.ark')}", _o(O, "s.nnet"),
        "--learn-rate", "0.01"], device=True)
    (jd, jout, jc), (td, tout, tc) = res["jax"], res["port"]
    assert jc == tc == 0
    z0 = np.load(sysd("init.nnet"))
    zj, zt = np.load(_o(jd, "s.nnet")), np.load(_o(td, "s.nnet"))
    same_leaves(zj, zt)
    for k in zj.files:
        if zj[k].dtype.kind != "f":
            assert np.array_equal(zt[k], zj[k]), k
            continue
        step = zj[k] - z0[k]
        assert np.abs((zt[k] - z0[k]) - step).max() <= SEQ_UPDATE_REL * max(
            np.abs(step).max(), 1e-30), k
    want = float(jout.split("objf/frame")[1])
    assert float(tout.split("objf/frame")[1]) == pytest.approx(
        want, rel=1e-4, abs=1e-4)


def test_dbn_recipe_through_the_port_files(sysd, tmp_path):
    """steps/nnet/pretrain_dbn.sh -> train.sh -> decode.sh through the
    port's files: splice +-2 and global CMVN as the feature transform,
    two RBMs of width 32 (each reconstruction error falls), the softmax
    top, nnet-concat, frame-shuffled fine-tuning (the frame accuracy
    rises), nnet-forward with the alignment counts' priors,
    latgen-faster-mapped on every utterance."""
    P = sysd
    W = lambda *n: str(tmp_path.joinpath(*n))                # noqa: E731
    mfcc = f"ark:{P('mfcc.ark')}"
    pdfs = int(np.load(P("kl.npz"))["counts"].shape[0])
    with open(W("splice.proto"), "w") as f:
        f.write(proto(("Splice", 13, 65, "-2:-1:0:1:2")))
    tok(["nnet-initialize", W("splice.proto"), W("splice.nnet")],
        device=False)
    tok(["nnet-forward", W("splice.nnet"), mfcc, f"ark:{W('sp.ark')}",
         "--apply-log"])
    tok(["compute-cmvn-stats", f"ark:{W('sp.ark')}", f"ark:{W('cmvn.ark')}"],
        device=False)
    tok(["cmvn-to-nnet", f"ark:{W('cmvn.ark')}", W("cmvn.nnet")],
        device=False)
    tok(["nnet-concat", W("ft.nnet"), W("splice.nnet"), W("cmvn.nnet")],
        device=False)
    tok(["nnet-forward", W("ft.nnet"), mfcc, f"ark:{W('l0.ark')}",
         "--apply-log"])
    layer_in, stack = "l0.ark", ["ft.nnet"]
    for i in (1, 2):
        tok(["rbm-train-cd1-frmshuff", f"ark:{W(layer_in)}",
             W(f"rbm{i}.npz"), "--hidden-dim", "32", "--num-epochs", "3",
             "--minibatch-size", "32", "--learn-rate", "0.01",
             "--seed", str(i)])
        X = np.concatenate([v for _k, v in read_ark(W(layer_in))])
        assert recon_mse(W(f"rbm{i}.npz"), X) < recon_mse(
            W(f"rbm{i}.npz"), X, seed=i), f"RBM {i}"
        tok(["rbm-convert-to-nnet", W(f"rbm{i}.npz"), W(f"rbm{i}.nnet")],
            device=False)
        stack.append(f"rbm{i}.nnet")
        tok(["nnet-concat", W("stack.nnet")] + [W(s) for s in stack],
            device=False)
        layer_in = f"l{i}.ark"
        tok(["nnet-forward", W("stack.nnet"), mfcc, f"ark:{W(layer_in)}",
             "--apply-log"])
    with open(W("top.proto"), "w") as f:
        f.write(proto(("AffineTransform", 32, pdfs), ("Softmax", pdfs, pdfs)))
    tok(["nnet-initialize", W("top.proto"), W("top.nnet")], device=False)
    tok(["nnet-concat", W("dbn0.nnet"), W("rbm1.nnet"), W("rbm2.nnet"),
         W("top.nnet")], device=False)
    tok(["nnet-train-frmshuff", W("dbn0.nnet"), f"ark:{W('l0.ark')}",
         f"ark:{P('pdf.ark')}", W("dbn.nnet"), "--num-epochs", "10",
         "--learn-rate", "1.0", "--minibatch-size", "64"])
    assert frame_accuracy(W("dbn.nnet"), W("l0.ark"), P("pdf.ark"),
                          tmp_path) > frame_accuracy(
        W("dbn0.nnet"), W("l0.ark"), P("pdf.ark"), tmp_path)
    tok(["nnet-concat", W("final.nnet"), W("ft.nnet"), W("dbn.nnet")],
        device=False)
    tok(["nnet-forward", W("final.nnet"), mfcc, f"ark:{W('ll.ark')}",
         "--apply-log", "--class-frame-counts", P("counts.ark")])
    hyp = tok(["latgen-faster-mapped", P("hclg.npz"), f"ark:{W('ll.ark')}"]
              + SEARCH)
    assert len(hyp.splitlines()) == 12


def frame_accuracy(nnet: str, feats: str, pdfs: str, tmp_path) -> float:
    """The share of frames whose argmax output is the aligned pdf."""
    out = str(tmp_path / "acc_post.ark")
    tok(["nnet-forward", nnet, f"ark:{feats}", f"ark:{out}", "--apply-log"])
    want = dict(read_ark(pdfs))
    hit = n = 0
    for k, y in read_ark(out):
        t = np.asarray(want[k], np.int64)
        hit += int((y.argmax(-1)[:len(t)] == t).sum())
        n += len(t)
    return hit / n
