"""Port parity: the CLI's last slice (5b), its 28 adaptation subcommands
(kaldi_tpu_torch/cli.py and cli_adapt.py) and their aliases against
kaldi_tpu's CLI, on the CPU, over files that JAX wrote.

The inputs are JAX-written once per module (`adapt_system`):
test_torch_cli_latgen.py's `lattice_system` (12 yesno utterances of MFCC
+ deltas, two speakers, JAX's mono model, graph, alignments, loglikes and
lattices) plus its posteriors, accumulators, a diagonal UBM, a regression
tree, an LVTLN file and warped features.
- Host commands (MAP update, the LVTLN init, the regression tree, mean
  transforms, global-GMM fMLLR, the arc graphs) write JAX's bytes and
  print JAX's lines; the regression tree's pickle included.
- The fMLLR family (gmm-est-fmllr, the LVTLN selections, regression-tree
  fMLLR, basis fMLLR) takes its gaussian posteriors from each package's
  own f32 GEMM, and each transform solves a system over a few hundred
  frames: each is held by its backward error, as ROADMAP §3 "Solves"
  holds them: the port's transform loses at most AUX_REL of the fMLLR
  auxiliary's gain over the identity that JAX's reaches on JAX's
  statistics, and the two differ by at most TRANS_REL of JAX's largest
  entry (`fmllr_close`).
- Statistics (MAP-adapted means, HLDA, the basis accumulators, the
  regression tree's MLLR rows) are within POST_REL of each array's
  largest magnitude: posterior-fed sums whose loglikes agree to 1e-5 of
  their GEMM terms (chip_smoke.gmm_term_scale).
- Decodes (regression-tree fMLLR / MLLR, n-best, MAP-adapted, tracking)
  write JAX's transcriptions.
- train-sat by outcome: JAX's pdf and gaussian counts and speakers, and
  the model decodes the corpus through the port's own graph at JAX's
  words.
test_adapt_cli.py's, test_transform_cli.py's and test_gmm_extra_cli.py's
adaptation cases, on the port.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.cli import main as jmain
from kaldi_tpu.io import model_io as jmio
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io import model_io as tmio
from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, read_ark, write_ark
from test_torch_cli_features import _call, run_both, same_bytes
from test_torch_cli_gmm import same_files
from test_torch_cli_latgen import lattice_system

torch.set_num_threads(2)

POST_REL = 1e-3      # posterior-fed statistics: of each array's largest
TRANS_REL = 2e-3     # an fMLLR-type transform: of JAX's largest entry
AUX_REL = 1e-3       # its auxiliary gain over the identity, relative


def adapt_system(root):
    """`lattice_system` plus JAX's posteriors, accumulators, a diagonal
    and a full UBM, a regression tree, an LVTLN file (identity classes)
    and a warped copy of the features. -> P(name) -> path."""
    P = lattice_system(root)
    feats = f"ark:{P('feats.ark')}"
    for argv in (
            ["ali-to-post", f"ark:{P('ali.ark')}", P("post.txt")],
            ["gmm-acc-stats-ali", P("mono.npz"), feats, f"ark:{P('ali.ark')}",
             P("acc.npz")],
            ["init-ubm", P("mono.npz"), P("acc.npz"), P("dubm.npz"),
             "--ubm-num-gauss", "8", "--fullcov-ubm", "false"],
            ["gmm-make-regtree", P("mono.npz"), P("regtree.npz"),
             "--max-leaves", "3"],
            ["gmm-init-lvtln", P("lvtln.npz"), "--dim", "39",
             "--warps", "0.9:1.0:1.1"]):
        assert _call(jmain, argv)[1] == 0, argv
    warped = {k: (v * np.linspace(0.9, 1.1, v.shape[1])[None])
              .astype(np.float32) for k, v in open_rspecifier(feats)}
    write_ark(P("warped.ark"), warped)
    return P


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    return adapt_system(tmp_path_factory.mktemp("adapt"))


def _o(d, n):
    return os.path.join(d, n)


def _spk(P):
    return ["--utt2spk", P("utt2spk")]


DECODE = ["--beam", "14", "--max-active", "64", "--lattice-beam", "7"]


def _arks(res, name) -> tuple:
    """-> ({key: JAX's matrix}, {key: the port's}) of the ark `name`,
    keys, shapes and dtypes equal, exit codes 0."""
    (jd, _jo, jcode), (td, _to, tcode) = res["jax"], res["port"]
    assert jcode == tcode == 0
    want, got = (dict(read_ark(_o(d, name))) for d in (jd, td))
    assert list(got) == list(want) and want
    for k in want:
        assert got[k].shape == want[k].shape
        assert got[k].dtype == want[k].dtype
    return want, got


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-300))


def stats_close(rel):
    """Within `rel` of the array's largest finite magnitude, the
    non-finite entries (a transition's -inf log-probability) equal."""
    def close(k, g, w):
        fin = np.isfinite(w)
        assert np.array_equal(g[~fin], w[~fin]), k
        assert _rel(g[fin], w[fin]) <= rel, k
    return close


def same_model(jf, tf, close):
    """Two model files: JAX's members, dtypes and shapes, the pickled host
    payload unpickled equal (chip_smoke.host_equal), float arrays within
    `close`, the rest equal."""
    za, zb = np.load(jf), np.load(tf)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        w, g = za[k], zb[k]
        assert g.dtype == w.dtype, k
        if k == "__host__":
            assert cs.host_equal(tmio._loads(g.tobytes()),
                                 tmio._loads(w.tobytes())), k
            continue
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            close(k, g, w)
        else:
            assert np.array_equal(g, w), k


# ------------------------------------------------------------ host commands

def _host_cases(P, d):
    feats = f"ark:{P('feats.ark')}"
    return {
        "gmm-est-map": ["gmm-est-map", P("mono.npz"), P("acc.npz"),
                        _o(d, "m.npz"), "--update-weights",
                        "--update-vars"],
        "gmm-init-lvtln": ["gmm-init-lvtln", _o(d, "l.npz"), "--dim", "13",
                           "--warps", "0.85:1.0:1.2"],
        "gmm-make-regtree": ["gmm-make-regtree", P("mono.npz"),
                             _o(d, "t.npz"), "--max-leaves", "5",
                             "--seed", "3"],
        "gmm-transform-means": ["gmm-transform-means", P("xf.ark"),
                                P("mono.npz"), _o(d, "m.npz")],
        "gmm-transform-means-global": ["gmm-transform-means-global",
                                       P("lin.ark"), P("mono.npz"),
                                       _o(d, "m.npz")],
        "gmm-est-fmllr-global": ["gmm-est-fmllr-global", P("dubm.npz"),
                                 feats, f"ark:{_o(d, 't.ark')}"] + _spk(P),
        "gmm-global-est-fmllr": ["gmm-global-est-fmllr", P("dubm.npz"),
                                 feats, f"ark:{_o(d, 't.ark')}",
                                 "--min-count", "1e6"],
    }


@pytest.fixture(scope="module")
def xfs(sysd):
    """An affine and a linear mean transform, JAX's regression-tree
    transforms (fMLLR and MLLR), its MAP-adapted models, its fMLLR basis,
    HLDA statistics and the first pass's arc graphs."""
    P = sysd
    rng = np.random.RandomState(5)
    A = np.eye(39) + 0.01 * rng.randn(39, 39)
    write_ark(P("xf.ark"), {"x": np.concatenate(
        [A, rng.randn(39, 1)], 1).astype(np.float32)})
    write_ark(P("lin.ark"), {"x": A.astype(np.float32)})
    feats = f"ark:{P('feats.ark')}"
    for argv in (
            ["gmm-est-regtree-fmllr", P("mono.npz"), P("regtree.npz"), feats,
             P("post.txt"), f"ark:{P('rt.ark')}", "--min-count", "50"]
            + _spk(P),
            ["gmm-est-regtree-mllr", P("mono.npz"), P("regtree.npz"), feats,
             P("post.txt"), f"ark:{P('rtm.ark')}", "--min-count", "50"]
            + _spk(P),
            ["gmm-adapt-map", P("mono.npz"), feats, P("post.txt"),
             P("mapdir")] + _spk(P),
            ["gmm-basis-fmllr-training", P("mono.npz"), feats,
             P("post.txt"), P("basis.npz"), "--basis-size", "20"] + _spk(P),
            ["gmm-acc-hlda", P("mono.npz"), feats, f"ark:{P('ali.ark')}",
             P("hlda.npz")],
            ["lattice-arcgraph", P("lat.ark"), P("arcs.ark")]):
        assert _call(jmain, argv)[1] == 0, argv
    return P


@pytest.mark.parametrize("name", sorted(_host_cases(lambda n: n, "")))
def test_host_command_writes_jax_files(xfs, tmp_path, name):
    """Host commands: JAX's files (model files array for array, their
    pickled host payload unpickled equal; the rest byte for byte) and
    JAX's printed lines."""
    res = run_both(str(tmp_path), lambda d: _host_cases(xfs, d)[name],
                   device=False)
    if name.startswith(("gmm-est-map", "gmm-transform")):
        same_files(res)
    else:
        same_bytes(res)


def test_regression_tree_file_both_ways(xfs, tmp_path):
    """The regression tree pickles as JAX's class with JAX's fields: JAX's
    plain pickle.loads reads the port's file into an equal tree, the port
    reads JAX's (no device in the file; the loader sets the CPU)."""
    P = xfs
    port = str(tmp_path / "t.npz")
    assert _call(tcli.main, ["gmm-make-regtree", P("mono.npz"), port,
                             "--max-leaves", "3"])[1] == 0
    blob = np.load(port)["__host__"].tobytes()
    assert blob == np.load(P("regtree.npz"))["__host__"].tobytes()
    jt = pickle.loads(blob)
    assert type(jt).__module__ == "kaldi_tpu.transform.regtree"
    assert "device" not in vars(jt)
    tt = tcli._load_regtree(P("regtree.npz"))
    assert type(tt).__module__ == "kaldi_tpu_torch.transform.regtree"
    assert tt.device == torch.device("cpu")
    assert cs.host_equal({k: v for k, v in vars(tt).items()
                          if k != "device"}, vars(jt))
    assert ("transform.regtree", "RegressionTree") in tmio.HOST_CLASSES


def test_lvtln_training_and_file_both_ways(xfs, tmp_path):
    """gmm-train-lvtln-special: JAX's printed line and file layout, the
    class matrix within 1e-9 of its largest entry (the same f64
    least-squares solve); LVTLN files (`A`, f64 `warps`) load in each
    package from the other's."""
    from kaldi_tpu import cli as jcli
    P = xfs
    res = run_both(str(tmp_path), lambda d: [
        "gmm-train-lvtln-special", "2", P("lvtln.npz"),
        f"ark:{P('feats.ark')}", f"ark:{P('warped.ark')}", _o(d, "l.npz")],
        device=True)
    same_files(res, close=stats_close(1e-9))
    port = _o(res["port"][0], "l.npz")
    jl = jcli._load_lvtln(port)
    tl = tcli._load_lvtln(P("lvtln.npz"))
    z = np.load(port)
    assert z["warps"].dtype == np.float64 and z["A"].dtype == np.float64
    np.testing.assert_array_equal(jl.A, z["A"])
    assert jl.warps == tl.warps == [0.9, 1.0, 1.1]
    np.testing.assert_array_equal(tl.A.numpy(), np.load(P("lvtln.npz"))["A"])


# ---------------------------------------------------------- fMLLR family

def _fmllr_cases(P, d):
    feats = f"ark:{P('feats.ark')}"
    t = f"ark:{_o(d, 't.ark')}"
    return {
        "gmm-est-fmllr": ["gmm-est-fmllr", P("mono.npz"), feats,
                          P("post.txt"), t, "--min-count", "50"] + _spk(P),
        "gmm-est-fmllr-gpost": ["gmm-est-fmllr-gpost", P("mono.npz"), feats,
                                P("post.txt"), t, "--min-count", "50"]
        + _spk(P),
        "gmm-est-lvtln-trans": ["gmm-est-lvtln-trans", P("mono.npz"),
                                P("lvtln.npz"), feats, P("post.txt"), t]
        + _spk(P),
        "gmm-global-est-lvtln-trans": ["gmm-global-est-lvtln-trans",
                                       P("dubm.npz"), P("lvtln.npz"), feats,
                                       t] + _spk(P),
        "gmm-est-regtree-fmllr": ["gmm-est-regtree-fmllr", P("mono.npz"),
                                  P("regtree.npz"), feats, P("post.txt"), t,
                                  "--min-count", "50"] + _spk(P),
        "gmm-est-regtree-fmllr-ali": ["gmm-est-regtree-fmllr-ali",
                                      P("mono.npz"), P("regtree.npz"), feats,
                                      f"ark:{P('ali.ark')}", t,
                                      "--min-count", "50"] + _spk(P),
        "gmm-est-basis-fmllr": ["gmm-est-basis-fmllr", P("mono.npz"),
                                P("basis.npz"), feats, P("post.txt"), t]
        + _spk(P),
        "gmm-est-basis-fmllr-gpost": ["gmm-est-basis-fmllr-gpost",
                                      P("mono.npz"), P("basis.npz"), feats,
                                      P("post.txt"), t] + _spk(P),
    }


def _jax_fmllr_stats(P):
    """JAX's own per-speaker FmllrStats of the fixture's posteriors."""
    from kaldi_tpu import cli as jcli
    return jcli._fmllr_stats_by_spk(jmio.load_gmm_system(P("mono.npz")),
                                    f"ark:{P('feats.ark')}", P("post.txt"),
                                    P("utt2spk"))


@pytest.mark.parametrize("name", sorted(_fmllr_cases(lambda n: n, "")))
def test_fmllr_family_within_its_backward_error(xfs, tmp_path, name):
    """The fMLLR-type transforms: JAX's printed lines and keys, each
    transform within TRANS_REL of JAX's largest entry; where the
    statistics are JAX's fMLLR statistics (gmm-est-fmllr and its alias,
    the basis estimates), the port's transform loses at most AUX_REL of
    the auxiliary's gain that JAX's transform reaches on them."""
    from kaldi_tpu.transform.fmllr import fmllr_auxf
    P = xfs
    res = run_both(str(tmp_path), lambda d: _fmllr_cases(P, d)[name],
                   device=True)
    assert res["jax"][1] == res["port"][1]
    want, got = _arks(res, "t.ark")
    for k in want:
        assert _rel(got[k], want[k]) <= TRANS_REL, k
    if "lvtln" in name or "regtree" in name:
        return
    stats = _jax_fmllr_stats(P)
    ident = np.concatenate([np.eye(39), np.zeros((39, 1))], 1)
    for k in want:
        base = fmllr_auxf(ident, stats[k])
        gain = fmllr_auxf(want[k].astype(np.float64), stats[k]) - base
        mine = fmllr_auxf(got[k].astype(np.float64), stats[k]) - base
        assert gain > 0 and mine >= gain - AUX_REL * gain, (k, mine, gain)


def test_regtree_mllr_adapted_means(xfs, tmp_path):
    """Regression-tree MLLR: each leaf's rows solve W_d (G_d + 1e-6) =
    k_d over the leaf's few gaussian means, whose span is all that the
    data determines; held by what a transform does, the adapted means
    W [mu; 1] of the leaf's gaussians, within POST_REL of their largest
    magnitude, and by the printed lines."""
    from kaldi_tpu.transform.regtree import unstack_transforms
    P = xfs
    res = run_both(str(tmp_path), lambda d: [
        "gmm-est-regtree-mllr", P("mono.npz"), P("regtree.npz"),
        f"ark:{P('feats.ark')}", P("post.txt"), f"ark:{_o(d, 't.ark')}",
        "--min-count", "50"] + _spk(P), device=True)
    assert res["jax"][1] == res["port"][1]
    want, got = _arks(res, "t.ark")
    tree = pickle.loads(np.load(P("regtree.npz"))["__host__"].tobytes())
    xi = np.concatenate([tree.means, np.ones((len(tree.means), 1))], 1)
    for k in want:
        wl = unstack_transforms(tree, want[k], 39)
        gl = unstack_transforms(tree, got[k], 39)
        for leaf in wl:
            sel = tree.gauss2leaf == leaf
            mw, mg = xi[sel] @ wl[leaf].T, xi[sel] @ gl[leaf].T
            assert _rel(mg, mw) <= POST_REL, (k, leaf)


def test_basis_training_spans_jax_directions(xfs, tmp_path):
    """gmm-basis-fmllr-training: the basis is the leading eigenvectors of
    the preconditioned gradient scatter, whose near-equal eigenvalues
    leave the vectors free to rotate; held by JAX's shapes and printed
    line, and each port vector's Rayleigh quotient under JAX's scatter
    (b' S b over b' H b, from JAX's accumulators) within POST_REL of
    JAX's vector's."""
    P = xfs
    res = run_both(str(tmp_path), lambda d: [
        "gmm-basis-fmllr-training", P("mono.npz"), f"ark:{P('feats.ark')}",
        P("post.txt"), _o(d, "b.npz"), "--basis-size", "20"] + _spk(P),
        device=True)
    assert res["jax"][1:] == res["port"][1:]
    acc = str(tmp_path / "acc.npz")
    assert _call(jmain, ["gmm-basis-fmllr-accs", P("mono.npz"),
                         f"ark:{P('feats.ark')}", P("post.txt"), acc]
                 + _spk(P))[1] == 0
    z = np.load(acc)
    S, H = z["grad_scatter"], z["H"] / float(z["beta"])
    (jd, _j, _c), (td, _t, _c2) = res["jax"], res["port"]
    qs = []
    for d in (jd, td):
        B = np.load(_o(d, "b.npz"))["basis"]
        assert B.dtype == np.float64 and B.shape == (20, 39, 40)
        V = B.reshape(20, -1)
        qs.append(np.einsum("ki,ij,kj->k", V, S, V)
                  / np.einsum("ki,ij,kj->k", V, H, V))
    assert _rel(qs[1], qs[0]) <= POST_REL


# ------------------------------------------------------------- statistics

def test_map_adaptation_within_posterior_bound(xfs, tmp_path):
    """gmm-adapt-map: one JAX model file per speaker, each array of JAX's
    dtype and shape, the adapted means within POST_REL (posterior-fed
    sums), the rest JAX's; JAX loads the port's."""
    P = xfs
    res = run_both(str(tmp_path), lambda d: [
        "gmm-adapt-map", P("mono.npz"), f"ark:{P('feats.ark')}",
        P("post.txt"), _o(d, "mapdir"), "--mean-tau", "5"] + _spk(P),
        device=True)
    same_files(res, close=stats_close(POST_REL))
    for spk in ("spk0", "spk1"):
        f = _o(res["port"][0], f"mapdir/{spk}.npz")
        assert jmio.load_gmm_system(f).am.num_pdfs == \
            tmio.load_gmm_system(f, device="cpu").am.num_pdfs


@pytest.mark.parametrize("name", ["gmm-basis-fmllr-accs",
                                  "gmm-basis-fmllr-accs-gpost",
                                  "gmm-acc-hlda"])
def test_statistics_within_posterior_bound(xfs, tmp_path, name):
    """Basis and HLDA statistics: JAX's npz members, dtypes and shapes,
    each array within POST_REL of its largest magnitude."""
    P = xfs
    feats = f"ark:{P('feats.ark')}"
    src = (["gmm-acc-hlda", P("mono.npz"), feats, f"ark:{P('ali.ark')}"]
           if name == "gmm-acc-hlda" else
           [name, P("mono.npz"), feats, P("post.txt")])
    res = run_both(str(tmp_path), lambda d: src + [_o(d, "a.npz")] + (
        [] if name == "gmm-acc-hlda" else _spk(P)), device=True)
    same_files(res, close=stats_close(POST_REL))


def test_hlda_estimate(xfs, tmp_path):
    """gmm-est-hlda over two copies of JAX's statistics: JAX's transform
    within 1e-6 of its largest entry (the same f64 cyclic row update on
    the same statistics) and JAX's printed line."""
    P = xfs
    res = run_both(str(tmp_path), lambda d: [
        "gmm-est-hlda", _o(d, "h.ark"), P("hlda.npz"), P("hlda.npz"),
        "--keep-dims", "20"], device=True)
    assert res["jax"][1] == res["port"][1]
    want, got = _arks(res, "h.ark")
    assert _rel(got["hlda"], want["hlda"]) <= 1e-6


def test_train_sat_by_outcome(xfs, tmp_path):
    """train-sat by outcome (EM through a tree build, mixing up and
    realignment amplifies the loglikes' rounding: a variance can move by
    some percent): JAX's printed line (pdfs, gaussians, speakers), JAX's
    model layout and host payload, each speaker's transform within
    TRANS_REL, and the port's model decodes the corpus through its own
    graph at JAX's model's words."""
    P = xfs
    feats = f"ark:{P('feats.ark')}"
    res = run_both(str(tmp_path), lambda d: [
        "train-sat", P("mono.npz"), P("text"), feats, P("utt2spk"),
        _o(d, "sat.npz"), f"ark:{_o(d, 't.ark')}", "--num-iters", "4",
        "--totgauss", "60", "--num-leaves", "20", "--fmllr-min-count",
        "50"], device=True)
    assert res["jax"][1:] == res["port"][1:]
    want, got = _arks(res, "t.ark")
    for k in want:
        assert _rel(got[k], want[k]) <= TRANS_REL, k
    (jd, _j, _c), (td, _t, _c2) = res["jax"], res["port"]
    same_model(_o(jd, "sat.npz"), _o(td, "sat.npz"),
               lambda k, g, w: np.testing.assert_array_equal(
                   np.isfinite(g), np.isfinite(w), err_msg=k))
    hyps = []
    for d in (jd, td):
        for argv in (["mkgraph", _o(d, "sat.npz"), P("lm.arpa"),
                      _o(d, "g.npz")],
                     ["gmm-latgen-faster", _o(d, "sat.npz"), _o(d, "g.npz"),
                      feats, "--utt2spk", P("utt2spk"), "--transform",
                      _o(d, "t.ark"), "--transcription-out",
                      _o(d, "hyp")] + DECODE + ["--device", "cpu"]):
            assert _call(tcli.main, argv)[1] == 0, argv
        hyps.append(open(_o(d, "hyp")).read())
    assert hyps[0] == hyps[1]


# ---------------------------------------------------------------- decodes

def _decode_cases(P, d):
    feats = f"ark:{P('feats.ark')}"
    out = ["--transcription-out", _o(d, "hyp")]
    rt = [P("mono.npz"), P("regtree.npz"), P("hclg.npz"), feats]
    return {
        "gmm-decode-faster-regtree-fmllr":
            ["gmm-decode-faster-regtree-fmllr", *rt, P("rt.ark")] + _spk(P),
        "gmm-decode-faster-regtree-mllr":
            ["gmm-decode-faster-regtree-mllr", *rt, P("rtm.ark")] + _spk(P),
        "gmm-latgen-faster-regtree-fmllr":
            ["gmm-latgen-faster-regtree-fmllr", *rt, P("rt.ark"),
             "--lattice-out", _o(d, "lat.ark")] + _spk(P),
        "gmm-decode-nbest": ["gmm-decode-nbest", P("mono.npz"),
                             P("hclg.npz"), feats, "--n", "3"],
        "gmm-latgen-map": ["gmm-latgen-map", P("mono.npz"), P("mapdir"),
                           P("hclg.npz"), feats] + _spk(P),
        "gmm-latgen-tracking": ["gmm-latgen-tracking", P("mono.npz"), feats,
                                f"ark:{P('arcs.ark')}", "--lattice-out",
                                _o(d, "lat.ark")],
        "latgen-tracking-mapped": ["latgen-tracking-mapped", P("mono.npz"),
                                   f"ark:{P('likes.ark')}",
                                   f"ark:{P('arcs.ark')}"],
    }, out


@pytest.mark.parametrize("name", sorted(_decode_cases(lambda n: n, "")[0]))
def test_decode_writes_jax_transcriptions(xfs, tmp_path, name):
    """Adapted, n-best and tracking decodes: JAX's transcription file and
    printed lines; a lattice ark has JAX's keys and best paths."""
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.io import read_lattice_ark

    def argv(d):
        cases, out = _decode_cases(xfs, d)
        return cases[name] + DECODE + out
    res = run_both(str(tmp_path), argv, device=True)
    (jd, jo, jc), (td, to, tc) = res["jax"], res["port"]
    assert (jo, jc) == (to, tc) and jc == 0
    assert open(_o(td, "hyp")).read() == open(_o(jd, "hyp")).read()
    assert open(_o(jd, "hyp")).read().strip()
    if os.path.exists(_o(jd, "lat.ark")):
        want = dict(read_lattice_ark(_o(jd, "lat.ark")))
        got = dict(read_lattice_ark(_o(td, "lat.ark")))
        assert list(got) == list(want)
        assert {k: lattice_best_path(v)[0] for k, v in got.items()} == \
            {k: lattice_best_path(v)[0] for k, v in want.items()}
