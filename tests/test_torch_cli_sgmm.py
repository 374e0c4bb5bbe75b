"""Port parity: the CLI's last slice (5b), its 28 SGMM subcommands
(kaldi_tpu_torch/cli.py's sgmm2-* and train-sgmm2, and the new
cli_sgmm.py) and the 25 sgmm / sgmm2 aliases through `main`, against
kaldi_tpu's CLI, on the CPU, over files that JAX wrote.

The inputs are JAX-written once per module: test_torch_cli_adapt.py's
`adapt_system` (12 yesno utterances, two speakers, JAX's mono model,
graph, alignments, posteriors and lattices) plus a full-covariance UBM,
an SGMM2 (phn-dim 10, spk-dim 3) after one EM step and a substate split,
its accumulators, gaussian-level posteriors, fMLLR-basis statistics and
SGMM lattices.
- Host commands (copy, info, the UBM write-out, normalization, the
  re-initialization over a tree, projection, summing accumulators)
  write JAX's bytes and print JAX's lines.
- Everything that scores, accumulates or solves runs in f64 on both
  sides, so each result is held to SGMM_REL (1e-9) of each array's
  largest magnitude, test_torch_sgmm.py's bound; integer outputs
  (gselect, alignments) and decodes are JAX's exactly; gaussian-level
  posteriors (f32 in the file) within 1e-6 of their largest.
- Two results are held by what defines them: the SGMM fMLLR basis
  (eigenvectors of near-equal eigenvalues rotate freely) by each
  vector's Rayleigh quotient under JAX's scatter, and `train-sgmm2`
  (EM from f32 UBM training) by outcome: JAX's model layout and printed
  counts, its loglike within LIKE_TOL.
- The legacy sgmm-* names and the -gpost / -parallel / -compiled names
  run through each package's `main` to the same results; `sgmm-init`
  writes the legacy 'sgmm' tag.
test_sgmm_cli3.py's, test_sgmm2_cli2.py's, test_sgmm.py's and
test_cli_leftovers2.py's SGMM cases, on the port.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import main as jmain
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io import model_io as tmio
from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, read_ark, write_ark
from kaldi_tpu_torch.lat.io import read_lattice_ark
from test_torch_cli_adapt import adapt_system, same_model, stats_close
from test_torch_cli_features import _call, _files, run_both, same_bytes
from test_torch_lattice import _same_lattice

torch.set_num_threads(2)

SGMM_REL = 1e-9      # f64 on both sides (tests/test_torch_sgmm.py)
GPOST_REL = 1e-6     # f32 gaussian-level posteriors in the file
LIKE_TOL = 1e-2      # train-sgmm2's printed loglike per frame


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    root = tmp_path_factory.mktemp("sgmm")
    P = adapt_system(root)
    feats = f"ark:{P('feats.ark')}"
    for argv in (
            ["init-ubm", P("mono.npz"), P("acc.npz"), P("fubm.npz"),
             "--ubm-num-gauss", "8"],
            ["sgmm2-init", P("mono.npz"), P("fubm.npz"), P("sgmm0.npz"),
             "--phn-dim", "10", "--spk-dim", "3", "--num-gselect", "4"],
            ["sgmm2-acc-stats", P("sgmm0.npz"), P("mono.npz"), feats,
             P("post.txt"), P("sacc0.npz")],
            ["sgmm2-est", P("sgmm0.npz"), P("sacc0.npz"), P("sgmm.npz"),
             "--split-substates", "20"],
            ["sgmm2-acc-stats", P("sgmm.npz"), P("mono.npz"), feats,
             P("post.txt"), P("sacc.npz")],
            ["sgmm2-post-to-gpost", P("sgmm.npz"), P("mono.npz"), feats,
             P("post.txt"), P("gpost.pkl")],
            ["sgmm-acc-fmllrbasis-ali", P("sgmm.npz"), P("mono.npz"), feats,
             f"ark:{P('ali.ark')}", P("fb.pkl"), "--utt2spk", P("utt2spk")],
            ["sgmm2-latgen-faster", P("sgmm.npz"), P("mono.npz"),
             P("hclg.npz"), feats, "--lattice-out", P("slat.ark"),
             "--beam", "14", "--max-active", "64", "--lattice-beam", "7"],
            ["copy-tree", P("mono.npz"), P("tree.npz")]):
        assert _call(jmain, argv)[1] == 0, argv
    with open(P("post.txt")) as f, open(P("signed.txt"), "w") as g:
        for i, line in enumerate(f):
            if i % 2:
                toks = line.split()
                line = " ".join(t if k % 2 == 0 or t in "[]" else
                                f"{-0.5 * float(t):.6g}"
                                for k, t in enumerate(toks)) + "\n"
            g.write(line)
    assert _call(jmain, ["sgmm2-acc-stats2", P("sgmm.npz"), P("mono.npz"),
                         feats, P("signed.txt"), P("num.npz"),
                         P("den.npz")])[1] == 0
    write_ark(P("sets.ark"), {"a": np.arange(4, dtype=np.float32),
                              "b": np.arange(4, 8, dtype=np.float32)})
    rng = np.random.RandomState(3)
    write_ark(P("lda.ark"), {"lda": (np.eye(39) + 0.05 * rng.randn(39, 39))
                             .astype(np.float32)})
    return P


def _o(d, n):
    return os.path.join(d, n)


# name -> (its argv of (P, d), device, comparison)
def _cases(P, d):
    feats = f"ark:{P('feats.ark')}"
    spk = ["--utt2spk", P("utt2spk")]
    search = ["--beam", "14", "--max-active", "64", "--lattice-beam", "7"]
    return {
        # host file tools: JAX's bytes
        "sgmm2-copy": (["sgmm2-copy", P("sgmm.npz"), _o(d, "s.npz")],
                       False, "bytes"),
        "sgmm2-info": (["sgmm2-info", P("sgmm.npz")], False, "bytes"),
        "sgmm-write-ubm": (["sgmm-write-ubm", P("sgmm.npz"),
                            _o(d, "u.npz")], False, "bytes"),
        "sgmm-normalize": (["sgmm-normalize", P("sgmm.npz"),
                            f"ark:{P('sets.ark')}", _o(d, "s.npz")],
                           False, "bytes"),
        "sgmm-init-from-tree-stats": (["sgmm-init-from-tree-stats",
                                       P("sgmm.npz"), P("tree.npz"),
                                       _o(d, "s.npz")], False, "bytes"),
        "sgmm2-project": (["sgmm2-project", P("sgmm.npz"), P("lda.ark"),
                           _o(d, "s.npz"), _o(d, "p.ark"), "--end-dim",
                           "30"], False, "bytes"),
        "sgmm2-sum-accs": (["sgmm2-sum-accs", _o(d, "a.npz"), P("sacc.npz"),
                            P("sacc.npz")], False, "bytes"),
        # device, f64
        "sgmm2-init": (["sgmm2-init", P("mono.npz"), P("fubm.npz"),
                        _o(d, "s.npz"), "--phn-dim", "10", "--spk-dim", "3",
                        "--num-gselect", "4", "--seed", "2"], True, "f64"),
        "sgmm-mixup": (["sgmm-mixup", P("sgmm.npz"), _o(d, "s.npz"),
                        "--num-substates", "30", "--read-occs",
                        P("sacc.npz"), "--increase-phn-dim", "12",
                        "--increase-spk-dim", "4"], True, "f64"),
        "sgmm-calc-distances": (["sgmm-calc-distances", P("sgmm.npz"),
                                 P("sacc.npz"), _o(d, "d.ark")], True, "f64"),
        "sgmm2-post-to-gpost": (["sgmm2-post-to-gpost", P("sgmm.npz"),
                                 P("mono.npz"), feats, P("post.txt"),
                                 _o(d, "g.pkl")], True, "f64"),
        "sgmm2-acc-stats-gpost": (["sgmm2-acc-stats-gpost", P("sgmm.npz"),
                                   feats, P("gpost.pkl"), _o(d, "a.npz")],
                                  True, "f64"),
        "sgmm2-acc-stats2": (["sgmm2-acc-stats2", P("sgmm.npz"),
                              P("mono.npz"), feats, P("signed.txt"),
                              _o(d, "n.npz"), _o(d, "dd.npz")], True, "f64"),
        "sgmm-acc-stats-ali": (["sgmm-acc-stats-ali", P("sgmm.npz"),
                                P("mono.npz"), feats, f"ark:{P('ali.ark')}",
                                _o(d, "a.npz")], True, "f64"),
        "sgmm-est-multi": (["sgmm-est-multi", P("sgmm.npz"), P("sacc.npz"),
                            _o(d, "o1.npz"), P("sgmm.npz"), P("num.npz"),
                            _o(d, "o2.npz")], True, "f64"),
        "sgmm2-est-fmllr": (["sgmm2-est-fmllr", P("sgmm.npz"),
                             P("mono.npz"), feats, P("post.txt"),
                             f"ark:{_o(d, 't.ark')}", "--fmllr-min-count",
                             "50"] + spk, True, "f64"),
        "sgmm2-comp-prexform": (["sgmm2-comp-prexform", P("sgmm.npz"),
                                 P("sacc.npz"), _o(d, "s.npz")], True, "f64"),
        "sgmm-acc-fmllrbasis-ali": (["sgmm-acc-fmllrbasis-ali",
                                     P("sgmm.npz"), P("mono.npz"), feats,
                                     f"ark:{P('ali.ark')}", _o(d, "fb.pkl")]
                                    + spk, True, "f64"),
        "sgmm2-rescore-lattice": (["sgmm2-rescore-lattice", P("sgmm.npz"),
                                   P("mono.npz"), P("slat.ark"), feats,
                                   _o(d, "l.lat")], True, "f64"),
        "sgmm2-latgen-faster": (["sgmm2-latgen-faster", P("sgmm.npz"),
                                 P("mono.npz"), P("hclg.npz"), feats,
                                 "--lattice-out", _o(d, "l.lat"),
                                 "--transcription-out", _o(d, "hyp")]
                                + search, True, "f64"),
        "sgmm2-gselect": (["sgmm2-gselect", P("sgmm.npz"), feats,
                           f"ark:{_o(d, 'g.ark')}", "--num-gselect", "4"],
                          True, "f64"),
        "sgmm2-acc-stats": (["sgmm2-acc-stats", P("sgmm.npz"), P("mono.npz"),
                             feats, P("post.txt"), _o(d, "a.npz")],
                            True, "f64"),
        "sgmm2-est": (["sgmm2-est", P("sgmm.npz"), P("sacc.npz"),
                       _o(d, "s.npz"), "--split-substates", "25"],
                      True, "f64"),
        "sgmm2-est-ebw": (["sgmm2-est-ebw", P("sgmm.npz"), P("num.npz"),
                           P("den.npz"), _o(d, "s.npz")], True, "f64"),
        "sgmm2-align": (["sgmm2-align", P("sgmm.npz"), P("mono.npz"),
                         P("text"), feats, f"ark:{_o(d, 'a.ark')}"],
                        True, "f64"),
        "sgmm2-est-spkvecs": (["sgmm2-est-spkvecs", P("sgmm.npz"),
                               P("mono.npz"), feats, P("post.txt"),
                               f"ark:{_o(d, 'v.ark')}"] + spk, True, "f64"),
        # held by what defines them
        "sgmm-est-fmllrbasis": (["sgmm-est-fmllrbasis", P("sgmm.npz"),
                                 _o(d, "s.npz"), P("fb.pkl"),
                                 "--num-bases", "10"], True, "basis"),
        "train-sgmm2": (["train-sgmm2", P("mono.npz"), P("text"), feats,
                         _o(d, "s.npz"), "--ubm-gauss", "8", "--phn-dim",
                         "8", "--num-iters", "3", "--num-gselect", "4"],
                        True, "outcome"),
    }


# alias -> the subcommand it runs (kaldi_tpu/cli.py's _ALIASES)
ALIASES = {
    "sgmm2-latgen-faster-parallel": "sgmm2-latgen-faster",
    "sgmm2-align-compiled": "sgmm2-align",
    "sgmm2-est-fmllr-gpost": "sgmm2-est-fmllr",
    "sgmm2-est-spkvecs-gpost": "sgmm2-est-spkvecs",
    "sgmm-init": "sgmm2-init", "sgmm-info": "sgmm2-info",
    "sgmm-copy": "sgmm2-copy", "sgmm-gselect": "sgmm2-gselect",
    "sgmm-acc-stats": "sgmm2-acc-stats",
    "sgmm-acc-stats-gpost": "sgmm2-acc-stats-gpost",
    "sgmm-acc-stats2": "sgmm2-acc-stats2", "sgmm-est": "sgmm2-est",
    "sgmm-est-ebw": "sgmm2-est-ebw", "sgmm-sum-accs": "sgmm2-sum-accs",
    "sgmm-align-compiled": "sgmm2-align",
    "sgmm-latgen-faster": "sgmm2-latgen-faster",
    "sgmm-latgen-simple": "sgmm2-latgen-faster",
    "sgmm-decode-faster": "sgmm2-latgen-faster",
    "sgmm-est-spkvecs": "sgmm2-est-spkvecs",
    "sgmm-est-spkvecs-gpost": "sgmm2-est-spkvecs",
    "sgmm-post-to-gpost": "sgmm2-post-to-gpost",
    "sgmm-rescore-lattice": "sgmm2-rescore-lattice",
    "sgmm-est-fmllr": "sgmm2-est-fmllr",
    "sgmm-est-fmllr-gpost": "sgmm2-est-fmllr",
    "sgmm-comp-prexform": "sgmm2-comp-prexform",
}


def _close_tree(g, w, rel, what):
    """Unpickled results: containers element for element, arrays of
    JAX's dtype and shape within `rel` of their largest magnitude."""
    if isinstance(w, dict):
        assert list(g) == list(w), what
        for k in w:
            _close_tree(g[k], w[k], rel, f"{what}/{k}")
    elif isinstance(w, (list, tuple)):
        assert type(g) is type(w) and len(g) == len(w), what
        for i, (a, b) in enumerate(zip(g, w)):
            _close_tree(a, b, rel, f"{what}[{i}]")
    elif isinstance(w, np.ndarray):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        if w.dtype.kind == "f" and w.size:
            assert np.abs(g.astype(np.float64) - w).max() \
                <= rel * max(np.abs(w).max(), 1e-300), what
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)
    elif isinstance(w, float):
        assert type(g) is float and abs(g - w) <= rel * max(abs(w), 1e-300)
    else:
        assert g == w, what


def same_within(res, rel):
    """Both runs wrote the same files and printed the same lines, exit 0:
    model and accumulator files with JAX's members, dtypes and shapes,
    float members within `rel`; arks with JAX's keys, dtypes and shapes,
    within `rel`; pickles element for element (f32 arrays within
    GPOST_REL); lattices (`*.lat`) by `_same_lattice`; the rest byte for
    byte."""
    (jd, jout, jcode), (td, tout, tcode) = res["jax"], res["port"]
    assert (jout, jcode) == (tout, tcode) and jcode == 0
    assert _files(jd) == _files(td) and _files(jd)
    for f in _files(jd):
        a, b = _o(jd, f), _o(td, f)
        if f.endswith(".npz"):
            same_model(a, b, stats_close(rel))
        elif f.endswith(".pkl"):
            w, g = (pickle.load(open(p, "rb")) for p in (a, b))
            _close_tree(g, w, max(rel, GPOST_REL) if f == "g.pkl" else rel,
                        f)
        elif f.endswith(".lat"):
            w, g = (dict(read_lattice_ark(p)) for p in (a, b))
            assert list(g) == list(w) and w
            for k in w:
                _same_lattice(g[k], w[k], k)
        elif f.endswith(".ark"):
            w, g = dict(read_ark(a)), dict(read_ark(b))
            assert list(g) == list(w) and w
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                stats_close(rel)(k, g[k], w[k])
        else:
            assert open(a, "rb").read() == \
                open(b, "rb").read().replace(td.encode(), jd.encode()), f


def _check(P, res, kind):
    if kind == "bytes":
        same_bytes(res)
    elif kind == "f64":
        same_within(res, SGMM_REL)
    elif kind == "basis":
        _same_basis(P, res)
    else:
        _same_outcome(res)


def _same_basis(P, res):
    """sgmm-est-fmllrbasis: JAX's model file apart from the basis, and
    each basis vector's Rayleigh quotient under JAX's scatter of the
    speakers' gradients at the identity (the matrix whose leading
    eigenvectors the basis is) within SGMM_REL of JAX's."""
    from kaldi_tpu.io.model_io import load_sgmm2
    from kaldi_tpu.sgmm.fmllr import FmllrSgmm2Accs
    from kaldi_tpu.sgmm.prexform import fmllr_grad_at_identity
    (jd, jout, jcode), (td, tout, tcode) = res["jax"], res["port"]
    assert (jout, jcode) == (tout, tcode) and jcode == 0
    key = "__extra_fmllr_basis"
    same_model(_o(jd, "s.npz"), _o(td, "s.npz"),
               lambda k, g, w: None if k == key
               else stats_close(SGMM_REL)(k, g, w))
    model = load_sgmm2(P("sgmm.npz")).sgmm
    S = 0.0
    for _spk, (beta, K, G) in pickle.load(open(P("fb.pkl"), "rb")).items():
        st = FmllrSgmm2Accs(model)
        st.beta, st.K, st.G = beta, K, G
        g = np.asarray(fmllr_grad_at_identity(st, model)).reshape(-1)
        S = S + np.outer(g, g) / beta
    q = [np.einsum("ki,ij,kj->k", B, S, B) / np.einsum("ki,ki->k", B, B)
         for B in (np.load(_o(d, "s.npz"))[key].reshape(10, -1)
                   for d in (jd, td))]
    np.testing.assert_allclose(q[1], q[0], rtol=1e-6,
                               atol=SGMM_REL * np.abs(q[0]).max())


def _same_outcome(res):
    """train-sgmm2: JAX's printed counts, its loglike per frame within
    LIKE_TOL, JAX's model layout, finite values."""
    (jd, jout, jcode), (td, tout, tcode) = res["jax"], res["port"]
    assert jcode == tcode == 0
    head, tail = (s.rsplit(" ", 1) for s in (jout.strip(), tout.strip()))
    assert head[0] == tail[0]
    assert abs(float(head[1]) - float(tail[1])) <= LIKE_TOL
    same_model(_o(jd, "s.npz"), _o(td, "s.npz"),
               lambda k, g, w: np.testing.assert_array_equal(
                   np.isfinite(g), np.isfinite(w), err_msg=k))


@pytest.mark.parametrize("name", sorted(_cases(lambda n: n, "")))
def test_sgmm_command(sysd, tmp_path, name):
    """Each SGMM subcommand against JAX's, by its comparison kind."""
    _argv, dev, kind = _cases(sysd, "")[name]
    res = run_both(str(tmp_path), lambda d: _cases(sysd, d)[name][0],
                   device=dev)
    _check(sysd, res, kind)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_sgmm_alias_through_main(sysd, tmp_path, alias):
    """Each alias through both packages' `main`, with the canonical
    command's arguments: the canonical command's comparison."""
    target = ALIASES[alias]
    _argv, dev, kind = _cases(sysd, "")[target]
    res = run_both(str(tmp_path),
                   lambda d: [alias] + _cases(sysd, d)[target][0][1:],
                   device=dev)
    _check(sysd, res, kind)
    if alias == "sgmm-init":
        for d, _out, _code in res.values():
            z = np.load(_o(d, "s.npz"))
            assert z["__kind__"].tobytes() == b"sgmm"


def test_sgmm_files_load_both_ways(sysd, tmp_path):
    """SGMM2 models and accumulators: JAX loads the port's files and the
    port JAX's, the loglikes and occupancies equal."""
    from kaldi_tpu.io import model_io as jmio
    P = sysd
    for argv in (["sgmm2-est", P("sgmm.npz"), P("sacc.npz"),
                  str(tmp_path / "s.npz"), "--device", "cpu"],
                 ["sgmm2-acc-stats", P("sgmm.npz"), P("mono.npz"),
                  f"ark:{P('feats.ark')}", P("post.txt"),
                  str(tmp_path / "a.npz"), "--device", "cpu"]):
        assert _call(tcli.main, argv)[1] == 0, argv
    x = next(iter(open_rspecifier(f"ark:{P('feats.ark')}")))[1][:20]
    for path in (str(tmp_path / "s.npz"), P("sgmm.npz")):
        j = jmio.load_sgmm2(path)
        t = tmio.load_sgmm2(path, device="cpu")
        np.testing.assert_allclose(
            t.sgmm.loglikes_matrix(x.astype(np.float64), 4).numpy(),
            np.asarray(j.sgmm.loglikes_matrix(x.astype(np.float64), 4)),
            rtol=1e-9, atol=1e-9)
    for path in (str(tmp_path / "a.npz"), P("sacc.npz")):
        np.testing.assert_allclose(
            tmio.load_sgmm2_accs(path, device="cpu").state_occs(),
            jmio.load_sgmm2_accs(path).state_occs(), rtol=1e-12)


def test_sgmm2_chain_through_port_files(sysd, tmp_path):
    """steps/train_sgmm2.sh's loop on the port alone: sharded
    accumulation summed equals one unsharded accumulation, the update
    raises the likelihood, the model aligns every utterance and decodes
    the corpus at JAX's words for the port's model. The update takes the
    v and c steps: v and M updated together from one accumulation drive
    this
    small model's likelihood to about -1e5 per frame in JAX as in the
    port (the same numbers to 1e-9; kept as it is, as ROADMAP §3 B 8
    keeps the w step's overshoot)."""
    P = sysd
    o = lambda n: str(tmp_path / n)                          # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    utts = [line.split()[0] for line in open(P("text"))]
    for i, keep in enumerate((utts[::2], utts[1::2])):
        with open(P("post.txt")) as f, open(o(f"p{i}.txt"), "w") as g:
            g.writelines(line for line in f if line.split()[0] in keep)
    dev = ["--device", "cpu"]
    for argv in (
            ["sgmm2-acc-stats", P("sgmm.npz"), P("mono.npz"), feats,
             o("p0.txt"), o("a0.npz")] + dev,
            ["sgmm2-acc-stats", P("sgmm.npz"), P("mono.npz"), feats,
             o("p1.txt"), o("a1.npz")] + dev,
            ["sgmm2-acc-stats", P("sgmm.npz"), P("mono.npz"), feats,
             P("post.txt"), o("all.npz")] + dev,
            ["sgmm2-sum-accs", o("sum.npz"), o("a0.npz"), o("a1.npz")],
            ["sgmm2-est", P("sgmm.npz"), o("sum.npz"), o("s1.npz"),
             "--update-flags", "vc"] + dev,
            ["sgmm2-acc-stats", o("s1.npz"), P("mono.npz"), feats,
             P("post.txt"), o("a2.npz")] + dev,
            ["sgmm2-align-compiled", o("s1.npz"), P("mono.npz"), P("text"),
             feats, f"ark:{o('ali.ark')}"] + dev,
            ["sgmm2-latgen-faster", o("s1.npz"), P("mono.npz"),
             P("hclg.npz"), feats, "--transcription-out", o("hyp"),
             "--beam", "14", "--max-active", "64"] + dev):
        assert _call(tcli.main, argv)[1] == 0, argv
    s, a = np.load(o("sum.npz")), np.load(o("all.npz"))
    for k in a.files:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(s[k], a[k], rtol=1e-9, err_msg=k,
                                       atol=1e-9 * np.abs(a[k]).max())
    like = [float(np.load(o(n))["tot_like"]) / float(np.load(o(n))
                                                       ["tot_frames"])
            for n in ("all.npz", "a2.npz")]
    assert like[1] > like[0]
    assert len(dict(read_ark(o("ali.ark")))) == len(utts)
    assert _call(jmain, ["sgmm2-latgen-faster", o("s1.npz"), P("mono.npz"),
                         P("hclg.npz"), feats, "--transcription-out",
                         o("jhyp"), "--beam", "14", "--max-active",
                         "64"])[1] == 0
    assert open(o("hyp")).read() == open(o("jhyp")).read()
    assert len(open(o("hyp")).read().splitlines()) == len(utts)
