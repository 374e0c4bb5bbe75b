"""Port parity: the CLI's second slice, GMM subcommands
(kaldi_tpu_torch/cli.py, cli_gmm_extra.py) against kaldi_tpu's CLI, on
the CPU, over files that either package wrote.

The inputs are JAX-written once per module (`jax_system`):
tests/test_gmmbin_cli.py's `_tiny_corpus` (12 yesno utterances of MFCC +
deltas), JAX's `train-mono` model, its alignments, posteriors and
accumulators, and two UBMs clustered by JAX's `init-ubm`.
- Host commands (estimation, mixing up, accumulator algebra, the
  global-GMM family, which scores on the host in both packages) write
  JAX's files: `.npz` array for array (zip headers carry timestamps),
  text, posteriors and pickles byte for byte, and print JAX's lines.
- Device commands (`--device cpu`): `gmm-init-mono` and
  `gmm-init-model-flat` array for array (host moments); the
  accumulators of `gmm-acc-stats-ali`, `gmm-acc-stats` and
  `gmm-acc-stats2` within 1e-5 of each array's largest magnitude;
  `gmm-compute-likes` within 1e-5 of the GEMM's terms
  (chip_smoke.gmm_term_scale); a full-covariance `gmm-global-est`
  (eigenvalue floor by torch's eigh) within 1e-9.
- One `gmm-est` on the port's accumulators is within 1e-5 of JAX's on
  JAX's, and JAX's `gmm-est` reads the port's accumulators.
- tests/test_gmmbin_cli.py:84's sharded EM protocol (steps/train_mono.sh
  as primitives) through the port alone, held by outcome: the two shards
  sum to the unsharded accumulators, the objective rises, the mixed-up
  model decodes the corpus at WER 0.
test_gmmbin_cli.py's, test_gmm_extra_cli.py's,
test_gmm_extras_cli.py::test_stats_algebra's and
test_bin_leftovers_cli.py's GMM cases, on the port.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.cli import main as jmain
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io import model_io as tmio
from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, read_ark, write_ark
from kaldi_tpu_torch.io.model_io import _loads
from test_gmmbin_cli import _tiny_corpus
from test_torch_cli_features import _call, _files, run_both

torch.set_num_threads(2)

ACC_REL = 1e-5       # accumulators: of each array's largest magnitude
LL_REL = 1e-5        # loglikes: of their GEMM terms (phases 17-20)
EIGH_REL = 1e-9      # a full-covariance update's eigenvalue floor


def jax_system(root, n_utts: int = 12, seed: int = 13):
    """JAX-written inputs: the corpus, a train-mono model, its
    alignments, posteriors (plain and signed), accumulators, its tree,
    and a full and a diagonal UBM. -> P(name) -> path."""
    _tiny_corpus(root, n_utts=n_utts, seed=seed)
    P = lambda *n: str(root.joinpath(*n))                    # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    for argv in (
            ["train-mono", P("lexicon.txt"), P("text"), feats, P("mono.npz")],
            ["gmm-align", P("mono.npz"), P("text"), feats,
             f"ark:{P('ali.ark')}"],
            ["ali-to-post", f"ark:{P('ali.ark')}", P("post.txt")],
            ["gmm-acc-stats-ali", P("mono.npz"), feats, f"ark:{P('ali.ark')}",
             P("acc.npz")],
            ["copy-tree", P("mono.npz"), P("tree.npz")],
            ["init-ubm", P("mono.npz"), P("acc.npz"), P("fubm.npz"),
             "--ubm-num-gauss", "6"],
            ["init-ubm", P("mono.npz"), P("acc.npz"), P("dubm.npz"),
             "--ubm-num-gauss", "6", "--fullcov-ubm", "false"],
            ["gmm-gselect", P("dubm.npz"), feats, P("gsel.txt"), "--n", "3"],
            ["gmm-global-get-post", P("dubm.npz"), feats, P("upost.txt"),
             "--n", "3"],
            ["gmm-global-acc-stats", P("dubm.npz"), feats, P("dacc.npz")],
            ["gmm-global-acc-stats", P("fubm.npz"), feats, P("facc.npz")]):
        assert _call(jmain, argv)[1] == 0, argv
    with open(P("post.txt")) as f, open(P("signed.txt"), "w") as g:
        for i, line in enumerate(f):
            if i % 2:
                toks = line.split()
                line = " ".join(t if k % 2 == 0 or t in "[]" else
                                f"{-0.5 * float(t):.6g}"
                                for k, t in enumerate(toks)) + "\n"
            g.write(line)
    write_ark(P("feats2.ark"), {k: (v[:, :13] * 0.5).astype(np.float32)
                                for k, v in open_rspecifier(feats)})
    return P


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    return jax_system(tmp_path_factory.mktemp("gmm"))


# ------------------------------------------------------------ comparisons

def _npz(path):
    return path.endswith(".npz") or zipfile.is_zipfile(path)


def same_files(res, close=None, printed=True, code=0):
    """Both runs wrote the same files: each `.npz` array for array (equal,
    or within close(key, got, want) when given; a pickled host payload
    unpickled and compared by chip_smoke.host_equal, as
    tests/test_torch_model_io.py compares model files), any other
    byte-equal; equal exit codes (`code`, unless None), and equal output
    when `printed`."""
    (jd, jout, jcode), (td, tout, tcode) = res["jax"], res["port"]
    assert jcode == tcode and code in (None, jcode), (jout, tout)
    assert _files(jd) == _files(td) and (_files(jd) or jout)
    if printed:
        assert jout == tout
    for f in _files(jd):
        a, b = os.path.join(jd, f), os.path.join(td, f)
        if not _npz(a):
            assert open(a, "rb").read() == \
                open(b, "rb").read().replace(td.encode(), jd.encode()), f
            continue
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files), f
        for k in za.files:
            w, g = za[k], zb[k]
            assert g.dtype == w.dtype, (f, k)
            if k == "__host__":
                assert cs.host_equal(_loads(g.tobytes()),
                                     _loads(w.tobytes())), (f, k)
                continue
            assert g.shape == w.shape, (f, k)
            if close is None or w.dtype.kind not in "f":
                assert np.array_equal(g, w), (f, k)
            else:
                close(k, g, w)


def same_leaves(zj, zt):
    """Two `.npz` model files hold the same members, each with JAX's dtype
    and shape (a file compared within a bound keeps JAX's layout)."""
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert (zt[k].dtype, zt[k].shape) == (zj[k].dtype, zj[k].shape), k


def rel_close(rel):
    """|got - want| <= rel * max |want| of the array."""
    def close(k, g, w):
        w64 = w.astype(np.float64)
        scale = max(float(np.abs(w64).max(initial=0.0)), 1e-30)
        assert np.abs(g.astype(np.float64) - w64).max(initial=0.0) \
            <= rel * scale, k
    return close


def _run(sysd, tmp, argv_fn, device=False):
    return run_both(str(tmp), lambda O: argv_fn(sysd, O), device)


def F(P):
    return f"ark:{P('feats.ark')}"


# (name, argv(P, O)): host commands, JAX's files and lines
HOST_CASES = [
    ("gmm-info", lambda P, O: ["gmm-info", P("mono.npz")]),
    ("gmm-copy", lambda P, O: ["gmm-copy", P("mono.npz"), f"{O}/m.npz"]),
    ("gmm-boost-silence", lambda P, O: [
        "gmm-boost-silence", "1:2", P("mono.npz"), f"{O}/m.npz",
        "--boost", "1.25"]),
    ("gmm-mixup", lambda P, O: [
        "gmm-mixup", P("mono.npz"), f"{O}/m.npz", "--mix-up", "70",
        "--occs", P("acc.npz")]),
    ("gmm-sum-accs", lambda P, O: [
        "gmm-sum-accs", f"{O}/a.npz", P("acc.npz"), P("acc.npz")]),
    ("gmm-est", lambda P, O: [
        "gmm-est", P("mono.npz"), P("acc.npz"), f"{O}/m.npz",
        "--min-gaussian-occupancy", "3", "--mix-up", "80"]),
    ("gmm-scale-accs", lambda P, O: [
        "gmm-scale-accs", "0.5", P("acc.npz"), f"{O}/a.npz"]),
    ("gmm-ismooth-stats", lambda P, O: [
        "gmm-ismooth-stats", P("mono.npz"), P("acc.npz"), f"{O}/a.npz",
        "--tau", "10"]),
    ("gmm-diff-accs", lambda P, O: [
        "gmm-diff-accs", P("acc.npz"), P("acc.npz"), f"{O}/a.npz"]),
    ("gmm-est-gaussians-ebw", lambda P, O: [
        "gmm-est-gaussians-ebw", P("mono.npz"), P("acc.npz"),
        P("acc.npz"), f"{O}/m.npz", "--E", "2", "--tau", "50"]),
    ("gmm-est-weights-ebw", lambda P, O: [
        "gmm-est-weights-ebw", P("mono.npz"), P("acc.npz"), P("acc.npz"),
        f"{O}/m.npz"]),
    ("gmm-est-rescale", lambda P, O: [
        "gmm-est-rescale", P("mono.npz"), P("acc.npz"), P("acc.npz"),
        f"{O}/m.npz", "--min-variance", "1e-10"]),
    ("init-ubm", lambda P, O: [
        "init-ubm", P("mono.npz"), P("acc.npz"), f"{O}/u.npz",
        "--ubm-num-gauss", "5", "--cluster-iters", "3"]),
    ("gmm-init-trans", lambda P, O: [
        "gmm-init-trans", P("mono.npz"), P("tree.npz"), f"{O}/m.npz"]),
    ("gmm-post-to-gpost", lambda P, O: [
        "gmm-post-to-gpost", P("mono.npz"), F(P), P("post.txt"),
        f"{O}/g.pkl"]),
    ("gmm-acc-stats-twofeats", lambda P, O: [
        "gmm-acc-stats-twofeats", P("mono.npz"), F(P),
        f"ark:{P('feats2.ark')}", P("post.txt"), f"{O}/a.npz"]),
    *[(n, lambda P, O, n=n, u=u: [n, P(u), F(P), f"{O}/g.txt", "--n", "2"])
      for n, u in (("gmm-gselect", "dubm.npz"), ("fgmm-gselect",
                                                   "fubm.npz"))],
    ("gmm-global-get-post", lambda P, O: [
        "gmm-global-get-post", P("fubm.npz"), F(P), f"{O}/p.txt", "--n",
        "2", "--min-post", "0.01"]),
    ("gmm-global-to-fgmm", lambda P, O: [
        "gmm-global-to-fgmm", P("dubm.npz"), f"{O}/u.npz"]),
    ("gmm-global-copy", lambda P, O: [
        "gmm-global-copy", P("fubm.npz"), f"{O}/u.npz"]),
    *[("gmm-global-info", lambda P, O, u=u: ["gmm-global-info", P(u)])
      for u in ("dubm.npz", "fubm.npz")],
    *[("gmm-global-acc-stats", lambda P, O, u=u: [
        "gmm-global-acc-stats", P(u), F(P), f"{O}/a.npz"])
      for u in ("dubm.npz", "fubm.npz")],
    *[("gmm-global-acc-stats-post", lambda P, O, u=u: [
        "gmm-global-acc-stats-post", P(u), F(P), P("upost.txt"),
        f"{O}/a.npz"]) for u in ("dubm.npz", "fubm.npz")],
    ("gmm-global-get-frame-likes", lambda P, O: [
        "gmm-global-get-frame-likes", P("fubm.npz"), F(P),
        f"ark:{O}/l.ark"]),
    ("gmm-global-sum-accs", lambda P, O: [
        "gmm-global-sum-accs", f"{O}/a.npz", P("facc.npz"), P("facc.npz")]),
    *[(n, lambda P, O, n=n, u=u: [n, P(u), F(P), P("gsel.txt"),
                                  f"{O}/p.txt", "--min-post", "0.05"])
      for n, u in (("gmm-global-gselect-to-post", "dubm.npz"),
                   ("fgmm-global-gselect-to-post", "fubm.npz"))],
    *[(n, lambda P, O, n=n, u=u: [n, P(u), F(P), f"ark:{P('feats2.ark')}",
                                  f"{O}/a.npz"])
      for n, u in (("gmm-global-acc-stats-twofeats", "dubm.npz"),
                   ("fgmm-global-acc-stats-twofeats", "fubm.npz"))],
]


@pytest.mark.parametrize("name,argv", HOST_CASES,
                         ids=[f"{n}-{i}" for i, (n, _a) in
                              enumerate(HOST_CASES)])
def test_host_command_writes_jax_files(sysd, tmp_path, name, argv):
    same_files(_run(sysd, tmp_path, argv))


def test_gmm_global_est_diag_exact_full_within_eigh(sysd, tmp_path):
    P = sysd
    same_files(_run(sysd, tmp_path / "d", lambda P, O: [
        "gmm-global-est", P("dubm.npz"), P("dacc.npz"), f"{O}/u.npz",
        "--min-gaussian-occupancy", "1"], device=True))
    same_files(_run(sysd, tmp_path / "f", lambda P, O: [
        "gmm-global-est", P("fubm.npz"), P("facc.npz"), f"{O}/u.npz",
        "--min-gaussian-occupancy", "1"], device=True),
        close=rel_close(EIGH_REL))
    assert tmio.load_ubm(str(tmp_path / "f" / "port" / "u.npz")).num_gauss \
        == tmio.load_ubm(P("fubm.npz")).num_gauss


def test_gmm_init_mono_and_flat_init_are_jax_arrays(sysd, tmp_path):
    same_files(_run(sysd, tmp_path / "mono", lambda P, O: [
        "gmm-init-mono", P("lexicon.txt"), F(P), f"{O}/m.npz"],
        device=True))
    for extra in ([], [F(sysd)]):
        same_files(_run(sysd, tmp_path / f"flat{len(extra)}", lambda P, O: [
            "gmm-init-model-flat", P("mono.npz"), P("tree.npz"),
            f"{O}/m.npz", *extra, "--dim", "39"], device=True))


@pytest.mark.parametrize("name,argv", [
    ("gmm-acc-stats-ali", lambda P, O: [
        "gmm-acc-stats-ali", P("mono.npz"), F(P), f"ark:{P('ali.ark')}",
        f"{O}/a.npz"]),
    ("gmm-acc-stats", lambda P, O: [
        "gmm-acc-stats", P("mono.npz"), F(P), P("post.txt"), f"{O}/a.npz"]),
    ("gmm-acc-stats2", lambda P, O: [
        "gmm-acc-stats2", P("mono.npz"), F(P), P("signed.txt"),
        f"{O}/n.npz", f"{O}/d.npz"])])
def test_device_accumulators_within_1e5(sysd, tmp_path, name, argv):
    same_files(_run(sysd, tmp_path, argv, device=True),
               close=rel_close(ACC_REL), printed=False)


def test_acc_stats2_splits_signed_posteriors(sysd, tmp_path):
    """test_gmm_extras_cli.py::test_stats_algebra's identity on the
    port's files: num + 2 den occupancy = the frames."""
    P = sysd
    assert _call(tcli.main, [
        "gmm-acc-stats2", P("mono.npz"), F(P), P("signed.txt"),
        str(tmp_path / "n.npz"), str(tmp_path / "d.npz"),
        "--device", "cpu"])[1] == 0
    num, _ = tmio.load_gmm_accs(str(tmp_path / "n.npz"))
    den, _ = tmio.load_gmm_accs(str(tmp_path / "d.npz"))
    tot_num = sum(a.occ.sum() for a in num.accs)
    tot_den = sum(a.occ.sum() for a in den.accs)
    frames = sum(v.shape[0] for _k, v in open_rspecifier(F(P)))
    assert tot_num > 0 and tot_den > 0
    assert abs(tot_num + 2 * tot_den - frames) < 1e-3


def test_gmm_compute_likes_within_gemm_terms(sysd, tmp_path):
    P = sysd
    res = _run(sysd, tmp_path, lambda P, O: [
        "gmm-compute-likes", P("mono.npz"), F(P), f"ark:{O}/l.ark"],
        device=True)
    am = tmio.load_gmm_system(P("mono.npz"), device="cpu").am
    feats = dict(open_rspecifier(F(P)))
    want = list(read_ark(os.path.join(res["jax"][0], "l.ark")))
    got = list(read_ark(os.path.join(res["port"][0], "l.ark")))
    assert [k for k, _ in got] == [k for k, _ in want] and want
    for (k, g), (_k, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (np.abs(g.astype(np.float64) - w)
                <= LL_REL * cs.gmm_term_scale(am, feats[k])).all(), k


def test_gmm_est_on_each_packages_accs(sysd, tmp_path):
    """One iteration: the port's gmm-est on the port's accumulators
    within 1e-5 of JAX's on JAX's; JAX's gmm-est on the port's
    accumulators writes the port's model."""
    P = sysd
    T = lambda n: str(tmp_path / n)                          # noqa: E731
    assert _call(tcli.main, ["gmm-acc-stats-ali", P("mono.npz"), F(P),
                             f"ark:{P('ali.ark')}", T("tacc.npz"),
                             "--device", "cpu"])[1] == 0
    est = ["--min-gaussian-occupancy", "3", "--mix-up", "80"]
    for main, acc, out in ((tcli.main, T("tacc.npz"), T("t.npz")),
                           (jmain, P("acc.npz"), T("j.npz")),
                           (jmain, T("tacc.npz"), T("jt.npz"))):
        assert _call(main, ["gmm-est", P("mono.npz"), acc, out, *est])[1] \
            == 0
    t = tmio.load_gmm_system(T("t.npz"), device="cpu")
    cs._same_gmm_models("gmm-est", t, tmio.load_gmm_system(
        T("j.npz"), device="cpu"), 1e-5)
    assert cs.npz_same(T("t.npz"), T("jt.npz"))


def _shards(P, ali, utts, out):
    alis = dict(open_rspecifier(f"ark:{ali}"))
    half = len(utts) // 2
    for i, keys in enumerate((utts[:half], utts[half:])):
        write_ark(out(f"ali{i + 1}.ark"), {u: alis[u] for u in keys})


def test_train_mono_protocol_through_the_port(sysd, tmp_path):
    """steps/train_mono.sh as primitives (tests/test_gmmbin_cli.py:84) on
    the port alone: gmm-init-mono, align-equal, then boost-silence,
    gmm-align, two-shard accumulation, sum and estimation with a mix-up
    ramp; the shards' sum equals one unsharded accumulation, the
    objective rises, and the model decodes the corpus at WER 0."""
    P = sysd
    T = lambda n: str(tmp_path / n)                          # noqa: E731

    def port(*argv, device=False):
        out, code = _call(tcli.main, list(argv) + (
            ["--device", "cpu"] if device else []))
        assert code == 0, argv
        return out

    port("gmm-init-mono", P("lexicon.txt"), F(P), T("m0.npz"), device=True)
    utts = sorted(k for k, _v in open_rspecifier(F(P)))
    sil = tmio.load_gmm_system(T("m0.npz"), device="cpu").lang.phones["SIL"]
    n_iters, totgauss, max_iter_inc = 10, 60, 7
    cur = tmio.load_gmm_system(T("m0.npz"), device="cpu").am.num_pdfs
    inc = max(1, (totgauss - cur) // max_iter_inc)
    liks = []
    for it in range(n_iters):
        if it == 0:
            port("align-equal", T("m0.npz"), P("text"), F(P),
                 f"ark:{T('ali.ark')}", device=True)
            mix = []
        else:
            port("gmm-boost-silence", str(sil), T(f"m{it}.npz"),
                 T("malign.npz"), "--boost", "1.25")
            port("gmm-align", T("malign.npz"), P("text"), F(P),
                 f"ark:{T('ali.ark')}", device=True)
            cur = min(totgauss, cur + inc) if it <= max_iter_inc else cur
            mix = ["--mix-up", str(cur)]
        _shards(P, T("ali.ark"), utts, T)
        for a, acc in (("ali1.ark", "acc1.npz"), ("ali2.ark", "acc2.npz"),
                       ("ali.ark", "acc_all.npz")):
            port("gmm-acc-stats-ali", T(f"m{it}.npz"), F(P), f"ark:{T(a)}",
                 T(acc), device=True)
        port("gmm-sum-accs", T("acc.npz"), T("acc1.npz"), T("acc2.npz"))
        acc, tc = tmio.load_gmm_accs(T("acc.npz"))
        acc_all, tc_all = tmio.load_gmm_accs(T("acc_all.npz"))
        assert acc.tot_like == pytest.approx(acc_all.tot_like, rel=1e-6)
        np.testing.assert_array_equal(tc, tc_all)
        for a, b in zip(acc.accs, acc_all.accs):
            np.testing.assert_allclose(a.occ, b.occ, rtol=1e-6)
        liks.append(acc.tot_like / acc.tot_frames)
        port("gmm-est", T(f"m{it}.npz"), T("acc.npz"), T(f"m{it + 1}.npz"),
             "--min-gaussian-occupancy", "3", "--power", "0.25", *mix)
    assert liks[1] > liks[0] and liks[2] > liks[1], liks
    fin = T(f"m{n_iters}.npz")
    m = tmio.load_gmm_system(fin, device="cpu")
    assert m.am.total_gauss > m.am.num_pdfs
    port("mkgraph", fin, P("lm.arpa"), T("hclg.npz"))
    port("decode-faster", fin, T("hclg.npz"), F(P), "--transcription-out",
         T("hyp.txt"), device=True)
    assert "%WER 0.00" in port("compute-wer", P("text"), T("hyp.txt"))
