"""Port parity: the CLI's fifth slice (5a), groups 1-3: the i-vector
extractor and scoring, the full UBMs and logistic regression
(kaldi_tpu_torch/cli.py, cli_misc.py, cli_gmm_extra.py) against
kaldi_tpu's CLI, on the CPU, over files that JAX wrote.

The inputs are JAX-written once per module (`sre_system`): 4 synthetic
speakers x 4 utterances of 5-dim frames (a shared two-cluster content
plus a per-speaker offset, test_ivector_cli2.py's corpus widened to
speakers with several utterances), JAX's diagonal and full UBMs
(`train-ubm`), an extractor initialized and moved by one EM step, its
i-vectors, a PLDA, trials and a logistic-regression model.
- Host commands write JAX's files: `.npz` array for array (zip headers
  carry timestamps), arks, text and scores byte for byte, and print
  JAX's lines: the extractor's init (numpy's RandomState) and sum of
  accumulators, PLDA training, copying, adaptation and scoring, the LDA
  of i-vectors, cosine scoring, the EER, the i-vector means, lengths
  and centring, the online i-vectors (the extractor's host copy),
  `ivector-randomize` (RandomState), `copy-gselect`, the full-UBM
  family (`fgmm-global-*`, which scores on the host in both packages),
  and logistic regression's scoring and copy.
- Device commands (`--device cpu`), each within the bound of the
  module's parity test (tests/test_torch_ivector.py, test_torch_sre.py,
  test_torch_logistic_regression.py):
  - `ivector-extractor-acc-stats`: A, B within POST_REL of each array's
    largest magnitude: the gselect posteriors (f32 loglikes of another
    summation order) agree within 1e-6, and A and B are f64 sums of
    them;
  - `ivector-extractor-est` and `fgmm-global-est` from the same
    statistics within SOLVE_REL (Cholesky where JAX calls solve and
    inv: the condition number times the f64 roundoff);
  - `ivector-extract` (per utterance and per speaker) and a whole
    `train-ivector-extractor` within EM_REL of the largest magnitude
    (test_torch_ivector.py's whole-run bound: f32 gselect loglikes feed
    f64 EM);
  - `train-ubm`, diagonal and full, within UBM_REL (test_torch_sre.py's
    v1 pipeline bound: device f32 statistics in another order through
    splits and EM);
  - `logistic-regression-train` within 1e-5 (test_torch_logistic_
    regression.py, step for step at lr 0.5: its final loss overshoots
    at width, ROADMAP.md §3 B 5, so it is held by its weights here).
test_ivector_cli2.py's, test_cli_sre.py's, test_util_cli.py's and
test_gmm_extra_cli.py's speaker cases, on the port; `fgmm-global-copy`,
`-est` and `-sum-accs`, which no JAX test names, run here too.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.cli import main as jmain
from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark
from test_torch_cli_features import _call, run_both, same_arks, same_bytes
from test_torch_cli_gmm import rel_close, same_files

torch.set_num_threads(2)

POST_REL = 1e-5      # extractor statistics from 1e-6 posteriors
SOLVE_REL = 1e-9     # M-steps and eigenvalue floors from the same stats
EM_REL = 1e-5        # whole extractor runs and their i-vectors
UBM_REL = 1e-3       # UBM EM on the device (test_torch_sre.py's v1)
LR_ATOL = 1e-5       # test_torch_logistic_regression.py


def sre_system(root):
    """JAX-written inputs -> P(name) -> path."""
    P = lambda *n: str(root.joinpath(*n))                    # noqa: E731
    feats, utt2spk = cs.sre_cli_corpus(P)
    F = f"ark:{P('f.ark')}"
    for argv in (
            ["train-ubm", F, P("dubm.npz"), "--num-gauss", "4",
             "--num-iters", "3"],
            ["train-ubm", F, P("fubm.npz"), "--num-gauss", "4",
             "--num-iters", "3", "--full"],
            ["ivector-extractor-init", P("fubm.npz"), P("ext0.npz"),
             "--ivector-dim", "6"],
            ["ivector-extractor-acc-stats", P("ext0.npz"), F, P("acc.npz")],
            ["ivector-extractor-acc-stats", P("ext0.npz"),
             f"ark:{P('f1.ark')}", P("acc1.npz")],
            ["ivector-extractor-est", P("ext0.npz"), P("acc.npz"),
             P("ext1.npz")],
            ["ivector-extract", P("ext1.npz"), F, f"ark:{P('iv.ark')}"],
            ["ivector-mean", f"ark:{P('iv.ark')}", f"ark:{P('spk.ark')}",
             "--spk2utt", P("spk2utt")],
            ["ivector-mean", f"ark:{P('iv.ark')}", f"ark:{P('mean.ark')}"],
            ["train-plda", P("spk2utt"), f"ark:{P('iv.ark')}",
             P("plda.npz"), "--num-iters", "4"],
            ["ivector-compute-lda", f"ark:{P('iv.ark')}", P("utt2spk"),
             P("lda.ark"), "--dim", "3"],
            ["gmm-gselect", P("fubm.npz"), F, P("gsel.txt"), "--n", "3"],
            ["gmm-global-get-post", P("fubm.npz"), F, P("upost.txt"),
             "--n", "3"],
            ["fgmm-global-acc-stats", P("fubm.npz"), F, P("facc.npz")],
            ["logistic-regression-train", f"ark:{P('iv.ark')}",
             P("utt2spk"), P("lr.npz"), "--max-steps", "20"]):
        assert _call(jmain, argv)[1] == 0, argv
    out, code = _call(jmain, ["ivector-plda-scoring", P("plda.npz"),
                              f"ark:{P('spk.ark')}", f"ark:{P('iv.ark')}",
                              P("trials")])
    assert code == 0
    with open(P("scores.txt"), "w") as f:
        for line in out.splitlines():
            e, t, s = line.split()
            f.write(f"{s} {'target' if utt2spk[t] == e else 'nontarget'}\n")
    return P


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    return sre_system(tmp_path_factory.mktemp("sre"))


def _run(sysd, tmp, argv_fn, device=False):
    return run_both(str(tmp), lambda O: argv_fn(sysd, O), device)


def _o(O, *n):
    return os.path.join(O, *n)


def _a(P, name):
    return f"ark:{P(name)}"


# (argv(P, O)) host commands: JAX's files and lines
HOST_CASES = {
    "compute-eer": lambda P, O: ["compute-eer", P("scores.txt")],
    "ivector-extractor-init": lambda P, O: [
        "ivector-extractor-init", P("dubm.npz"), _o(O, "e.npz"),
        "--ivector-dim", "5", "--prior-offset", "50", "--seed", "3"],
    "ivector-extractor-sum-accs": lambda P, O: [
        "ivector-extractor-sum-accs", _o(O, "a.npz"), P("acc.npz"),
        P("acc1.npz")],
    "train-plda": lambda P, O: [
        "train-plda", P("spk2utt"), _a(P, "iv.ark"), _o(O, "p.npz")],
    "ivector-compute-plda": lambda P, O: [
        "ivector-compute-plda", P("spk2utt"), _a(P, "iv.ark"),
        _o(O, "p.npz"), "--num-iters", "3"],
    "ivector-copy-plda": lambda P, O: [
        "ivector-copy-plda", P("plda.npz"), _o(O, "p.npz"),
        "--smoothing", "0.1"],
    "ivector-adapt-plda": lambda P, O: [
        "ivector-adapt-plda", P("plda.npz"), _a(P, "iv.ark"),
        _o(O, "p.npz"), "--within-covar-scale", "0.4"],
    "ivector-plda-scoring": lambda P, O: [
        "ivector-plda-scoring", P("plda.npz"), _a(P, "spk.ark"),
        _a(P, "iv.ark"), P("trials"), "--scores-out", _o(O, "s.txt")],
    "ivector-compute-lda": lambda P, O: [
        "ivector-compute-lda", _a(P, "iv.ark"), P("utt2spk"),
        _o(O, "l.ark"), "--dim", "2"],
    "ivector-transform": lambda P, O: [
        "ivector-transform", P("lda.ark"), _a(P, "iv.ark"),
        f"ark:{_o(O, 't.ark')}"],
    "ivector-compute-dot-products": lambda P, O: [
        "ivector-compute-dot-products", P("pairs"), _a(P, "iv.ark")],
    "ivector-mean": lambda P, O: [
        "ivector-mean", _a(P, "iv.ark"), f"ark:{_o(O, 'm.ark')}",
        "--spk2utt", P("spk2utt")],
    "ivector-mean-global": lambda P, O: [
        "ivector-mean", _a(P, "iv.ark"), f"ark:{_o(O, 'm.ark')}"],
    "ivector-normalize-length": lambda P, O: [
        "ivector-normalize-length", _a(P, "iv.ark"), f"ark:{_o(O, 'n.ark')}"],
    "ivector-normalize-length-no-scaleup": lambda P, O: [
        "ivector-normalize-length", _a(P, "iv.ark"), f"ark:{_o(O, 'n.ark')}",
        "--no-scaleup"],
    "ivector-subtract-global-mean": lambda P, O: [
        "ivector-subtract-global-mean", _a(P, "iv.ark"),
        f"ark:{_o(O, 'c.ark')}"],
    "ivector-subtract-global-mean-given": lambda P, O: [
        "ivector-subtract-global-mean", _a(P, "iv.ark"),
        f"ark:{_o(O, 'c.ark')}", "--mean", P("mean.ark")],
    "ivector-extract-online2": lambda P, O: [
        "ivector-extract-online2", P("ext1.npz"), _a(P, "f.ark"),
        f"ark:{_o(O, 'o.ark')}", "--utt2spk", P("utt2spk"),
        "--ivector-period", "7", "--num-gselect", "3"],
    "ivector-extract-online": lambda P, O: [
        "ivector-extract-online", P("ext1.npz"), _a(P, "f1.ark"),
        f"ark:{_o(O, 'o.ark')}"],
    "ivector-randomize": lambda P, O: [
        "ivector-randomize", _a(P, "ivm.ark"), f"ark:{_o(O, 'r.ark')}",
        "--randomize-prob", "0.6", "--srand", "5"],
    "copy-gselect": lambda P, O: [
        "copy-gselect", P("gsel.txt"), _o(O, "g.txt")],
    "fgmm-global-acc-stats": lambda P, O: [
        "fgmm-global-acc-stats", P("fubm.npz"), _a(P, "f.ark"),
        _o(O, "a.npz")],
    "fgmm-global-acc-stats-post": lambda P, O: [
        "fgmm-global-acc-stats-post", P("fubm.npz"), _a(P, "f.ark"),
        P("upost.txt"), _o(O, "a.npz")],
    "fgmm-global-copy": lambda P, O: [
        "fgmm-global-copy", P("fubm.npz"), _o(O, "u.npz")],
    "fgmm-global-get-frame-likes": lambda P, O: [
        "fgmm-global-get-frame-likes", P("fubm.npz"), _a(P, "f.ark"),
        f"ark:{_o(O, 'l.ark')}"],
    "fgmm-global-info": lambda P, O: ["fgmm-global-info", P("fubm.npz")],
    "fgmm-global-sum-accs": lambda P, O: [
        "fgmm-global-sum-accs", _o(O, "a.npz"), P("facc.npz"),
        P("facc.npz")],
    "fgmm-global-to-gmm": lambda P, O: [
        "fgmm-global-to-gmm", P("fubm.npz"), _o(O, "d.npz")],
    "fgmm-global-init-from-accs": lambda P, O: [
        "fgmm-global-init-from-accs", P("facc.npz"), "3", _o(O, "u.npz"),
        "--min-gaussian-occupancy", "1"],
    "fgmm-global-merge": lambda P, O: [
        "fgmm-global-merge", _o(O, "u.npz"), _o(O, "sizes"), P("fubm.npz"),
        P("dubm.npz")],
    "fgmm-global-mixdown": lambda P, O: [
        "fgmm-global-mixdown", P("fubm.npz"), _o(O, "u.npz"),
        "--mixdown-target", "2", "--gselect", P("gsel.txt")],
    "fgmm-global-mixdown-all-pairs": lambda P, O: [
        "fgmm-global-mixdown", P("dubm.npz"), _o(O, "u.npz"),
        "--mixdown-target", "3"],
    "logistic-regression-eval": lambda P, O: [
        "logistic-regression-eval", P("lr.npz"), _a(P, "iv.ark"),
        f"ark:{_o(O, 'lp.ark')}", "--utt2label", P("utt2spk")],
    "logistic-regression-copy": lambda P, O: [
        "logistic-regression-copy", P("lr.npz"), _o(O, "c.npz")],
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_commands_write_jax_files(sysd, tmp_path, name):
    same_files(_run(sysd, tmp_path, HOST_CASES[name]))


def test_host_arks_are_byte_equal(sysd, tmp_path):
    """The i-vector arks and scores of the host commands, byte for byte
    (paths inside the files aside)."""
    for name in ("ivector-plda-scoring", "ivector-extract-online2",
                 "ivector-randomize", "ivector-subtract-global-mean"):
        same_bytes(_run(sysd, tmp_path / name, HOST_CASES[name]))


# (argv(P, O), close) device commands, each within its module's bound
DEVICE_CASES = {
    "ivector-extractor-acc-stats": (lambda P, O: [
        "ivector-extractor-acc-stats", P("ext0.npz"), _a(P, "f.ark"),
        _o(O, "a.npz"), "--num-gselect", "3"], POST_REL),
    "ivector-extractor-est": (lambda P, O: [
        "ivector-extractor-est", P("ext0.npz"), P("acc.npz"),
        _o(O, "e.npz")], SOLVE_REL),
    "fgmm-global-est": (lambda P, O: [
        "fgmm-global-est", P("fubm.npz"), P("facc.npz"), _o(O, "u.npz"),
        "--min-gaussian-occupancy", "3"], SOLVE_REL),
    "train-ivector-extractor": (lambda P, O: [
        "train-ivector-extractor", P("fubm.npz"), _a(P, "f.ark"),
        _o(O, "e.npz"), "--ivector-dim", "6", "--num-iters", "3",
        "--num-gselect", "4"], EM_REL),
    "train-ubm": (lambda P, O: [
        "train-ubm", _a(P, "f.ark"), _o(O, "u.npz"), "--num-gauss", "4",
        "--num-iters", "3"], UBM_REL),
    "train-ubm-full": (lambda P, O: [
        "train-ubm", _a(P, "f.ark"), _o(O, "u.npz"), "--num-gauss", "4",
        "--num-iters", "3", "--full", "--full-iters", "2"], UBM_REL),
    "logistic-regression-train": (lambda P, O: [
        "logistic-regression-train", _a(P, "iv.ark"), P("utt2spk"),
        _o(O, "lr.npz"), "--max-steps", "30", "--normalizer", "0.01"],
        None),
}


@pytest.mark.parametrize("name", sorted(DEVICE_CASES))
def test_device_commands_within_bound(sysd, tmp_path, name):
    argv, rel = DEVICE_CASES[name]
    res = _run(sysd, tmp_path, argv, device=True)
    if rel is None:      # logistic regression: weights, printed loss
        (jd, jout, jc), (td, tout, tc) = res["jax"], res["port"]
        assert jc == tc == 0
        zj, zt = np.load(_o(jd, "lr.npz")), np.load(_o(td, "lr.npz"))
        assert zt["weights"].dtype == zj["weights"].dtype
        np.testing.assert_allclose(zt["weights"], zj["weights"], rtol=0,
                                   atol=LR_ATOL)
        assert np.array_equal(zt["classes"], zj["classes"])
        lj, lt = (float(o.split("final loss")[1]) for o in (jout, tout))
        assert lt == pytest.approx(lj, rel=1e-5, abs=1.5e-4)
        return
    same_files(res, close=rel_close(rel))


@pytest.mark.parametrize("spk", [False, True])
def test_ivector_extract_within_bound(sysd, tmp_path, spk):
    """Per utterance and per speaker (statistics summed over the
    speaker's utterances), within EM_REL of the largest magnitude."""
    res = _run(sysd, tmp_path, lambda P, O: [
        "ivector-extract", P("ext1.npz"), _a(P, "f.ark"),
        f"ark:{_o(O, 'iv.ark')}", "--num-gselect", "3"]
        + (["--spk2utt", P("spk2utt")] if spk else []), device=True)
    assert res["jax"][1] == res["port"][1]
    want = np.stack([v for _k, v in read_ark(_o(res["jax"][0], "iv.ark"))])

    def close(g, w, k):
        assert np.abs(g.astype(np.float64) - w).max() <= \
            EM_REL * np.abs(want).max(), k
    same_arks(res, "iv.ark", close)


def test_port_files_load_in_jax_and_back(sysd, tmp_path):
    """The extractor, UBM, PLDA and accumulators the port writes load in
    JAX and give JAX's i-vectors from JAX's statistics path."""
    from kaldi_tpu.io import model_io as jio
    from kaldi_tpu_torch.io import model_io as tio
    res = _run(sysd, tmp_path, DEVICE_CASES["ivector-extractor-est"][0],
               device=True)
    ext_t = jio.load_ivector_extractor(_o(res["port"][0], "e.npz"))
    ext_j = jio.load_ivector_extractor(_o(res["jax"][0], "e.npz"))
    x = next(iter(read_ark(sysd("f.ark"))))[1].astype(np.float64)
    post = ext_j.frame_posteriors(x, 3)
    g, X = ext_j.utterance_stats(x, post)
    a, b = ext_t.extract(g, X)[0], ext_j.extract(g, X)[0]
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=SOLVE_REL * 1e3 * np.abs(b).max())
    back = tio.load_ivector_extractor(_o(res["jax"][0], "e.npz"))
    assert back.M.shape == ext_j.M.shape
    assert tio.load_plda(sysd("plda.npz")).psi.shape == \
        jio.load_plda(sysd("plda.npz")).psi.shape


def test_sre10_chain_through_the_port(sysd, tmp_path):
    """sid/train_ivector_extractor.sh as primitives (init -> sharded
    acc-stats -> sum -> est, twice) then extract -> mean -> subtract ->
    normalize -> PLDA -> scoring -> EER, through the port alone: the
    shards sum to the unsharded statistics, and same-speaker trials
    outscore the others on average."""
    from kaldi_tpu_torch import cli as tcli
    P, O = sysd, str(tmp_path)
    F, F1 = _a(P, "f.ark"), _a(P, "f1.ark")
    feats = dict(read_ark(P("f.ark")))
    write_ark(_o(O, "f2.ark"), dict(list(feats.items())[8:]))

    def run(argv):
        assert _call(tcli.main, argv + (
            ["--device", "cpu"] if argv[0] in tcli.DEVICE_COMMANDS
            else []))[1] == 0, argv
    run(["ivector-extractor-init", P("fubm.npz"), _o(O, "e0.npz"),
         "--ivector-dim", "6"])
    for it in range(2):
        e = _o(O, f"e{it}.npz")
        run(["ivector-extractor-acc-stats", e, F1, _o(O, "a1.npz")])
        run(["ivector-extractor-acc-stats", e, f"ark:{_o(O, 'f2.ark')}",
             _o(O, "a2.npz")])
        run(["ivector-extractor-sum-accs", _o(O, "a.npz"), _o(O, "a1.npz"),
             _o(O, "a2.npz")])
        run(["ivector-extractor-acc-stats", e, F, _o(O, "all.npz")])
        np.testing.assert_allclose(np.load(_o(O, "a.npz"))["A"],
                                   np.load(_o(O, "all.npz"))["A"],
                                   rtol=1e-9)
        run(["ivector-extractor-est", e, _o(O, "a.npz"),
             _o(O, f"e{it + 1}.npz")])
    iv = f"ark:{_o(O, 'iv.ark')}"
    for argv in (
            ["ivector-extract", _o(O, "e2.npz"), F, iv],
            ["ivector-mean", iv, f"ark:{_o(O, 'm.ark')}"],
            ["ivector-subtract-global-mean", iv, f"ark:{_o(O, 'c.ark')}",
             "--mean", _o(O, "m.ark")],
            ["ivector-normalize-length", f"ark:{_o(O, 'c.ark')}",
             f"ark:{_o(O, 'n.ark')}"],
            ["ivector-mean", f"ark:{_o(O, 'n.ark')}",
             f"ark:{_o(O, 's.ark')}", "--spk2utt", P("spk2utt")],
            ["ivector-compute-plda", P("spk2utt"), f"ark:{_o(O, 'n.ark')}",
             _o(O, "p.npz")],
            ["ivector-plda-scoring", _o(O, "p.npz"),
             f"ark:{_o(O, 's.ark')}", f"ark:{_o(O, 'n.ark')}", P("trials"),
             "--scores-out", _o(O, "sc.txt")]):
        run(argv)
    utt2spk = dict(line.split() for line in open(P("utt2spk")))
    tgt, non = [], []
    for line in open(_o(O, "sc.txt")):
        e, t, s = line.split()
        (tgt if utt2spk[t] == e else non).append(float(s))
    assert np.isfinite(tgt + non).all() and np.mean(tgt) > np.mean(non)
