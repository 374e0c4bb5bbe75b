"""Port parity: the CLI's fourth slice, nnet3 (kaldi_tpu_torch/cli.py and
the nnet3 tools of cli_tail.py) against kaldi_tpu's CLI, on the CPU,
over files that JAX wrote (`nnet3_system`: tests/test_gmmbin_cli.py's
`_tiny_corpus` of 12 yesno utterances, JAX's train-mono model, its
alignments and graph, a p-norm TDNN config from JAX's
`make_tdnn_config`, JAX's nnet3-init model, egs and two nnet3-train
jobs from it).
- Host commands write JAX's bytes and print JAX's lines: nnet3-info
  (and nnet3-am-info), nnet3-copy with and without --scale (and
  nnet3-am-copy), nnet3-average, nnet3-acc-lda-stats.
- nnet3-init (and nnet3-am-init) draws from a torch.Generator: held by
  outcome, JAX's config text, parameter names, shapes and zero leaves,
  each drawn leaf's stddev within 4/sqrt(n) of JAX's draw's (n draws:
  4 standard deviations of the ratio of two sample stddevs).
- nnet3-train from JAX's init: every leaf within 1e-4 of its largest
  |value| (chip_smoke.TRAIN_LIMITS["ng_sgd"]: NG-SGD's eigendecomposition
  in LAPACK on both sides, summed in another order).
- nnet3-combine within 1e-4 of each leaf (tests/test_torch_surgery.py).
- nnet3-compute (plain and --use-priors) and nnet3-compute-from-egs
  within 1e-5 (tests/test_torch_nnet3.py's forward bound).
- nnet3-compute-prob and nnet3-show-progress: the objectives printed at
  4 decimals within 1.5e-4 (one unit of the last printed digit from
  rounding, plus the 1e-5 forward bound); show-progress's
  parameter-change line is host and equal.
- nnet3-am-adjust-priors: the priors within the bound that the two
  packages' log-posteriors' largest difference sets.
- nnet3-latgen-faster: JAX's words and lattices within
  tests/test_torch_lattice.py's `_same_lattice` bound.
- The port alone runs steps/nnet3/train_tdnn.sh's protocol through its
  files (tests/test_nnet3_cli.py's chain at half its width):
  WER 0 through nnet3-latgen-faster and through nnet3-compute ->
  decode-faster-mapped.
"""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.lat.io import read_lattice_ark
from test_gmmbin_cli import _tiny_corpus
from test_torch_cli_features import run_both, same_arks, same_bytes, tol
from test_torch_cli_gmm import rel_close, same_files, same_leaves
from test_torch_cli_nnet2 import (SEARCH, few_utts, jok, posterior_bound,
                                  std_ratio_ok, tok, wer_of_lattices)
from test_torch_lattice import _same_lattice

torch.set_num_threads(2)

NG_REL = 1e-4           # chip_smoke.TRAIN_LIMITS["ng_sgd"]
COMBINE_REL = 1e-4      # tests/test_torch_surgery.py's combine bound
FWD = dict(rtol=1e-5, atol=1e-5)     # tests/test_torch_nnet3.py
PRINTED = 1.5e-4        # 4 printed decimals plus the forward bound
SPLICE = ((-1, 0, 1), (-1, 1))
CTX = ["--left-context", "2", "--right-context", "2", "--chunk", "8"]
TRAIN = ["--num-epochs", "2", "--minibatch-size", "32",
         "--initial-lr", "0.05", "--final-lr", "0.01"]


def tdnn_config(P, hidden: int) -> str:
    """make_tdnn_config (the port's copy, JAX's text) over mono.npz's
    pdfs."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.nnet3.configs import make_tdnn_config
    pdfs = load_gmm_system(P("mono.npz"), device="cpu").am.num_pdfs
    return make_tdnn_config(39, pdfs, splice_indexes=SPLICE,
                            hidden_dim=hidden,
                            nonlinearity="PnormComponent",
                            pnorm_output_dim=hidden // 4)


def nnet3_system(root):
    """JAX-written inputs -> P(name) -> path: the corpus, mono.npz,
    ali.ark, hclg.npz, few.ark, tdnn.config, n0.npz (nnet3-init), egs/,
    n1.npz / n2.npz (nnet3-train on two shuffles), avg.npz, valid/."""
    from kaldi_tpu.nnet3.configs import make_tdnn_config as jconfig
    _tiny_corpus(root, n_utts=12, seed=5)
    P = lambda *n: str(root.joinpath(*n))                    # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    few_utts(P)
    for argv in (
            ["train-mono", P("lexicon.txt"), P("text"), feats, P("mono.npz"),
             "--num-iters", "6", "--totgauss", "40"],
            ["gmm-align", P("mono.npz"), P("text"), feats,
             f"ark:{P('ali.ark')}"],
            ["mkgraph", P("mono.npz"), P("lm.arpa"), P("hclg.npz")]):
        jok(argv)
    from kaldi_tpu.io.model_io import load_gmm_system
    text = jconfig(39, load_gmm_system(P("mono.npz")).am.num_pdfs,
                   splice_indexes=SPLICE, hidden_dim=32,
                   nonlinearity="PnormComponent", pnorm_output_dim=8)
    assert text == tdnn_config(P, 32)
    with open(P("tdnn.config"), "w") as f:
        f.write(text)
    for argv in (
            ["nnet3-init", P("tdnn.config"), P("n0.npz")],
            ["nnet3-get-egs", P("mono.npz"), feats, f"ark:{P('ali.ark')}",
             P("egs")] + CTX,
            ["nnet3-shuffle-egs", P("egs"), P("egs_j1"), "--seed", "11"],
            ["nnet3-shuffle-egs", P("egs"), P("egs_j2"), "--seed", "22"],
            ["nnet3-train", P("n0.npz"), P("egs_j1"), P("n1.npz")] + TRAIN,
            ["nnet3-train", P("n0.npz"), P("egs_j2"), P("n2.npz")] + TRAIN,
            ["nnet3-average", P("avg.npz"), P("n1.npz"), P("n2.npz")],
            ["nnet3-subset-egs", P("egs"), P("valid"), "--n", "20",
             "--randomize"]):
        jok(argv)
    return P


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    return nnet3_system(tmp_path_factory.mktemp("nnet3_sys"))


def _run(sysd, tmp, argv_fn, device=False):
    return run_both(str(tmp), lambda O: argv_fn(sysd, O), device)


def _o(O, *n):
    return os.path.join(O, *n)


HOST_CASES = {
    "nnet3-info": lambda P, O: ["nnet3-info", P("n1.npz")],
    "nnet3-am-info": lambda P, O: ["nnet3-am-info", P("n0.npz")],
    "nnet3-copy": lambda P, O: ["nnet3-copy", P("n1.npz"), _o(O, "c.npz")],
    "nnet3-copy --scale": lambda P, O: [
        "nnet3-copy", P("n0.npz"), _o(O, "c.npz"), "--scale", "0.37"],
    "nnet3-am-copy": lambda P, O: ["nnet3-am-copy", P("avg.npz"),
                                   _o(O, "c.npz")],
    "nnet3-average": lambda P, O: [
        "nnet3-average", _o(O, "a.npz"), P("n1.npz"), P("n2.npz"),
        P("n0.npz")],
    "nnet3-acc-lda-stats": lambda P, O: [
        "nnet3-acc-lda-stats", P("egs"), _o(O, "lda.npz")],
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_commands_write_jax_bytes(sysd, tmp_path, name):
    same_bytes(_run(sysd, tmp_path, HOST_CASES[name]))


@pytest.mark.parametrize("name", ["nnet3-init", "nnet3-am-init"])
def test_init_matches_jax_by_outcome(sysd, tmp_path, name):
    """Random weights from a torch.Generator at width 256: JAX's config
    text and names, shapes and dtypes, the zero leaves zero, each drawn
    leaf's stddev within std_ratio_ok's bound of JAX's; JAX loads it."""
    from kaldi_tpu.io.model_io import load_am_nnet3 as jload
    with open(tmp_path / "wide.config", "w") as f:
        f.write(tdnn_config(sysd, 256))
    res = _run(sysd, tmp_path, lambda P, O: [
        name, str(tmp_path / "wide.config"), _o(O, "n.npz"), "--seed", "4"])
    (jd, jout, jcode), (td, tout, tcode) = res["jax"], res["port"]
    assert jcode == tcode == 0 and jout == tout
    zj, zt = np.load(_o(jd, "n.npz")), np.load(_o(td, "n.npz"))
    assert zj.files == zt.files
    for k in zj.files:
        assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
        if k.startswith("param:") and zj[k].std() > 0:
            assert std_ratio_ok(zt[k], zj[k]), k
        else:
            assert np.array_equal(zt[k], zj[k]), k
    assert jload(_o(td, "n.npz")).num_pdfs == jload(_o(jd, "n.npz")).num_pdfs


def test_train_matches_jax_step_for_step(sysd, tmp_path):
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet3-train", P("n0.npz"), P("egs_j1"), _o(O, "n.npz")] + TRAIN,
        device=True)
    same_files(res, close=rel_close(NG_REL), printed=False)


def test_combine_within_bound(sysd, tmp_path):
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet3-combine", P("valid"), _o(O, "c.npz"), P("n1.npz"),
        P("n2.npz"), P("avg.npz"), "--num-steps", "20"], device=True)
    same_files(res, close=rel_close(COMBINE_REL), printed=False)


@pytest.mark.parametrize("extra", [[], ["--use-priors"]])
def test_compute_within_bound(sysd, tmp_path, extra):
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet3-compute", P("avg.npz"), f"ark:{P('few.ark')}",
        f"ark:{_o(O, 'y.ark')}"] + extra, device=True)
    same_arks(res, "y.ark", tol(**FWD))


def test_compute_from_egs_within_bound(sysd, tmp_path):
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet3-compute-from-egs", P("n1.npz"), P("valid"),
        f"ark:{_o(O, 'y.ark')}", "--max-examples", "7"], device=True)
    same_arks(res, "y.ark", tol(**FWD))


def _numbers(text: str) -> list:
    out = []
    for tok_ in text.replace("(", " ").replace(")", " ").split():
        try:
            out.append(float(tok_))
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("name", ["nnet3-compute-prob",
                                  "nnet3-show-progress"])
def test_printed_objectives_within_bound(sysd, tmp_path, name):
    argv = {"nnet3-compute-prob": lambda P, O: [
                name, P("n1.npz"), P("valid")],
            "nnet3-show-progress": lambda P, O: [
                name, P("n0.npz"), P("n1.npz"), P("valid")]}[name]
    res = _run(sysd, tmp_path, argv, device=True)
    (_jd, jout, jc), (_td, tout, tc) = res["jax"], res["port"]
    assert jc == tc == 0
    jl, tl = jout.splitlines(), tout.splitlines()
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if "parameter-change" in a:
            assert a == b
        np.testing.assert_allclose(_numbers(b), _numbers(a), rtol=0,
                                   atol=PRINTED)


def test_adjust_priors_within_the_posteriors_bound(sysd, tmp_path):
    P = sysd
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet3-am-adjust-priors", P("n1.npz"), f"ark:{P('few.ark')}",
        _o(O, "p.npz")], device=True)
    jok(["nnet3-compute", P("n1.npz"), f"ark:{P('few.ark')}",
         f"ark:{tmp_path / 'jlp.ark'}"])
    tok(["nnet3-compute", P("n1.npz"), f"ark:{P('few.ark')}",
         f"ark:{tmp_path / 'tlp.ark'}"])
    bound = posterior_bound(str(tmp_path / "tlp.ark"),
                            str(tmp_path / "jlp.ark"))
    (jd, _jo, jc), (td, _to, tc) = res["jax"], res["port"]
    assert jc == tc == 0
    zj, zt = np.load(_o(jd, "p.npz")), np.load(_o(td, "p.npz"))
    assert zj.files == zt.files
    same_leaves(zj, zt)
    for k in zj.files:
        if k == "priors":
            assert np.abs(zt[k] - zj[k]).max() <= bound
        else:
            assert np.array_equal(zt[k], zj[k]), k


def test_latgen_faster_matches_jax(sysd, tmp_path):
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet3-latgen-faster", P("mono.npz"), P("n1.npz"), P("hclg.npz"),
        f"ark:{P('feats.ark')}", "--lattice-out", _o(O, "lat.ark"),
        "--transcription-out", _o(O, "hyp.txt")] + SEARCH, device=True)
    (jd, _jo, jc), (td, _to, tc) = res["jax"], res["port"]
    assert jc == tc == 0
    assert open(_o(td, "hyp.txt")).read() == open(_o(jd, "hyp.txt")).read()
    want = dict(read_lattice_ark(_o(jd, "lat.ark")))
    got = dict(read_lattice_ark(_o(td, "lat.ark")))
    assert sorted(got) == sorted(want)
    for k in want:
        _same_lattice(got[k], want[k], k)


def test_nnet3_recipe_through_the_port_files(sysd, tmp_path):
    """steps/nnet3/train_tdnn.sh's protocol (as tests/test_nnet3_cli.py
    drives it) through the port's files alone: the config, nnet3-init,
    egs (get, shuffle, subset, merge), two nnet3-train jobs, average,
    combine, compute-prob, show-progress, adjust-priors, info, then
    WER 0 through nnet3-latgen-faster and through nnet3-compute ->
    decode-faster-mapped."""
    P = sysd
    W = lambda *n: str(tmp_path.joinpath(*n))                # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    with open(W("tdnn.config"), "w") as f:
        f.write(tdnn_config(P, 128))
    tok(["nnet3-init", W("tdnn.config"), W("n0.npz")], device=False)
    assert "left-context 2" in tok(["nnet3-info", W("n0.npz")],
                                   device=False)
    tok(["nnet3-get-egs", P("mono.npz"), feats, f"ark:{P('ali.ark')}",
         W("egs")] + CTX, device=False)
    tok(["nnet3-subset-egs", W("egs"), W("valid"), "--n", "24",
         "--randomize"], device=False)
    for job in (1, 2):
        tok(["nnet3-shuffle-egs", W("egs"), W(f"s{job}"), "--seed",
             str(job)], device=False)
        tok(["nnet3-merge-egs", W(f"s{job}"), W(f"egs{job}")], device=False)
        tok(["nnet3-train", W("n0.npz"), W(f"egs{job}"), W(f"n{job}.npz"),
             "--num-epochs", "60", "--minibatch-size", "32",
             "--initial-lr", "0.1", "--final-lr", "0.01"])
    tok(["nnet3-average", W("avg.npz"), W("n1.npz"), W("n2.npz")],
        device=False)
    tok(["nnet3-combine", W("valid"), W("comb.npz"), W("n1.npz"),
         W("n2.npz"), W("avg.npz")])
    before = tok(["nnet3-compute-prob", W("n0.npz"), W("valid")])
    after = tok(["nnet3-compute-prob", W("comb.npz"), W("valid")])
    assert float(after.split()[1]) > float(before.split()[1]) + 0.5
    assert "parameter-change" in tok(["nnet3-show-progress", W("n0.npz"),
                                      W("comb.npz"), W("valid")])
    tok(["nnet3-am-adjust-priors", W("comb.npz"), feats, W("final.npz")])
    tok(["nnet3-latgen-faster", P("mono.npz"), W("final.npz"),
         P("hclg.npz"), feats, "--lattice-out", W("lat.ark")] + SEARCH)
    assert wer_of_lattices(P, W("lat.ark"), tmp_path) == 0.0
    tok(["nnet3-compute", W("final.npz"), feats, f"ark:{W('ll.ark')}",
         "--use-priors"])
    hyp = tok(["decode-faster-mapped", P("hclg.npz"), f"ark:{W('ll.ark')}"])
    ids = {ln.split()[0]: ln.split()[1:] for ln in hyp.splitlines()}
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    sym = load_gmm_system(P("mono.npz"), device="cpu").lang.words.sym
    with open(W("hyp.txt"), "w") as f:
        for k, ws in ids.items():
            f.write(" ".join([k] + [sym(int(w)) for w in ws]) + "\n")
    wer = tok(["compute-wer", P("text"), W("hyp.txt")], device=False)
    assert wer.startswith("%WER 0.00"), wer
