"""Port parity: the CLI's fourth slice, the nnet2 egs pipeline and model
life cycle (kaldi_tpu_torch/cli.py) against kaldi_tpu's CLI, on the CPU,
over files that JAX wrote (`nnet2_system`: tests/test_gmmbin_cli.py's
`_tiny_corpus` of 12 yesno utterances, JAX's train-mono model, its
alignments and graph, JAX's egs, a JAX-initialised TDNN and two JAX SGD
jobs from it).
- The egs commands (nnet-get-egs, nnet-copy-egs, nnet-shuffle-egs,
  nnet-subset-egs and their nnet3 names, nnet3-merge-egs) draw from
  numpy: JAX's archives byte for byte, and JAX's stderr.
- nnet-am-info, nnet-am-copy, nnet-am-average are host: JAX's bytes.
- nnet-am-init (and its alias nnet-init) draws from a torch.Generator:
  held by outcome at width 256: JAX's config and shapes, a zero output
  layer, each hidden layer's weight and bias stddev within 4/sqrt(n) of
  JAX's draw's (`std_ratio_ok`: n draws each, 4 standard deviations of
  the ratio of two sample stddevs).
- nnet-train-simple from JAX's init: each leaf within 1e-5 of its
  largest |value| (chip_smoke.TRAIN_LIMITS["f32"]: JAX's permutations
  and tail padding, the same f32 steps).
- nnet-combine-fast and its three aliases: each leaf within 1e-4
  (tests/test_torch_surgery.py's combine bound: 50 Adam steps on the
  weight logits), the valid loss within 1e-4.
- nnet-adjust-priors averages posteriors: the priors within the bound
  that the two packages' log-posteriors' largest difference sets
  (`posterior_bound`: |exp a - exp b| <= |a - b| for a, b <= 0,
  averaged over frames, plus the f64 sum's rounding); the weights are
  the input's.
- nnet-latgen-faster (and -parallel) on JAX's model: JAX's words and
  lattices within tests/test_torch_lattice.py's `_same_lattice` bound.
- The port alone runs steps/nnet2/train_multisplice_accel2.sh's
  protocol through its files (tests/test_nnet2_cli.py's chain at a
  tenth of its width): WER 0 on the corpus, as JAX's chain reaches.
"""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import main as jmain
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io.kaldi_io import read_ark
from kaldi_tpu_torch.lat.io import read_lattice_ark
from test_gmmbin_cli import _tiny_corpus
from test_torch_cli_features import _call, run_both, same_bytes
from test_torch_cli_gmm import rel_close, same_files, same_leaves
from test_torch_lattice import _same_lattice

torch.set_num_threads(2)

TRAIN_REL = 1e-5        # chip_smoke.TRAIN_LIMITS["f32"]: of each leaf's max
COMBINE_REL = 1e-4      # tests/test_torch_surgery.py's combine bound
SPLICE = "-1,0,1;-1,1"  # left 2, right 2
CTX = ["--left-context", "2", "--right-context", "2", "--chunk", "8"]
NET = [f"--splice-indexes={SPLICE}", "--hidden-dim", "32",
       "--pnorm-output-dim", "8"]
TRAIN = ["--num-epochs", "2", "--minibatch-size", "32",
         "--initial-lr", "0.05", "--final-lr", "0.01"]
SEARCH = ["--beam", "14", "--max-active", "64", "--lattice-beam", "7"]


def jok(argv):
    out, code = _call(jmain, argv)
    assert code == 0, (argv, out)
    return out


def tok(argv, device=True):
    out, code = _call(tcli.main, argv + (["--device", "cpu"]
                                         if device else []))
    assert code == 0, (argv, out)
    return out


def few_utts(P, n: int = 3):
    """few.ark: the corpus' first n utterances (JAX's per-utterance
    forwards compile once per length)."""
    from kaldi_tpu_torch.io.kaldi_io import write_ark
    feats = list(read_ark(P("feats.ark")))[:n]
    write_ark(P("few.ark"), dict(feats))


def nnet2_system(root):
    """JAX-written inputs -> P(name) -> path: the corpus, mono.npz,
    ali.ark, hclg.npz, few.ark, egs/ (2 archives), nn0.npz
    (nnet-am-init), nn1.npz / nn2.npz (nnet-train-simple on two
    shuffles), avg.npz."""
    _tiny_corpus(root, n_utts=12, seed=3)
    P = lambda *n: str(root.joinpath(*n))                    # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    few_utts(P)
    for argv in (
            ["train-mono", P("lexicon.txt"), P("text"), feats, P("mono.npz"),
             "--num-iters", "6", "--totgauss", "40"],
            ["gmm-align", P("mono.npz"), P("text"), feats,
             f"ark:{P('ali.ark')}"],
            ["mkgraph", P("mono.npz"), P("lm.arpa"), P("hclg.npz")],
            ["nnet-get-egs", P("mono.npz"), feats, f"ark:{P('ali.ark')}",
             P("egs"), "--num-archives", "2"] + CTX,
            ["nnet-am-init", P("mono.npz"), feats, P("nn0.npz")] + NET,
            ["nnet-shuffle-egs", P("egs"), P("egs_j1"), "--seed", "11"],
            ["nnet-shuffle-egs", P("egs"), P("egs_j2"), "--seed", "22"],
            ["nnet-train-simple", P("nn0.npz"), P("egs_j1"),
             P("nn1.npz")] + TRAIN,
            ["nnet-train-simple", P("nn0.npz"), P("egs_j2"),
             P("nn2.npz")] + TRAIN,
            ["nnet-am-average", P("avg.npz"), P("nn1.npz"), P("nn2.npz")],
            ["nnet-subset-egs", P("egs"), P("valid"), "--n", "20",
             "--randomize"]):
        jok(argv)
    return P


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    return nnet2_system(tmp_path_factory.mktemp("nnet2_sys"))


def _run(sysd, tmp, argv_fn, device=False):
    return run_both(str(tmp), lambda O: argv_fn(sysd, O), device)


def _o(O, *n):
    return os.path.join(O, *n)


EGS_CASES = {
    "nnet-get-egs": lambda P, O: [
        "nnet-get-egs", P("mono.npz"), f"ark:{P('feats.ark')}",
        f"ark:{P('ali.ark')}", _o(O, "egs"), "--num-archives", "2",
        "--seed", "5"] + CTX,
    "nnet3-get-egs": lambda P, O: [
        "nnet3-get-egs", P("mono.npz"), f"ark:{P('feats.ark')}",
        f"ark:{P('ali.ark')}", _o(O, "egs"), "--no-compress"] + CTX,
    "nnet-copy-egs": lambda P, O: [
        "nnet-copy-egs", P("egs"), _o(O, "egs"), "--num-archives", "3"],
    "nnet3-copy-egs": lambda P, O: ["nnet3-copy-egs", P("egs"), _o(O, "e")],
    "nnet3-merge-egs": lambda P, O: [
        "nnet3-merge-egs", P("egs"), _o(O, "e"), "--num-archives", "2"],
    "nnet-shuffle-egs": lambda P, O: [
        "nnet-shuffle-egs", P("egs"), _o(O, "e"), "--num-archives", "2",
        "--seed", "7"],
    "nnet3-shuffle-egs": lambda P, O: [
        "nnet3-shuffle-egs", P("egs"), _o(O, "e"), "--seed", "3"],
    "nnet-subset-egs": lambda P, O: [
        "nnet-subset-egs", P("egs"), _o(O, "e"), "--n", "17",
        "--randomize", "--seed", "4"],
    "nnet3-subset-egs": lambda P, O: [
        "nnet3-subset-egs", P("egs"), _o(O, "e"), "--n", "9"],
}


@pytest.mark.parametrize("name", sorted(EGS_CASES))
def test_egs_commands_write_jax_bytes(sysd, tmp_path, name):
    same_bytes(_run(sysd, tmp_path, EGS_CASES[name]))


HOST_CASES = {
    "nnet-am-info": lambda P, O: ["nnet-am-info", P("nn1.npz")],
    "nnet-am-copy": lambda P, O: ["nnet-am-copy", P("nn1.npz"),
                                  _o(O, "c.npz")],
    "nnet-am-average": lambda P, O: [
        "nnet-am-average", _o(O, "a.npz"), P("nn1.npz"), P("nn2.npz"),
        P("nn0.npz")],
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_model_commands_write_jax_bytes(sysd, tmp_path, name):
    same_bytes(_run(sysd, tmp_path, HOST_CASES[name]))


@pytest.mark.parametrize("name", ["nnet-am-init", "nnet-init"])
def test_am_init_matches_jax_by_outcome(sysd, tmp_path, name):
    """Random weights from a torch.Generator: JAX's config, names and
    shapes, uniform priors, a zero output layer, each hidden layer's
    stddev within 10% of JAX's draw, and the file loads in JAX."""
    from kaldi_tpu.io.model_io import load_am_nnet as jload
    res = _run(sysd, tmp_path, lambda P, O: [
        name, P("mono.npz"), f"ark:{P('feats.ark')}", _o(O, "nn.npz"),
        "--seed", "3", f"--splice-indexes={SPLICE}", "--hidden-dim", "256"])
    (jd, jout, jcode), (td, tout, tcode) = res["jax"], res["port"]
    assert jcode == tcode == 0 and jout == tout
    zj, zt = np.load(_o(jd, "nn.npz")), np.load(_o(td, "nn.npz"))
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
        if k.startswith("layer"):
            assert std_ratio_ok(zt[k], zj[k]), k
        else:
            assert np.array_equal(zt[k], zj[k]), k
    assert jload(_o(td, "nn.npz")).num_pdfs == \
        jload(_o(jd, "nn.npz")).num_pdfs


@pytest.mark.parametrize("alias", ["nnet-train-simple", "nnet-train-parallel",
                                   "nnet-train-perutt"])
def test_train_simple_matches_jax_step_for_step(sysd, tmp_path, alias):
    """From JAX's init on JAX's shuffled egs: every leaf within TRAIN_REL
    of its largest |value|, the priors carried, JAX's stderr line."""
    res = _run(sysd, tmp_path, lambda P, O: [
        alias, P("nn0.npz"), P("egs_j1"), _o(O, "nn.npz")] + TRAIN,
        device=True)
    same_files(res, close=rel_close(TRAIN_REL), printed=False)


@pytest.mark.parametrize("alias", ["nnet-combine-fast", "nnet-combine",
                                   "nnet-combine-a", "nnet-am-combine"])
def test_combine_fast_within_bound(sysd, tmp_path, alias):
    res = _run(sysd, tmp_path, lambda P, O: [
        alias, P("valid"), _o(O, "c.npz"), P("nn1.npz"), P("nn2.npz"),
        P("avg.npz"), "--num-steps", "20"], device=True)
    same_files(res, close=rel_close(COMBINE_REL), printed=False)
    (jd, jout, _), (td, tout, _) = res["jax"], res["port"]
    want = float(jout.split("valid loss")[1])
    assert float(tout.split("valid loss")[1]) == pytest.approx(
        want, rel=COMBINE_REL, abs=1e-4)


def std_ratio_ok(got, want) -> bool:
    """Two independent draws of one law: the ratio of their sample
    stddevs within 4 / sqrt(n) of 1 (the ratio's standard deviation is
    about 1 / sqrt(n) for n draws each)."""
    return abs(float(got.std()) / float(want.std()) - 1.0) \
        <= 4.0 / np.sqrt(got.size)


def posterior_bound(port_ark: str, jax_ark: str) -> float:
    """The largest difference of the two packages' log-posteriors over
    an ark: an average of posteriors moves at most that much
    (|exp a - exp b| <= |a - b| for a, b <= 0), plus the f64 sum's
    rounding over the frames (1e-12)."""
    want = dict(read_ark(jax_ark))
    got = dict(read_ark(port_ark))
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k].astype(np.float64) - want[k]).max())
               for k in want) + 1e-12


def test_adjust_priors_within_the_posteriors_bound(sysd, tmp_path):
    P = sysd
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet-adjust-priors", P("nn1.npz"), f"ark:{P('few.ark')}",
        _o(O, "p.npz")], device=True)
    jok(["nnet-am-compute", P("nn1.npz"), f"ark:{P('few.ark')}",
         f"ark:{tmp_path / 'jlp.ark'}"])
    tok(["nnet-am-compute", P("nn1.npz"), f"ark:{P('few.ark')}",
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
        elif zj[k].dtype.kind == "f":
            rel_close(TRAIN_REL)(k, zt[k], zj[k])
        else:
            assert np.array_equal(zt[k], zj[k]), k


@pytest.mark.parametrize("alias", ["nnet-latgen-faster",
                                   "nnet-latgen-faster-parallel"])
def test_latgen_faster_matches_jax(sysd, tmp_path, alias):
    res = _run(sysd, tmp_path, lambda P, O: [
        alias, P("mono.npz"), P("nn1.npz"), P("hclg.npz"),
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


def test_nnet2_recipe_through_the_port_files(sysd, tmp_path):
    """steps/nnet2/train_multisplice_accel2.sh's protocol (as
    tests/test_nnet2_cli.py drives it) through the port's files alone:
    egs, init, two SGD jobs, average, combine, compute-prob,
    show-progress, adjust-priors, am-info, then nnet-latgen-faster ->
    lattice-best-path -> compute-wer at WER 0."""
    P = sysd
    W = lambda *n: str(tmp_path.joinpath(*n))                # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    tok(["nnet-get-egs", P("mono.npz"), feats, f"ark:{P('ali.ark')}",
         W("egs"), "--num-archives", "2"] + CTX, device=False)
    tok(["nnet-subset-egs", W("egs"), W("valid"), "--n", "24",
         "--randomize"], device=False)
    tok(["nnet-am-init", P("mono.npz"), feats, W("nn0.npz"),
         f"--splice-indexes={SPLICE}", "--hidden-dim", "64",
         "--pnorm-output-dim", "16"], device=False)
    for job in (1, 2):
        tok(["nnet-shuffle-egs", W("egs"), W(f"egs{job}"), "--seed",
             str(job)], device=False)
        tok(["nnet-train-simple", W("nn0.npz"), W(f"egs{job}"),
             W(f"nn{job}.npz"), "--num-epochs", "24", "--minibatch-size",
             "32", "--initial-lr", "0.1", "--final-lr", "0.01"])
    tok(["nnet-am-average", W("avg.npz"), W("nn1.npz"), W("nn2.npz")],
        device=False)
    tok(["nnet-combine-fast", W("valid"), W("comb.npz"), W("nn1.npz"),
         W("nn2.npz"), W("avg.npz")])
    before = tok(["nnet-compute-prob", W("nn0.npz"), W("valid")])
    after = tok(["nnet-compute-prob", W("comb.npz"), W("valid")])
    assert float(after.split()[1]) > float(before.split()[1]) + 0.5
    assert "param-change" in tok(["nnet-show-progress", W("nn0.npz"),
                                  W("comb.npz"), W("valid")])
    tok(["nnet-adjust-priors", W("comb.npz"), feats, W("final.npz")])
    assert "left-context 2" in tok(["nnet-am-info", W("final.npz")],
                                   device=False)
    tok(["nnet-latgen-faster", P("mono.npz"), W("final.npz"), P("hclg.npz"),
         feats, "--lattice-out", W("lat.ark")] + SEARCH)
    assert wer_of_lattices(P, W("lat.ark"), tmp_path) == 0.0


def wer_of_lattices(P, lat_ark, tmp_path) -> float:
    """lattice-best-path over `lat_ark` (word ids), the ids as words of
    mono.npz's table, compute-wer against the corpus' text."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    sym = load_gmm_system(P("mono.npz"), device="cpu").lang.words.sym
    hyp = str(tmp_path / "hyp_words.txt")
    with open(hyp, "w") as f:
        for line in tok(["lattice-best-path", lat_ark],
                        device=False).splitlines():
            key, *ids = line.split()
            f.write(" ".join([key] + [sym(int(w)) for w in ids]) + "\n")
    line = tok(["compute-wer", P("text"), hyp], device=False)
    return float(line.split()[1])
