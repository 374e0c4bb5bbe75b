"""Port parity: the CLI's third slice, lattice tools and n-best lists
(kaldi_tpu_torch/cli.py, cli_tail.py) against kaldi_tpu's CLI, on the
CPU.

Every command here is host code in both packages, so each case runs both
`main`s on the same files and asserts that they write the same bytes,
print the same lines and exit with the same code
(tests/test_torch_cli_features.py's `same_bytes`). The inputs are
JAX-written once per module: tests/test_torch_cli_latgen.py's
`lattice_system` (the yesno corpus, JAX's mono model and the raw
lattices of its `gmm-latgen-faster`), then JAX's determinized lattices,
its 1-best and word-aligned 1-best lattices and an n-best ark; one more
case runs local/score.sh's chain on the files the port wrote at each
step. Every subcommand and alias of items 3-4 of the slice runs at least
once. test_latgen_cli.py's lattice utilities, test_lattice_cli2.py's
toolbox, test_tail_cli.py's set operations and nbest-to-prons,
test_cli_more.py's, test_feat_lattice_extras_cli.py's and
test_cli_leftovers2.py's lattice cases, on the port.
"""

import os

import pytest
import torch

from kaldi_tpu.cli import main as jmain
from kaldi_tpu.lat.io import read_lattice_ark, write_lattice_ark
from kaldi_tpu_torch.io.model_io import load_gmm_system
from test_torch_cli_features import _call, run_both, same_bytes
from test_torch_cli_latgen import lattice_system

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    P = lattice_system(tmp_path_factory.mktemp("lattice"))
    words = load_gmm_system(P("mono.npz"), device="cpu").lang.words
    with open(P("text")) as f, open(P("ref_int.txt"), "w") as g:
        for line in f:
            toks = line.split()
            g.write(" ".join([toks[0]] + [str(words[w]) for w in toks[1:]])
                    + "\n")
    with open(P("lin.txt"), "w") as f:
        f.write("u0-1 3 4 3\nu0-2 4\nu1-1 3\nu1-2 4 4\nu1-3 3 4\n")
    for argv in (
            ["lattice-determinize", P("lat.ark"), P("det.ark")],
            ["lattice-1best", P("lat.ark"), P("one.ark"),
             "--acoustic-scale", "0.1"],
            ["lattice-align-words", P("lexicon.txt"), P("mono.npz"),
             P("one.ark"), P("aligned.ark")],
            ["linear-to-nbest", P("lin.txt"), P("nbest.ark")]):
        assert _call(jmain, argv)[1] == 0, argv
    # the first four utterances' lattices: determinized for the backoff
    # copy (the others fall back to lat.ark), raw for the slower tools
    for name in ("det", "lat"):
        write_lattice_ark(P(f"{name}4.ark"),
                          dict(list(read_lattice_ark(P(f"{name}.ark")))[:4]))
    return P


def _o(d, name="out.ark"):
    return os.path.join(d, name)


SIL = "1"    # the yesno lexicon's SIL phone

# name -> argv_fn(P, out_dir); the alias cases run the alias's name
CASES = {
    "lattice-copy": lambda P, d: [
        "lattice-copy", P("lat.ark"), "--out", _o(d), "--verbose"],
    "lattice-copy-stats": lambda P, d: ["lattice-copy", P("det.ark")],
    "lattice-depth": lambda P, d: ["lattice-depth", P("lat.ark")],
    "lattice-rmali": lambda P, d: ["lattice-rmali", P("lat.ark"), _o(d)],
    "lattice-add-penalty": lambda P, d: [
        "lattice-add-penalty", P("lat.ark"), _o(d),
        "--word-ins-penalty", "0.5"],
    "lattice-best-path": lambda P, d: [
        "lattice-best-path", P("lat.ark"), "--acoustic-scale", "0.1",
        "--lm-scale", "0.8", "--word-ins-penalty", "0.5"],
    "lattice-determinize": lambda P, d: [
        "lattice-determinize", P("lat.ark"), _o(d)],
    "lattice-determinize-pruned": lambda P, d: [
        "lattice-determinize-pruned", P("lat.ark"), _o(d), "--beam", "4"],
    "lattice-determinize-pruned-parallel": lambda P, d: [
        "lattice-determinize-pruned-parallel", P("lat.ark"), _o(d),
        "--beam", "2"],
    "lattice-determinize-phone-pruned": lambda P, d: [
        "lattice-determinize-phone-pruned", P("lat.ark"), _o(d),
        "--beam", "6"],
    "lattice-determinize-phone-pruned-parallel": lambda P, d: [
        "lattice-determinize-phone-pruned-parallel", P("lat.ark"), _o(d),
        "--beam", "3"],
    "lattice-minimize": lambda P, d: [
        "lattice-minimize", P("det.ark"), _o(d)],
    "lattice-prune": lambda P, d: [
        "lattice-prune", P("lat.ark"), _o(d), "--beam", "3"],
    "lattice-push": lambda P, d: ["lattice-push", P("det.ark"), _o(d)],
    "lattice-scale": lambda P, d: [
        "lattice-scale", P("lat.ark"), _o(d), "--acoustic-scale", "0.1",
        "--lm-scale", "0.5"],
    "lattice-to-nbest": lambda P, d: [
        "lattice-to-nbest", P("det.ark"), "--n", "3"],
    "lattice-mbr-decode": lambda P, d: [
        "lattice-mbr-decode", P("lat4.ark")],
    "lattice-oracle": lambda P, d: [
        "lattice-oracle", P("lat.ark"), P("ref_int.txt")],
    "lattice-union": lambda P, d: [
        "lattice-union", P("lat.ark"), P("det4.ark"), _o(d)],
    "lattice-interp": lambda P, d: [
        "lattice-interp", P("lat4.ark"), P("det.ark"), _o(d),
        "--alpha", "0.3"],
    "lattice-to-ctm-conf": lambda P, d: [
        "lattice-to-ctm-conf", P("lat4.ark")],
    "lattice-to-fst": lambda P, d: [
        "lattice-to-fst", P("lat.ark"), _o(d, "fsts.txt"),
        "--acoustic-scale", "0.1", "--lm-scale", "1"],
    "lattice-project": lambda P, d: [
        "lattice-project", P("lat.ark"), _o(d)],
    "lattice-depth-per-frame": lambda P, d: [
        "lattice-depth-per-frame", P("lat.ark")],
    "lattice-confidence": lambda P, d: [
        "lattice-confidence", P("det.ark"), "--max-confidence", "50"],
    "lattice-compose": lambda P, d: [
        "lattice-compose", P("lat.ark"), P("G.txt"), _o(d)],
    "lattice-1best": lambda P, d: [
        "lattice-1best", P("lat.ark"), _o(d), "--acoustic-scale", "0.1"],
    "lattice-to-post": lambda P, d: [
        "lattice-to-post", P("lat.ark"), _o(d, "post.txt")],
    "lattice-to-mpe-post": lambda P, d: [
        "lattice-to-mpe-post", P("mono.npz"), f"ark:{P('ali.ark')}",
        P("lat.ark"), _o(d, "post.txt"), "--silence-phones", SIL],
    "lattice-to-smbr-post": lambda P, d: [
        "lattice-to-smbr-post", P("mono.npz"), f"ark:{P('ali.ark')}",
        P("lat.ark"), _o(d, "post.txt"), "--silence-phones", SIL,
        "--no-one-silence-class"],
    "lattice-boost-ali": lambda P, d: [
        "lattice-boost-ali", P("mono.npz"), P("lat.ark"),
        f"ark:{P('ali.ark')}", _o(d), "--b", "0.1", "--silence-phones", SIL,
        "--max-silence-error", "0.5"],
    "lattice-to-phone-lattice": lambda P, d: [
        "lattice-to-phone-lattice", P("mono.npz"), P("lat4.ark"), _o(d)],
    "lattice-align-phones": lambda P, d: [
        "lattice-align-phones", P("mono.npz"), P("lat4.ark"), _o(d),
        "--replace-output-symbols"],
    "lattice-equivalent": lambda P, d: [
        "lattice-equivalent", P("lat.ark"), P("lat.ark")],
    "lattice-equivalent-differ": lambda P, d: [
        "lattice-equivalent", P("lat.ark"), P("one.ark"), "--delta", "0.01"],
    "lattice-limit-depth": lambda P, d: [
        "lattice-limit-depth", P("lat.ark"), _o(d), "--max-depth", "3"],
    "lattice-align-words": lambda P, d: [
        "lattice-align-words", P("lexicon.txt"), P("mono.npz"), P("lat.ark"),
        _o(d)],
    "lattice-align-words-lexicon": lambda P, d: [
        "lattice-align-words-lexicon", P("lexicon.txt"), P("mono.npz"),
        P("one.ark"), _o(d)],
    "lattice-word-align": lambda P, d: [
        "lattice-word-align", P("lexicon.txt"), P("mono.npz"), P("det.ark"),
        _o(d)],
    "lattice-reverse": lambda P, d: [
        "lattice-reverse", P("lat.ark"), _o(d)],
    "lattice-combine": lambda P, d: [
        "lattice-combine", _o(d), P("lat.ark"), P("det4.ark"),
        P("one.ark")],
    "lattice-copy-backoff": lambda P, d: [
        "lattice-copy-backoff", P("lat.ark"), P("det4.ark"), _o(d)],
    "lattice-difference": lambda P, d: [
        "lattice-difference", P("lat.ark"), P("one.ark"), _o(d)],
    "lattice-expand-ngram": lambda P, d: [
        "lattice-expand-ngram", P("lat.ark"), _o(d), "--n", "2"],
    "nbest-to-linear": lambda P, d: [
        "nbest-to-linear", P("det.ark"), "--n", "3"],
    "nbest-to-ctm": lambda P, d: [
        "nbest-to-ctm", P("aligned.ark"), "--frame-shift", "0.02"],
    "linear-to-nbest": lambda P, d: [
        "linear-to-nbest", P("lin.txt"), _o(d)],
    "nbest-to-lattice": lambda P, d: [
        "nbest-to-lattice", P("nbest.ark"), _o(d)],
    "nbest-to-prons": lambda P, d: [
        "nbest-to-prons", P("mono.npz"), P("aligned.ark"),
        _o(d, "prons.txt")],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lattice_command_writes_jax_bytes(sysd, tmp_path, case):
    same_bytes(run_both(tmp_path, lambda d: CASES[case](sysd, d),
                        device=False))


def test_score_chain_on_the_ports_files(sysd, tmp_path):
    """local/score.sh for one LM weight: lattice-scale, then
    lattice-add-penalty on the port's scaled lattices, then
    lattice-best-path and lattice-oracle on the port's penalized ones,
    JAX's bytes and lines at every step."""
    P = sysd
    src = P("lat.ark")
    for i, argv in enumerate((
            lambda d: ["lattice-scale", src, _o(d), "--acoustic-scale",
                       str(1 / 10)],
            lambda d: ["lattice-add-penalty", src, _o(d),
                       "--word-ins-penalty", "0.5"],
            lambda d: ["lattice-best-path", src],
            lambda d: ["lattice-oracle", src, P("ref_int.txt")])):
        res = run_both(str(tmp_path / str(i)), argv, device=False)
        same_bytes(res)
        if os.listdir(res["port"][0]):
            src = _o(res["port"][0])
