"""Port parity: the CLI's third slice, lattice generation and rescoring
(kaldi_tpu_torch/cli.py) against kaldi_tpu's CLI, on the CPU, over files
that JAX wrote.

The inputs are JAX-written once per module (`lattice_system`):
tests/test_gmmbin_cli.py's `_tiny_corpus` (12 yesno utterances of MFCC +
deltas), JAX's `train-mono` model, its `mkgraph` graph, alignments,
loglikes, G as a text FST, a bigram const-ARPA and the raw lattice ark
of JAX's `gmm-latgen-faster`.
- `latgen-faster-mapped` (and its alias) decodes JAX's loglike file:
  the same int transcriptions and lattices within
  tests/test_torch_lattice.py's `_same_lattice` bound (the same nodes and
  arcs, costs within 1e-4), raw and determinized.
- `gmm-latgen-faster` (and its aliases, with and without per-speaker
  transforms), `gmm-latgen-biglm-faster`, `gmm-decode-biglm-faster` and
  `decode-fmllr` score GMM loglikes in each package's own GEMM and are
  held by words: the same transcription file; the lattices of
  `gmm-latgen-faster` have JAX's keys and best paths.
- `gmm-rescore-lattice` writes JAX's lattice structure, its acoustic
  costs within the loglikes' own rounding (1e-5 of the GEMM terms,
  chip_smoke.gmm_term_scale, summed over an utterance's frames).
- The host commands (`arpa-to-const-arpa`, `lattice-lmrescore`,
  `lattice-lmrescore-const-arpa`, `lattice-rescore-mapped`,
  `lattice-add-trans-probs`) write JAX's bytes and print JAX's lines;
  a const-ARPA file array for array, and either package loads the
  other's.
test_latgen_cli.py's, test_lattice_cli2.py's lmrescore case and
test_cli_more.py's, test_gmm_extras_cli.py's rescoring cases, on the
port.
"""

import io
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.cli import main as jmain
from kaldi_tpu.io import model_io as jmio
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io import model_io as tmio
from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
from kaldi_tpu_torch.lat.functions import lattice_best_path
from kaldi_tpu_torch.lat.io import read_lattice_ark
from test_gmmbin_cli import _tiny_corpus
from test_torch_cli_features import _call, run_both, same_bytes
from test_torch_cli_gmm import same_files
from test_torch_lattice import _same_lattice

torch.set_num_threads(2)

LL_REL = 1e-5        # loglikes: of their GEMM terms (phases 17-20)
BIGRAM_ARPA = """\\data\\
ngram 1=4
ngram 2=6

\\1-grams:
-0.5\t</s>
-99\t<s>\t-0.3
-0.4\tNO\t-0.2
-0.4\tYES\t-0.2

\\2-grams:
-0.2\t<s> NO
-0.3\t<s> YES
-0.4\tNO NO
-0.3\tNO YES
-0.2\tYES NO
-0.5\tYES </s>

\\end\\
"""


SEARCH = ["--beam", "14", "--max-active", "64"]   # a tiny graph's search
LATGEN = SEARCH + ["--lattice-beam", "7"]


def lattice_system(root, n_utts: int = 12, seed: int = 1):
    """JAX-written inputs: the corpus, a train-mono model, its graph,
    alignments, loglikes, words.txt, G.txt, utt2spk (two speakers), a
    bigram ARPA and its const-ARPA, and JAX's `gmm-latgen-faster`: the
    raw lattices (lat.ark) and transcriptions (hyp.txt) of `latgen_argv`.
    -> P(name) -> path."""
    _tiny_corpus(root, n_utts=n_utts, seed=seed)
    P = lambda *n: str(root.joinpath(*n))                    # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    with open(P("bigram.arpa"), "w") as f:
        f.write(BIGRAM_ARPA)
    for argv in (
            ["train-mono", P("lexicon.txt"), P("text"), feats, P("mono.npz"),
             "--num-iters", "6", "--totgauss", "40"],
            ["mkgraph", P("mono.npz"), P("lm.arpa"), P("hclg.npz")],
            ["gmm-align", P("mono.npz"), P("text"), feats,
             f"ark:{P('ali.ark')}"],
            ["gmm-compute-likes", P("mono.npz"), feats,
             f"ark:{P('likes.ark')}"],
            latgen_argv(P, "gmm-latgen-faster", P())):
        assert _call(jmain, argv)[1] == 0, argv
    jmio.load_gmm_system(P("mono.npz")).lang.words.write(P("words.txt"))
    for argv in (["arpa2fst", P("lm.arpa"), P("words.txt"), P("G.txt")],
                 ["arpa-to-const-arpa", P("words.txt"), P("bigram.arpa"),
                  P("bigram.clm.npz")]):
        assert _call(jmain, argv)[1] == 0, argv
    utts = sorted(line.split()[0] for line in open(P("text")))
    with open(P("utt2spk"), "w") as f:
        for i, u in enumerate(utts):
            f.write(f"{u} spk{i % 2}\n")
    return P


def latgen_argv(P, name, out_dir):
    """steps/decode.sh's gmm-latgen-faster on the corpus, writing
    lat.ark and hyp.txt into `out_dir`."""
    return [name, P("mono.npz"), P("hclg.npz"), f"ark:{P('feats.ark')}",
            "--lattice-out", os.path.join(out_dir, "lat.ark"),
            "--transcription-out", os.path.join(out_dir, "hyp.txt")] + LATGEN


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    return lattice_system(tmp_path_factory.mktemp("latgen"))


def run_port(tmp, argv_fn, device: bool = True):
    """The port's half of `run_both`, for an alias held against the JAX
    run of its canonical name: -> (dir, stdout + stderr, code)."""
    d = os.path.join(tmp, "port")
    os.makedirs(d, exist_ok=True)
    err = io.StringIO()
    text, code = _call(tcli.main, argv_fn(d)
                       + (["--device", "cpu"] if device else []), err)
    return d, text + err.getvalue(), code


def _lattices(res, name):
    """-> ({key: JAX's lattice}, {key: the port's}) of the ark `name`."""
    (jd, _jo, jcode), (td, _to, tcode) = res["jax"], res["port"]
    assert jcode == tcode == 0
    return tuple(dict(read_lattice_ark(os.path.join(d, name)))
                 for d in (jd, td))


def _best_words(lats):
    return {k: (None if lat is None else lattice_best_path(lat)[0])
            for k, lat in lats.items()}


# ------------------------------------------------------------ decoding

@pytest.mark.parametrize("det", [False, True])
def test_latgen_faster_mapped_lattices(sysd, tmp_path, det):
    """JAX's loglike file through both packages' padded beam search:
    JAX's int transcriptions and its lattices within `_same_lattice`'s
    bound, raw and determinized; the alias gives the same."""
    P = sysd

    def argv(name):
        return lambda d: [name, P("hclg.npz"), f"ark:{P('likes.ark')}",
                          "--lattice-out", os.path.join(d, "lat.ark")] \
            + LATGEN + (["--determinize-lattice"] if det else [])
    res = run_both(tmp_path, argv("latgen-faster-mapped"), device=True)
    alias = run_port(str(tmp_path / "alias"),
                     argv("latgen-faster-mapped-parallel"))
    for port in (res["port"], alias):
        assert port[1] == res["jax"][1]
        want, got = _lattices(dict(res, port=port), "lat.ark")
        assert list(got) == list(want) and len(want) == 12
        for k in want:
            _same_lattice(got[k], want[k], k)


@pytest.mark.parametrize("name", ["gmm-latgen-faster",
                                  "gmm-latgen-faster-parallel",
                                  "gmm-latgen-simple"])
def test_gmm_latgen_faster_words(sysd, tmp_path, name):
    """The GMM decode from features (or an alias) against the fixture's
    JAX run of the same arguments: JAX's transcription file, lattice keys
    and best-path words (the loglikes differ in the GEMM's last bits);
    WER 0 on the corpus, as test_latgen_cli.py asks of JAX."""
    P = sysd
    port = run_port(str(tmp_path), lambda d: latgen_argv(P, name, d))
    want, got = _lattices({"jax": (P(), "", 0), "port": port}, "lat.ark")
    assert list(got) == list(want) and len(want) == 12
    assert _best_words(got) == _best_words(want)
    hyp = os.path.join(port[0], "hyp.txt")
    assert open(hyp).read() == open(P("hyp.txt")).read()
    assert _call(jmain, ["compute-wer", P("text"), hyp,
                         "--max-wer", "0"])[1] == 0


def test_gmm_latgen_faster_with_transforms(sysd, tmp_path):
    """The decode_fmllr.sh second pass: per-speaker affine transforms
    looked up through --utt2spk, word-level determinization; JAX's
    words."""
    P = sysd
    rng = np.random.RandomState(5)
    D = 39
    trans = {f"spk{s}": np.concatenate(
        [np.eye(D) + 0.01 * rng.randn(D, D), 0.05 * rng.randn(D, 1)],
        axis=1).astype(np.float32) for s in range(2)}
    write_ark(P("trans.ark"), trans)
    res = run_both(tmp_path, lambda d: [
        "gmm-latgen-faster", P("mono.npz"), P("hclg.npz"),
        f"ark:{P('feats.ark')}", "--utt2spk", P("utt2spk"),
        "--transform", P("trans.ark"), "--determinize-lattice",
        "--transcription-out", os.path.join(d, "hyp.txt")] + LATGEN,
        device=True)
    same_bytes(res)


def test_decode_fmllr_words(sysd, tmp_path):
    """Two-pass fMLLR decoding (test_latgen_cli.py's case): JAX's
    transcription file and WER 0; the transforms themselves are not
    compared (an ill-conditioned solve over few frames)."""
    P = sysd
    res = run_both(tmp_path, lambda d: [
        "decode-fmllr", P("mono.npz"), P("hclg.npz"), f"ark:{P('feats.ark')}",
        P("utt2spk"), "--transcription-out", os.path.join(d, "hyp.txt"),
        "--fmllr-min-count", "50"] + SEARCH, device=True)
    same_bytes(res)
    assert _call(jmain, ["compute-wer", P("text"),
                         os.path.join(res["port"][0], "hyp.txt"),
                         "--max-wer", "0"])[1] == 0


def test_biglm_decode_words(sysd, tmp_path):
    """Decode with the unigram graph, rescore under JAX's bigram
    const-ARPA: JAX's transcription file, from either name."""
    P = sysd

    def argv(name):
        return lambda d: [
            name, P("mono.npz"), P("hclg.npz"), P("G.txt"),
            P("bigram.clm.npz"), f"ark:{P('feats.ark')}", "--backoff-symbol",
            cs.word_id(P("words.txt"), "#0"), "--transcription-out",
            os.path.join(d, "hyp.txt")] + LATGEN
    res = run_both(tmp_path, argv("gmm-latgen-biglm-faster"), device=True)
    same_bytes(res)
    alias = run_port(str(tmp_path / "alias"), argv("gmm-decode-biglm-faster"))
    same_bytes(dict(res, port=alias))


def test_gmm_rescore_lattice(sysd, tmp_path):
    """JAX's lattices rescored with this GMM: JAX's arcs and graph costs,
    acoustic costs within the loglikes' rounding."""
    P = sysd
    res = run_both(tmp_path, lambda d: [
        "gmm-rescore-lattice", P("mono.npz"), P("lat.ark"),
        f"ark:{P('feats.ark')}", os.path.join(d, "out.ark")], device=True)
    assert res["jax"][1] == res["port"][1]
    want, got = _lattices(res, "out.ark")
    assert list(got) == list(want) and len(want) == 12
    am = tmio.load_gmm_system(P("mono.npz"), device="cpu").am
    feats = dict(open_rspecifier(f"ark:{P('feats.ark')}"))
    for k in want:
        bound = 0.1 * LL_REL * cs.gmm_term_scale(am, feats[k]).max(1).sum()
        g, w = got[k].to_arrays(), want[k].to_arrays()
        assert g[0] == w[0]
        for i in (1, 2, 3, 4, 6):
            np.testing.assert_array_equal(g[i], w[i], err_msg=k)
        np.testing.assert_allclose(g[5], w[5], rtol=0, atol=bound,
                                   err_msg=k)


# ----------------------------------------------------------- rescoring

def test_arpa_to_const_arpa_crosses_both_ways(sysd, tmp_path):
    """The const-ARPA artifact array for array; JAX loads the port's
    file and the port JAX's, with equal tables."""
    P = sysd
    res = run_both(tmp_path, lambda d: [
        "arpa-to-const-arpa", P("words.txt"), P("bigram.arpa"),
        os.path.join(d, "lm.npz")], device=False)
    same_files(res)
    jpath = os.path.join(res["jax"][0], "lm.npz")
    tpath = os.path.join(res["port"][0], "lm.npz")
    for a, b in ((jmio.load_const_arpa(tpath), tmio.load_const_arpa(jpath)),
                 (jmio.load_const_arpa(jpath), tmio.load_const_arpa(tpath))):
        for k in tmio._CLM_ARRAYS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a._hist_index == b._hist_index and a.order == b.order


@pytest.mark.parametrize("lm", ["bigram.arpa", "bigram.clm.npz"])
def test_lattice_lmrescore_const_arpa(sysd, tmp_path, lm):
    """Rescoring JAX's lattices under an ARPA file or JAX's const-ARPA:
    JAX's bytes."""
    P = sysd
    res = run_both(tmp_path, lambda d: [
        "lattice-lmrescore-const-arpa", P("mono.npz"), P(lm), P("lat.ark"),
        os.path.join(d, "out.ark"), "--lm-scale", "0.5"], device=False)
    same_bytes(res)


def test_lmrescore_chain_on_the_ports_files(sysd, tmp_path):
    """lmrescore_const_arpa.sh: remove G (lattice-lmrescore --lm-scale
    -1), add the bigram; each step on the file the port wrote at the
    step before, JAX's bytes at every step."""
    P = sysd
    src = P("lat.ark")
    for i, argv in enumerate((
            lambda d: ["lattice-lmrescore", src, P("G.txt"),
                       os.path.join(d, "noG.ark"), "--lm-scale", "-1",
                       "--backoff-symbol", cs.word_id(P("words.txt"), "#0")],
            lambda d: ["lattice-lmrescore-const-arpa", P("mono.npz"),
                       P("bigram.clm.npz"), src,
                       os.path.join(d, "big.ark")],
            lambda d: ["lattice-lmrescore", src, P("G.txt"),
                       os.path.join(d, "reG.ark"), "--lm-scale", "1",
                       "--backoff-symbol", cs.word_id(P("words.txt"), "#0")])):
        res = run_both(str(tmp_path / str(i)), argv, device=False)
        same_bytes(res)
        d = res["port"][0]
        src = os.path.join(d, os.listdir(d)[0])


@pytest.mark.parametrize("case", ["rescore-mapped", "add-trans-probs"])
def test_lattice_acoustic_and_transition_rescoring(sysd, tmp_path, case):
    P = sysd
    argv = {"rescore-mapped": lambda d: [
                "lattice-rescore-mapped", P("mono.npz"), P("lat.ark"),
                f"ark:{P('likes.ark')}", os.path.join(d, "out.ark"),
                "--acoustic-scale", "0.1"],
            "add-trans-probs": lambda d: [
                "lattice-add-trans-probs", P("mono.npz"), P("lat.ark"),
                os.path.join(d, "out.ark"), "--transition-scale", "0.5"]}
    same_bytes(run_both(tmp_path, argv[case], device=False))
