"""Port parity: the CLI's fifth slice (5a), group 4: LDA / MLLT
(kaldi_tpu_torch/cli.py, cli_adapt.py) against kaldi_tpu's CLI, on the
CPU, over files that JAX wrote (test_torch_cli_gmm's `jax_system`:
JAX's `_tiny_corpus` of 12 yesno utterances, its `train-mono` model,
posteriors and UBMs).
- Host commands write JAX's files and print JAX's lines: the LDA and
  MLLT statistics (`acc-lda`, `gmm-acc-mllt`, `gmm-acc-mllt-global`:
  host f64 in both packages, the global GMM's posteriors host numpy),
  their sums, `est-lda`, `est-mllt` (the host row iteration) and
  `get-full-lda-mat`, `.npz` array for array and arks byte for byte.
- `train-lda-mllt` (`--device cpu`) is a whole recipe run, held as
  ROADMAP.md §3 traps ("EM drift") holds one: JAX's printed pdfs,
  gaussians and transform shape, its pdf and gaussian counts, its feature transform
  within TRANSFORM_REL of the largest magnitude (LDA from the same
  alignments; MLLT from posterior-fed statistics that drift with EM),
  and JAX's words when each side's model decodes its own projected
  features through the port's mkgraph and decode-faster.
test_transform_cli.py's and test_adapt_cli.py's LDA / MLLT cases, on
the port.
"""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import main as jmain
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark
from test_torch_cli_features import _call, run_both, same_bytes
from test_torch_cli_gmm import jax_system, same_files

torch.set_num_threads(2)

TRANSFORM_REL = 1e-3     # a whole LDA+MLLT run's transform (EM drift)


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    P = jax_system(tmp_path_factory.mktemp("xf"))
    F = f"ark:{P('feats.ark')}"
    for argv in (
            ["acc-lda", P("mono.npz"), F, P("post.txt"), P("lacc.npz")],
            ["gmm-acc-mllt", P("mono.npz"), F, P("post.txt"),
             P("macc.npz")],
            ["est-lda", P("lacc.npz"), P("lda20.ark"), "--dim", "20"],
            ["est-lda", P("lacc.npz"), P("lda39.ark"), "--dim", "39"]):
        assert _call(jmain, argv)[1] == 0, argv
    (_k, lda39), = read_ark(P("lda39.ark"))
    write_ark(P("full39.ark"), {"full": lda39[:, :39]})
    return P


def _run(sysd, tmp, argv_fn, device=False):
    return run_both(str(tmp), lambda O: argv_fn(sysd, O), device)


def _o(O, *n):
    return os.path.join(O, *n)


HOST_CASES = {
    "acc-lda": lambda P, O: [
        "acc-lda", P("mono.npz"), f"ark:{P('feats.ark')}", P("post.txt"),
        _o(O, "a.npz")],
    "acc-lda-signed": lambda P, O: [
        "acc-lda", P("mono.npz"), f"ark:{P('feats.ark')}", P("signed.txt"),
        _o(O, "a.npz")],
    "est-lda": lambda P, O: [
        "est-lda", P("lacc.npz"), _o(O, "l.ark"), "--dim", "12"],
    "sum-lda-accs": lambda P, O: [
        "sum-lda-accs", _o(O, "a.npz"), P("lacc.npz"), P("lacc.npz")],
    "gmm-acc-mllt": lambda P, O: [
        "gmm-acc-mllt", P("mono.npz"), f"ark:{P('feats.ark')}",
        P("post.txt"), _o(O, "m.npz")],
    "est-mllt": lambda P, O: ["est-mllt", P("macc.npz"), _o(O, "m.ark")],
    "sum-mllt-accs": lambda P, O: [
        "sum-mllt-accs", _o(O, "m.npz"), P("macc.npz"), P("macc.npz")],
    "gmm-acc-mllt-global": lambda P, O: [
        "gmm-acc-mllt-global", P("dubm.npz"), f"ark:{P('feats.ark')}",
        _o(O, "g.npz")],
    "gmm-acc-mllt-global-full": lambda P, O: [
        "gmm-acc-mllt-global", P("fubm.npz"), f"ark:{P('feats.ark')}",
        _o(O, "g.npz")],
    "get-full-lda-mat": lambda P, O: [
        "get-full-lda-mat", P("lda20.ark"), P("full39.ark"), _o(O, "f.ark"),
        _o(O, "i.ark")],
    "get-full-lda-mat-no-inverse": lambda P, O: [
        "get-full-lda-mat", P("lda20.ark"), P("full39.ark"),
        _o(O, "f.ark")],
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_commands_write_jax_files(sysd, tmp_path, name):
    same_files(_run(sysd, tmp_path, HOST_CASES[name]))


@pytest.mark.parametrize("name", ["est-lda", "est-mllt", "get-full-lda-mat"])
def test_transform_arks_are_byte_equal(sysd, tmp_path, name):
    same_bytes(_run(sysd, tmp_path, HOST_CASES[name]))


def _decode(P, O, model, transform, tag):
    """The port's mkgraph and decode-faster (CPU) of `model` over the raw
    MFCC spliced +-3 and projected by `transform` -> {utt: words}."""
    def run(argv):
        dev = ["--device", "cpu"] if argv[0] in tcli.DEVICE_COMMANDS else []
        assert _call(tcli.main, argv + dev)[1] == 0, argv
    spl, proj = _o(O, f"{tag}.spl.ark"), _o(O, f"{tag}.proj.ark")
    hyp = _o(O, f"{tag}.hyp")
    run(["splice-feats", f"ark:{P('mfcc.ark')}", f"ark:{spl}",
         "--left-context", "3", "--right-context", "3"])
    run(["transform-feats", transform, f"ark:{spl}", f"ark:{proj}"])
    run(["mkgraph", model, P("lm.arpa"), _o(O, f"{tag}.hclg.npz")])
    run(["decode-faster", model, _o(O, f"{tag}.hclg.npz"), f"ark:{proj}",
         "--transcription-out", hyp])
    return dict(line.split(None, 1) for line in open(hyp))


def test_train_lda_mllt_matches_jax_by_outcome(sysd, tmp_path):
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    res = _run(sysd, tmp_path, lambda P, O: [
        "train-lda-mllt", P("mono.npz"), P("text"), f"ark:{P('mfcc.ark')}",
        f"ark:{P('feats.ark')}", _o(O, "lm.npz"), _o(O, "final.ark"),
        "--num-iters", "5", "--totgauss", "60", "--num-leaves", "12",
        "--lda-dim", "12"], device=True)
    (jd, jout, jc), (td, tout, tc) = res["jax"], res["port"]
    assert jc == tc == 0 and jout == tout
    (_k, want), = read_ark(_o(jd, "final.ark"))
    (_k2, got), = read_ark(_o(td, "final.ark"))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.float64) - want).max() <= \
        TRANSFORM_REL * np.abs(want).max()
    tj, tt = (load_gmm_system(_o(d, "lm.npz"), device="cpu")
              for d in (jd, td))
    assert tt.am.num_pdfs == tj.am.num_pdfs
    assert tt.am.total_gauss == tj.am.total_gauss
    wj = _decode(sysd, str(tmp_path), _o(jd, "lm.npz"), _o(jd, "final.ark"),
                 "jax")
    wt = _decode(sysd, str(tmp_path), _o(td, "lm.npz"), _o(td, "final.ark"),
                 "port")
    assert wt == wj
