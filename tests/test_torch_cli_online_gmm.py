"""Port parity: the CLI's fifth slice (5a), group 5: the online GMM
decoder and the rest (kaldi_tpu_torch/cli.py, cli_adapt.py) against
kaldi_tpu's CLI, on the CPU, over files that JAX wrote (JAX's
`_tiny_corpus` of 8 yesno waves, its `train-mono` model and graph, its
lattices and posteriors).
- `online2-wav-gmm-latgen-faster` and its aliases `online-gmm-decode-
  faster` and `online-wav-gmm-decode-faster` (`--device cpu`): held to
  JAX's words and re-estimation schedule (the printed count of adapted
  speakers), not to transition ids: an early fMLLR estimate amplifies
  f32 rounding into other alignments (ROADMAP.md §3 traps, "Solves";
  tests/test_torch_server.py runs the lockstep comparison).
- `online2-wav-dump-features` (`--device cpu`): MFCC + deltas within
  the feature parity bound (rtol 2e-4, atol 2e-3,
  tests/test_torch_features.py) plus the FFT's rounding-error bound of
  each MFCC element (chip_smoke.fft_feature_bound, ROADMAP.md §3 traps
  "FFT"), carried through the delta filters by the sum of their
  coefficients' magnitudes over the window they read.
- `post-to-tacc` and `lattice-arcgraph` are host code: JAX's bytes.
test_online_gmm_cli.py's, test_cli_leftovers2.py's, test_post_cli.py's
and test_adapt_cli.py's cases of these commands, on the port.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.cli import main as jmain
from kaldi_tpu_torch.io.kaldi_io import read_ark
from test_gmmbin_cli import _tiny_corpus
from test_torch_cli_features import FEAT_TOL, _call, run_both, same_arks, \
    same_bytes

torch.set_num_threads(2)

SR = "8000"


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    root = tmp_path_factory.mktemp("ogmm")
    _tiny_corpus(root, n_utts=8, seed=6)
    P = lambda *n: str(root.joinpath(*n))                    # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    utts = sorted(line.split()[0] for line in open(P("text")))
    with open(P("utt2spk"), "w") as f:
        f.writelines(f"{u} spk{i % 2}\n" for i, u in enumerate(utts))
    for argv in (
            ["train-mono", P("lexicon.txt"), P("text"), feats, P("mono.npz"),
             "--num-iters", "6", "--totgauss", "40"],
            ["mkgraph", P("mono.npz"), P("lm.arpa"), P("hclg.npz")],
            ["gmm-align", P("mono.npz"), P("text"), feats,
             f"ark:{P('ali.ark')}"],
            ["ali-to-post", f"ark:{P('ali.ark')}", P("post.txt")],
            ["gmm-latgen-faster", P("mono.npz"), P("hclg.npz"), feats,
             "--lattice-out", P("lat.ark"), "--beam", "12",
             "--max-active", "64", "--lattice-beam", "4"]):
        assert _call(jmain, argv)[1] == 0, argv
    return P


def _run(sysd, tmp, argv_fn, device=False):
    return run_both(str(tmp), lambda O: argv_fn(sysd, O), device)


def _o(O, *n):
    return os.path.join(O, *n)


@pytest.mark.parametrize("name", ["online2-wav-gmm-latgen-faster",
                                  "online-gmm-decode-faster",
                                  "online-wav-gmm-decode-faster"])
def test_online_gmm_decode_matches_jax_words(sysd, tmp_path, name):
    res = _run(sysd, tmp_path, lambda P, O: [
        name, P("mono.npz"), P("hclg.npz"), P("wav.scp"),
        "--transcription-out", _o(O, "hyp.txt"), "--utt2spk", P("utt2spk"),
        "--sample-frequency", SR, "--beam", "12", "--max-active", "64",
        "--adaptation-delay", "0.5", "--fmllr-min-count", "30"],
        device=True)
    (jd, jout, jc), (td, tout, tc) = res["jax"], res["port"]
    assert jc == tc == 0 and jout == tout
    assert "2 speakers adapted" in jout
    hyp = [open(_o(d, "hyp.txt")).read() for d in (jd, td)]
    assert hyp[1] == hyp[0] and hyp[0].strip()


def test_dump_features_within_the_fft_bound(sysd, tmp_path):
    res = _run(sysd, tmp_path, lambda P, O: [
        "online2-wav-dump-features", P("wav.scp"), f"ark:{_o(O, 'f.ark')}",
        "--sample-frequency", SR, "--chunk-secs", "0.13"], device=True)
    assert res["jax"][1] == res["port"][1]
    bounds = cs.online_feature_bounds(sysd("wav.scp"), float(SR))

    def close(g, w, k):
        assert (np.abs(g.astype(np.float64) - w)
                <= FEAT_TOL["atol"] + FEAT_TOL["rtol"] * np.abs(w)
                + bounds[k]).all(), k
    same_arks(res, "f.ark", close)


HOST_CASES = {
    "post-to-tacc": lambda P, O: [
        "post-to-tacc", P("mono.npz"), P("post.txt"), _o(O, "tacc.ark")],
    "lattice-arcgraph": lambda P, O: [
        "lattice-arcgraph", P("lat.ark"), _o(O, "arcs.fsts")],
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_commands_write_jax_bytes(sysd, tmp_path, name):
    same_bytes(_run(sysd, tmp_path, HOST_CASES[name]))


def test_tacc_sums_to_the_frames(sysd, tmp_path):
    """test_post_cli.py's check on the port's file: one unit of
    posterior per frame."""
    from kaldi_tpu_torch import cli as tcli
    assert _call(tcli.main, HOST_CASES["post-to-tacc"](
        sysd, str(tmp_path)))[1] == 0
    (tacc,) = [v for _k, v in read_ark(_o(str(tmp_path), "tacc.ark"))]
    frames = sum(len(v) for _k, v in read_ark(sysd("feats.ark")))
    assert abs(float(tacc.sum()) - frames) < 1e-3
