"""Port parity: the CLI's third slice, posteriors, keyword search and
pronunciations (kaldi_tpu_torch/cli.py, cli_misc.py, cli_tail.py)
against kaldi_tpu's CLI, on the CPU.

Every command here is host code in both packages, so each case runs both
`main`s on the same files and asserts that they write the same bytes,
print the same lines and exit with the same code
(tests/test_torch_cli_features.py's `same_bytes`); `rand-prune-post`
draws from `np.random.RandomState(--seed)` in JAX's order, so it too is
byte-equal. The inputs are JAX-written once per module:
tests/test_torch_cli_latgen.py's `lattice_system` (the yesno corpus,
JAX's mono model, alignments and raw lattices), then JAX's alignment and
lattice posteriors, a signed copy, frame weights, probability and
silence-likelihood matrices, phone sequences and lengths, and KWS
keyword, reference and lexicon files. Two chains run on the files the
port wrote at each step: the posterior path of steps/train_sat.sh
(lattice-to-post -> weight-silence-post -> post-to-weights /
post-to-pdf-post) and the KWS path (lattice-to-kws-index on two shards
-> kws-index-union -> kws-search --index -> compute-atwv), where the
union's hits equal those of the unsharded lattices and each index
pickle is JAX's byte for byte. test_post_cli.py's, test_kws_cli.py's,
test_tail_cli.py's prons, test_gmmbin_cli.py's sum-post /
post-to-weights / weight-silence-post, test_misc_cli.py's silence and
test_nnet1_cli.py's feat-to-post / paste-post cases, on the port.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.cli import main as jmain
from kaldi_tpu.io.kaldi_io import open_rspecifier, write_ark
from kaldi_tpu.kws import load_kws_index as j_load_kws_index
from kaldi_tpu.lat.io import read_lattice_ark, write_lattice_ark
from kaldi_tpu_torch.hmm.posterior import post_to_weights, read_post_ark
from kaldi_tpu_torch.kws import load_kws_index
from test_torch_cli_features import _call, run_both, same_bytes
from test_torch_cli_latgen import lattice_system

torch.set_num_threads(2)

SIL = "1"    # the yesno lexicon's SIL phone
PROXY_LEXICON = "cat k ae t\ncab k ae b\ndog d ao g\ncap k ae p\n"


def _out(argv) -> str:
    """JAX's stdout of `argv` (a file the tests read as JAX-written)."""
    text, code = _call(jmain, argv)
    assert code == 0, argv
    return text


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    P = lattice_system(tmp_path_factory.mktemp("post"))
    feats = f"ark:{P('feats.ark')}"
    for argv in (
            ["ali-to-post", f"ark:{P('ali.ark')}", P("post.txt")],
            ["lattice-to-post", P("lat.ark"), P("lat_post.txt")],
            ["scale-post", P("post.txt"), P("signed.txt"), "--scale",
             "-0.5"]):
        assert _call(jmain, argv)[1] == 0, argv
    rng = np.random.RandomState(7)
    nf = {k: v.shape[0] for k, v in open_rspecifier(feats)}
    write_ark(P("w.ark"), {k: rng.uniform(0, 2, n).astype(np.float32)
                           for k, n in nf.items()})
    probs = {k: rng.dirichlet(np.ones(5) * 0.5, size=6).astype(np.float32)
             for k in ("a", "b", "c")}
    write_ark(P("probs.ark"), probs)
    write_ark(P("logprobs.ark"), {k: np.log(v + 1e-8).astype(np.float32)
                                  for k, v in probs.items()})
    write_ark(P("small.ark"), {k: rng.randn(8, 4).astype(np.float32)
                               for k in ("a", "b")})
    write_ark(P("sil.ark"), {k: rng.randn(n).astype(np.float32) * 3
                             for k, n in list(nf.items())[:6]})
    write_ark(P("nonsil.ark"), {k: rng.randn(n).astype(np.float32) * 3
                                for k, n in list(nf.items())[:5]})
    with open(P("phones.ark"), "w") as f:
        f.write(_out(["ali-to-phones", P("mono.npz"),
                      f"ark:{P('ali.ark')}"]))
    with open(P("lens.txt"), "w") as f:
        f.write(_out(["ali-to-phones", P("mono.npz"),
                      f"ark:{P('ali.ark')}", "--write-lengths"]))
    assert _call(jmain, ["phones-to-prons", P("mono.npz"), P("lexicon.txt"),
                         f"ark:{P('phones.ark')}", P("text"),
                         P("prons.txt")])[1] == 0
    # keywords: NO (1) and YES (2) alone, then two-word phrases
    with open(P("kw.txt"), "w") as f:
        f.write("KW1 1\nKW2 2\nKW3 1 2\nKW4 2 2\nKW5 2 1\n")
    # the two lattice shards of lattice-to-kws-index
    lats = list(read_lattice_ark(P("lat.ark")))
    write_lattice_ark(P("shard1.ark"), dict(lats[:6]))
    write_lattice_ark(P("shard2.ark"), dict(lats[6:]))
    with open(P("lexicon.proxy"), "w") as f:
        f.write(PROXY_LEXICON)
    with open(P("kw.proxy"), "w") as f:
        f.write("OOV1 k ae p\nOOV2 d ao t\nOOV3 k ao g\n")
    with open(P("confusion.txt"), "w") as f:
        f.write("p t 0.2\np b 0.3\nt g 0.4\nao ae 0.5\n")
    return P


def _o(d, name="out.txt"):
    return os.path.join(d, name)


# name -> argv_fn(P, out_dir)
CASES = {
    "weight-silence-post": lambda P, d: [
        "weight-silence-post", "0.0", SIL, P("mono.npz"), P("lat_post.txt"),
        _o(d)],
    "weight-silence-post-half": lambda P, d: [
        "weight-silence-post", "0.5", SIL + ":2", P("mono.npz"),
        P("post.txt"), _o(d)],
    "sum-post": lambda P, d: [
        "sum-post", P("post.txt"), P("signed.txt"), _o(d), "--scale1", "0.5",
        "--scale2", "2"],
    "post-to-weights": lambda P, d: [
        "post-to-weights", P("lat_post.txt"), f"ark:{_o(d, 'w.ark')}"],
    "copy-post": lambda P, d: ["copy-post", P("lat_post.txt"), _o(d)],
    "scale-post": lambda P, d: [
        "scale-post", P("lat_post.txt"), _o(d), "--scale", "0.5"],
    "weight-post": lambda P, d: [
        "weight-post", P("lat_post.txt"), f"ark:{P('w.ark')}", _o(d)],
    "thresh-post": lambda P, d: [
        "thresh-post", P("lat_post.txt"), _o(d), "--threshold", "0.3"],
    "rand-prune-post": lambda P, d: [
        "rand-prune-post", P("lat_post.txt"), _o(d), "--scale", "0.5",
        "--seed", "3"],
    "rand-prune-post-signed": lambda P, d: [
        "rand-prune-post", P("signed.txt"), _o(d), "--scale", "0.8"],
    "post-to-pdf-post": lambda P, d: [
        "post-to-pdf-post", P("mono.npz"), P("lat_post.txt"), _o(d)],
    "post-to-phone-post": lambda P, d: [
        "post-to-phone-post", P("mono.npz"), P("lat_post.txt"), _o(d)],
    "prob-to-post": lambda P, d: [
        "prob-to-post", f"ark:{P('probs.ark')}", _o(d), "--min-post", "0.1"],
    "logprob-to-post": lambda P, d: [
        "logprob-to-post", f"ark:{P('logprobs.ark')}", _o(d),
        "--min-post", "0.05"],
    "get-post-on-ali": lambda P, d: [
        "get-post-on-ali", P("lat_post.txt"), f"ark:{P('ali.ark')}",
        f"ark:{_o(d, 'conf.ark')}"],
    "feat-to-post": lambda P, d: [
        "feat-to-post", f"ark:{P('small.ark')}", _o(d), "--min-value", "0.5"],
    "paste-post": lambda P, d: [
        "paste-post", P("post.txt"), "200", P("lat_post.txt"), _o(d)],
    "get-silence-probs": lambda P, d: [
        "get-silence-probs", f"ark:{P('sil.ark')}", f"ark:{P('nonsil.ark')}",
        f"ark:{_o(d, 'p.ark')}", "--quantize", "0.1"],
    "get-silence-probs-nonsil": lambda P, d: [
        "get-silence-probs", f"ark:{P('sil.ark')}", f"ark:{P('nonsil.ark')}",
        f"ark:{_o(d, 'p.ark')}", "--sil-prior", "0.3",
        "--write-nonsil-probs"],
    "kws-search": lambda P, d: ["kws-search", P("lat.ark"), P("kw.txt")],
    "lattice-to-kws-index": lambda P, d: [
        "lattice-to-kws-index", P("lat.ark"), _o(d, "idx.pkl")],
    "generate-proxy-keywords": lambda P, d: [
        "generate-proxy-keywords", P("kw.proxy"), P("lexicon.proxy"),
        "--confusion-matrix", P("confusion.txt"), "--nbest", "3",
        "--proxy-beam", "2"],
    "generate-proxy-keywords-plain": lambda P, d: [
        "generate-proxy-keywords", P("kw.proxy"), P("lexicon.proxy")],
    "phones-to-prons": lambda P, d: [
        "phones-to-prons", P("mono.npz"), P("lexicon.txt"),
        f"ark:{P('phones.ark')}", P("text"), _o(d)],
    "prons-to-wordali": lambda P, d: [
        "prons-to-wordali", P("prons.txt"), P("lens.txt"), _o(d)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_post_kws_command_writes_jax_bytes(sysd, tmp_path, case):
    same_bytes(run_both(tmp_path, lambda d: CASES[case](sysd, d),
                        device=False))


def _chain(tmp_path, steps):
    """Run each argv_fn(src, d) of `steps` through both packages, the
    next on what the port wrote (-> its file, or its stdout when it
    wrote none); JAX's bytes and lines at every step. -> the port's
    results."""
    src, out = None, []
    for i, argv in enumerate(steps):
        res = run_both(str(tmp_path / str(i)), lambda d: argv(src, d),
                       device=False)
        same_bytes(res)
        out.append(res["port"])
        files = os.listdir(res["port"][0])
        if files:
            src = os.path.join(res["port"][0], files[0])
    return out


def test_posterior_chain_on_the_ports_files(sysd, tmp_path):
    """lattice-to-post -> weight-silence-post -> post-to-weights, and
    post-to-pdf-post of the silence-weighted posteriors: the lattice
    posteriors sum to 1 on every frame, the weighted ones lie in [0, 1],
    each within 1e-4 (the posterior file's text rounding)."""
    P = sysd
    runs = _chain(tmp_path, [
        lambda s, d: ["lattice-to-post", P("lat.ark"), _o(d),
                      "--acoustic-scale", "0.1"],
        lambda s, d: ["weight-silence-post", "0.0", SIL, P("mono.npz"), s,
                      _o(d)],
        lambda s, d: ["post-to-weights", s, f"ark:{_o(d, 'w.ark')}"]])
    post, wpost = (_o(r[0]) for r in runs[:2])
    for path, ok in ((post, lambda w: np.abs(w - 1).max() <= 1e-4),
                     (wpost, lambda w: ((w >= -1e-4)
                                        & (w <= 1 + 1e-4)).all())):
        for utt, p in read_post_ark(path):
            assert ok(np.asarray(post_to_weights(p))), (path, utt)
    same_bytes(run_both(str(tmp_path / "pdf"), lambda d: [
        "post-to-pdf-post", P("mono.npz"), wpost, _o(d)], device=False))


def test_kws_chain_on_the_ports_files(sysd, tmp_path):
    """Two shard indexes -> kws-index-union -> kws-search --index ->
    compute-atwv, each step through both packages on the port's files:
    the index pickles JAX's byte for byte, the port's union loading in
    JAX as in the port, and the union's hits equal those of the
    unsharded lattices."""
    P = sysd
    idx = []
    for i in (1, 2):
        res = run_both(str(tmp_path / f"shard{i}"), lambda d, i=i: [
            "lattice-to-kws-index", P(f"shard{i}.ark"), _o(d, "idx.pkl")],
            device=False)
        same_bytes(res)
        idx.append(_o(res["port"][0], "idx.pkl"))
    res = run_both(str(tmp_path / "union"), lambda d: [
        "kws-index-union", _o(d, "u.pkl")] + idx, device=False)
    same_bytes(res)
    union = _o(res["port"][0], "u.pkl")
    got, want = load_kws_index(union), j_load_kws_index(union)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert cs.host_equal(dataclasses.asdict(g), dataclasses.asdict(w))
    res = run_both(str(tmp_path / "search"), lambda d: [
        "kws-search", union, P("kw.txt"), "--index"], device=False)
    same_bytes(res)
    hits = res["port"][1]
    direct = _call(jmain, ["kws-search", P("lat.ark"), P("kw.txt")])[0]
    assert hits and sorted(hits.splitlines()) == sorted(direct.splitlines())
    # references: half the hits moved by a few frames, the rest dropped,
    # and a missed keyword
    lines = hits.splitlines()
    with open(P("hits.txt"), "w") as f:
        f.write(hits)
    with open(P("ref.txt"), "w") as f:
        for i, line in enumerate(lines[::2]):
            kw, utt, t0, t1, _p = line.split()
            f.write(f"{kw} {utt} {int(t0) + i % 3} {int(t1) + i % 5}\n")
        f.write("KW9 u0 10 20\n")
    for threshold in ("0.5", "0.05"):
        same_bytes(run_both(str(tmp_path / f"atwv{threshold}"), lambda d: [
            "compute-atwv", "36.5", P("ref.txt"), P("hits.txt"),
            "--score-threshold", threshold], device=False))
