"""Port parity: the CLI's second slice, tree, HMM and alignment
subcommands (kaldi_tpu_torch/cli.py, cli_misc.py) against kaldi_tpu's
CLI, on the CPU, over files that either package wrote.

The inputs are JAX-written once per module: test_torch_cli_gmm.py's
`jax_system` (12 yesno utterances, JAX's monophone, its alignments) and
a small JAX triphone start (tree stats, questions, a 30-leaf tree,
gmm-init-model, converted alignments, per-pdf loglikes).
- Host commands (the tree tools, transition and alignment tools, tree
  stats and their sums, clustering, trees, `compile-questions`' pickle,
  `draw-tree`'s GraphViz) write JAX's files (`.npz` array for array,
  pickled payloads compared structurally) and print JAX's
  lines; the sgmm tree aliases run the same commands.
- Device commands (`--device cpu`): `align-equal` and `align-mapped` (and
  their aliases) write JAX's alignments byte for byte; `gmm-init-model`
  JAX's arrays; `train-deltas` on JAX's monophone is held by outcome
  (WER 0 through mkgraph and decode-faster; JAX loads the file).
- tests/test_tree_cli.py:21's train_deltas.sh protocol through the port
  alone: sharded tree statistics equal to the unsharded ones, questions,
  compile-questions, build-tree, gmm-init-model, convert-ali keeping each
  frame's phone, HMM state and self-loop, EM with realignment, WER 0.
test_tree_cli.py's, test_misc_cli.py::test_tree_tools',
test_gmmbin_cli.py's alignment and test_bin_leftovers_cli.py's tree and
mapped-alignment cases, on the port.
"""

import pickle

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import main as jmain
from kaldi_tpu.io import model_io as jmio
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io import model_io as tmio
from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
from test_torch_cli_features import _call
from test_torch_cli_gmm import F, _run, jax_system, same_files

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    """JAX's monophone system and a triphone start from it."""
    root = tmp_path_factory.mktemp("tree")
    P = jax_system(root)
    feats, ali = F(P), f"ark:{P('ali.ark')}"
    for argv in (
            ["acc-tree-stats", P("mono.npz"), feats, ali, P("ts.npz")],
            ["cluster-phones", P("ts.npz"), P("questions.txt")],
            ["build-tree", P("mono.npz"), P("ts.npz"), P("tri_tree.npz"),
             "--questions", P("questions.txt"), "--max-leaves", "30"],
            ["gmm-init-model", P("mono.npz"), P("tri_tree.npz"),
             P("ts.npz"), P("tri0.npz")],
            ["convert-ali", P("mono.npz"), P("tri0.npz"), ali,
             f"ark:{P('triali.ark')}"],
            ["gmm-compute-likes", P("mono.npz"), feats,
             f"ark:{P('likes.ark')}"]):
        assert _call(jmain, argv)[1] == 0, argv
    with open(P("phones.txt"), "w") as f:
        for i in range(1, 10):
            f.write(f"p{i} {i}\n")
    with open(P("hyp.txt"), "w") as f:
        for line in open(P("text")):
            toks = line.split()
            f.write(" ".join(toks[:1] + toks[2:] + ["YES"]) + "\n")
    return P


def A(P, n="ali.ark"):
    return f"ark:{P(n)}"


# (name, argv(P, O)): host commands, JAX's files and lines
HOST_CASES = [
    *[(n, lambda P, O, n=n: [n, P("mono.npz")])
      for n in ("hmm-info", "am-info", "show-transitions")],
    ("show-alignments", lambda P, O: ["show-alignments", P("mono.npz"),
                                      A(P)]),
    ("copy-transition-model", lambda P, O: [
        "copy-transition-model", P("mono.npz"), f"{O}/m.npz"]),
    *[(n, lambda P, O, n=n: [n, P("mono.npz"), A(P), f"{O}/m.npz"])
      for n in ("train-transitions", "nnet-train-transitions",
                "nnet3-am-train-transitions")],
    ("ali-to-pdf", lambda P, O: ["ali-to-pdf", P("mono.npz"), A(P),
                                 f"ark:{O}/p.ark"]),
    *[("ali-to-phones", lambda P, O, x=x: ["ali-to-phones", P("tri0.npz"),
                                           A(P, "triali.ark"), *x])
      for x in ([], ["--write-lengths"], ["--ctm-output", "--frame-shift",
                                          "0.03"])],
    ("ali-to-post", lambda P, O: ["ali-to-post", A(P), f"{O}/p.txt"]),
    ("convert-ali", lambda P, O: ["convert-ali", P("mono.npz"),
                                  P("tri0.npz"), A(P), f"ark:{O}/a.ark"]),
    *[(n, lambda P, O, n=n: [n, A(P), f"{O}/c.ark"])
      for n in ("analyze-counts", "pdf-to-counts")],
    ("align-text", lambda P, O: ["align-text", P("text"), P("hyp.txt")]),
    *[(n, lambda P, O, n=n: [n, P("mono.npz"), F(P), A(P), f"{O}/t.npz",
                             "--ci-phones", "1"])
      for n in ("acc-tree-stats", "sgmm-acc-tree-stats")],
    *[(n, lambda P, O, n=n: [n, f"{O}/t.npz", P("ts.npz"), P("ts.npz")])
      for n in ("sum-tree-stats", "sgmm-sum-tree-stats")],
    *[(n, lambda P, O, n=n: [n, P("ts.npz"), f"{O}/q.txt"])
      for n in ("cluster-phones", "sgmm-cluster-phones")],
    *[(n, lambda P, O, n=n, x=x: [n, P("mono.npz"), P("ts.npz"),
                                  f"{O}/t.npz", "--max-leaves", "25", *x])
      for n, x in (("build-tree", ["--questions", "{q}"]),
                   ("sgmm-build-tree", ["--sil-roots", "per_state"]))],
    ("build-tree-two-level", lambda P, O: [
        "build-tree-two-level", P("mono.npz"), P("ts.npz"),
        P("questions.txt"), f"{O}/t.npz", f"{O}/map.txt",
        "--max-leaves-first", "10", "--max-leaves-second", "30"]),
    *[("copy-tree", lambda P, O, m=m: ["copy-tree", P(m), f"{O}/t.npz"])
      for m in ("tri_tree.npz", "mono.npz")],
    *[("tree-info", lambda P, O, m=m: ["tree-info", P(m)])
      for m in ("tri_tree.npz", "tri0.npz")],
    *[("extract-ctx", lambda P, O, x=x: ["extract-ctx", P("ts.npz"),
                                         P("tri_tree.npz"), *x])
      for x in ([], ["--phone-symbols", "{phones}"])],
    ("compile-questions", lambda P, O: [
        "compile-questions", P("questions.txt"), f"{O}/q.pkl",
        "--num-pdf-classes", "3"]),
    *[("draw-tree", lambda P, O, t=t: ["draw-tree", P("phones.txt"), P(t)])
      for t in ("tri_tree.npz", "tree.npz")],
]


def _fill(P, argv):
    return [a.replace("{q}", P("questions.txt"))
            .replace("{phones}", P("phones.txt")) for a in argv]


@pytest.mark.parametrize("name,argv", HOST_CASES,
                         ids=[f"{n}-{i}" for i, (n, _a) in
                              enumerate(HOST_CASES)])
def test_host_command_writes_jax_files(sysd, tmp_path, name, argv):
    same_files(_run(sysd, tmp_path, lambda P, O: _fill(P, argv(P, O))))


def test_compile_questions_loads_in_jax(sysd, tmp_path):
    path = str(tmp_path / "q.pkl")
    assert _call(tcli.main, ["compile-questions", sysd("questions.txt"),
                             path])[1] == 0
    q = pickle.load(open(path, "rb"))
    assert type(q).__module__ == "kaldi_tpu.tree.build_tree" and q.by_key


@pytest.mark.parametrize("name,argv", [
    *[(n, lambda P, O, n=n: [n, P("mono.npz"), P("text"), F(P),
                             f"ark:{O}/a.ark"])
      for n in ("align-equal", "align-equal-compiled")],
    *[(n, lambda P, O, n=n: [n, P("mono.npz"), P("text"),
                             f"ark:{P('likes.ark')}", f"ark:{O}/a.ark"])
      for n in ("align-mapped", "align-compiled-mapped")],
    ("gmm-init-model", lambda P, O: [
        "gmm-init-model", P("mono.npz"), P("tri_tree.npz"), P("ts.npz"),
        f"{O}/m.npz"])])
def test_device_command_writes_jax_files(sysd, tmp_path, name, argv):
    """Identical alignments (the Viterbi's tie rules, ROADMAP.md §3) and
    the same initial model."""
    same_files(_run(sysd, tmp_path, argv, device=True))


def _port(*argv, device=False):
    out, code = _call(tcli.main, list(argv) + (
        ["--device", "cpu"] if device else []))
    assert code == 0, argv
    return out


def _decodes_at_wer_0(P, model, tmp):
    _port("mkgraph", model, P("lm.arpa"), str(tmp / "hclg.npz"))
    _port("decode-faster", model, str(tmp / "hclg.npz"), F(P),
          "--transcription-out", str(tmp / "hyp.txt"), device=True)
    assert "%WER 0.00" in _port("compute-wer", P("text"),
                                str(tmp / "hyp.txt"))


def test_train_deltas_on_jax_mono_reaches_wer_0(sysd, tmp_path):
    P = sysd
    tri = str(tmp_path / "tri.npz")
    _port("train-deltas", P("mono.npz"), P("text"), F(P), tri,
          "--num-leaves", "40", "--totgauss", "150", "--num-iters", "8",
          device=True)
    _decodes_at_wer_0(P, tri, tmp_path)
    assert jmio.load_gmm_system(tri).am.num_pdfs == \
        tmio.load_gmm_system(tri, device="cpu").am.num_pdfs >= \
        tmio.load_gmm_system(P("mono.npz"), device="cpu").am.num_pdfs


def test_train_deltas_protocol_through_the_port(sysd, tmp_path):
    """steps/train_deltas.sh as primitives (tests/test_tree_cli.py:21) on
    the port alone, from JAX's monophone and alignments."""
    P = sysd
    T = lambda n: str(tmp_path / n)                          # noqa: E731
    utts = sorted(k for k, _v in open_rspecifier(F(P)))
    alis = dict(open_rspecifier(A(P)))
    half = len(utts) // 2
    for i, keys in enumerate((utts[:half], utts[half:])):
        write_ark(T(f"ali{i + 1}.ark"), {u: alis[u] for u in keys})
        _port("acc-tree-stats", P("mono.npz"), F(P),
              f"ark:{T(f'ali{i + 1}.ark')}", T(f"ts{i + 1}.npz"))
    _port("sum-tree-stats", T("ts.npz"), T("ts1.npz"), T("ts2.npz"))
    _port("acc-tree-stats", P("mono.npz"), F(P), A(P), T("ts_all.npz"))
    s_sum, N, Pc = tmio.load_tree_stats(T("ts.npz"))
    s_all, _, _ = tmio.load_tree_stats(T("ts_all.npz"))
    assert (N, Pc) == (3, 1) and set(s_sum) == set(s_all)
    for ev in s_all:
        assert s_sum[ev].count == pytest.approx(s_all[ev].count)
        np.testing.assert_allclose(s_sum[ev].x, s_all[ev].x, rtol=1e-6)
    _port("cluster-phones", T("ts.npz"), T("questions.txt"))
    _port("compile-questions", T("questions.txt"), T("questions.pkl"))
    _port("build-tree", P("mono.npz"), T("ts.npz"), T("tree.npz"),
          "--questions", T("questions.txt"), "--max-leaves", "50")
    _port("gmm-init-model", P("mono.npz"), T("tree.npz"), T("ts.npz"),
          T("tri0.npz"), device=True)
    _port("convert-ali", P("mono.npz"), T("tri0.npz"), A(P),
          f"ark:{T('triali.ark')}")
    mono = tmio.load_gmm_system(P("mono.npz"), device="cpu").trans_model
    tri = tmio.load_gmm_system(T("tri0.npz"), device="cpu").trans_model
    for u, b in open_rspecifier(f"ark:{T('triali.ark')}"):
        assert len(b) == len(alis[u])
        for to, tn in zip(alis[u].tolist(), b.tolist()):
            assert (mono.transition_id_to_phone(to),
                    mono.transition_id_to_hmm_state(to),
                    mono.is_self_loop(to)) == (
                tri.transition_id_to_phone(tn),
                tri.transition_id_to_hmm_state(tn), tri.is_self_loop(tn))
    est = ["--min-gaussian-occupancy", "3", "--power", "0.25"]
    _port("gmm-acc-stats-ali", T("tri0.npz"), F(P), f"ark:{T('triali.ark')}",
          T("acc.npz"), device=True)
    _port("gmm-est", T("tri0.npz"), T("acc.npz"), T("tri1.npz"), *est)
    n_leaves = tmio.load_gmm_system(T("tri0.npz"), device="cpu").am.num_pdfs
    for it in range(1, 5):
        _port("gmm-align", T(f"tri{it}.npz"), P("text"), F(P),
              f"ark:{T('triali.ark')}", device=True)
        _port("gmm-acc-stats-ali", T(f"tri{it}.npz"), F(P),
              f"ark:{T('triali.ark')}", T("acc.npz"), device=True)
        _port("gmm-est", T(f"tri{it}.npz"), T("acc.npz"),
              T(f"tri{it + 1}.npz"), *est, "--mix-up",
              str(n_leaves + 10 * it))
    _decodes_at_wer_0(P, T("tri5.npz"), tmp_path)
