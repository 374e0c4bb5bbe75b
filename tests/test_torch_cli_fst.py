"""Port parity: the CLI's second slice, FST and graph subcommands
(kaldi_tpu_torch/cli.py, cli_fst.py) against kaldi_tpu's CLI, on the
CPU. All are host code over the port's fst/ copies: each case runs both
packages' `main` on the same JAX-written inputs and asserts byte-equal
text FSTs, ilabel and symbol files, JAX's graph arrays (`fst-pack-graph`,
array for array), equal output and equal exit codes (`fst-shortest-path`
and `fstisstochastic` exit 1 where JAX does).

The inputs (once per module): test_fst_cli.py's two small FSTs and
test_bin_leftovers_cli.py's backoff bigram, random acceptors, and
test_torch_cli_gmm.py's `jax_system` (12 yesno utterances, JAX's
monophone, a triphone system JAX initialised from its tree statistics)
with utils/mkgraph.sh's chain run by JAX's primitives on the triphone,
so that every step of the chain is compared on JAX's input of that step.
Then tests/test_graph_primitives_cli.py:21's chain through the port alone
on a triphone model the port trained from JAX's monophone: its graph has
`mkgraph`'s state count, packs to JAX's `fst-pack-graph` arrays, and
decodes the corpus like `mkgraph`'s graph, at WER 0.
test_fst_cli.py's, test_fstbin_cli.py's, test_graph_primitives_cli.py's
and test_bin_leftovers_cli.py's FST cases, on the port.
"""

import json
import os

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import main as jmain
from kaldi_tpu.fst.fst import Fst
from kaldi_tpu.fst.text_io import save_fst, write_fst_text
from kaldi_tpu.io.model_io import load_gmm_system
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.fst.text_io import save_fst as tsave_fst
from kaldi_tpu_torch.io import model_io as tmio
from test_torch_cli_features import _call
from test_torch_cli_gmm import F, _run, jax_system, same_files

torch.set_num_threads(2)

A_TEXT = "0 1 1 10 0.5\n0 1 2 20 1.5\n1 2 3 30\n1 1 0 0 0.25\n2 0.125\n"
B_TEXT = "0 0 10 100 0.1\n0 0 20 200 0.2\n0 0 30 300 0.3\n0\n"
G_TEXT = ("0\t2\t1\t1\t0.1\n0\t1\t99\t99\t0.5\n1\t2\t1\t1\t1.0\n"
          "1\t3\t2\t2\t2.0\n2\t3\t2\t2\t0.2\n2\t1\t99\t99\t0.3\n"
          "3\t1\t99\t99\t0.4\n1\n2\n3\n")
PHI_A = "0\t1\t1\t1\n1\t2\t2\t2\n2\t3\t2\t2\n3\n"


def mkgraph_steps(model: str) -> list:
    """utils/mkgraph.sh's steps as primitives (test_graph_primitives_cli
    .py:21) for a triphone system file `model`: [(output, argv(P, out))],
    each step reading what the steps before it wrote."""
    return [
        ("g.txt", lambda P, o: ["arpa2fst", P("lm.arpa"), P("words.txt"),
                                o]),
        ("lg0.txt", lambda P, o: ["fsttablecompose", P("L_disambig.txt"),
                                  P("g.txt"), o]),
        ("lg1.txt", lambda P, o: ["fstdeterminizelog", P("lg0.txt"), o]),
        ("lg.txt", lambda P, o: ["fstminimizeencoded", P("lg1.txt"), o]),
        ("clg.txt", lambda P, o: [
            "fstcomposecontext", P("ilabels.json"), P("lg.txt"), o,
            "--context-size", "3", "--central-position", "1",
            "--read-disambig-syms", P("phone_disambig.txt")]),
        ("ha.txt", lambda P, o: [
            "make-h-transducer", P("ilabels.json"), P(model), o,
            "--disambig-syms-out", P("disambig_tids.txt")]),
        ("hclga0.txt", lambda P, o: ["fst-compose", "--table", P("ha.txt"),
                                     P("clg.txt"), o]),
        ("hclga1.txt", lambda P, o: ["fst-determinize-star", "--use-log",
                                     P("hclga0.txt"), o]),
        ("hclga2.txt", lambda P, o: ["fstrmsymbols",
                                     P("disambig_tids.txt"),
                                     P("hclga1.txt"), o]),
        ("hclga3.txt", lambda P, o: ["fstrmepslocal", P("hclga2.txt"), o]),
        ("hclga.txt", lambda P, o: ["fst-minimize-encoded",
                                    P("hclga3.txt"), o]),
        ("hclg.txt", lambda P, o: ["fstaddselfloops", P(model),
                                   P("hclga.txt"), o, "--self-loop-scale",
                                   "0.1"]),
        ("graph.npz", lambda P, o: ["fst-pack-graph", P(model),
                                    P("hclg.txt"), o]),
    ]


MKGRAPH = mkgraph_steps("tri0.npz")


def _mkgraph_inputs(P, lang, save):
    """L with disambiguation, its disambiguation phones and the words of
    a system's lang, as mkgraph.sh finds them in data/lang (written by
    `save`, one package's save_fst)."""
    save(P("L_disambig.txt"), lang.L_disambig)
    with open(P("phone_disambig.txt"), "w") as f:
        f.writelines(f"{p}\n" for p in lang.disambig_phone_ids)
    lang.words.write(P("words.txt"))


def _random_acceptor(rng, labels, n_states=8):
    f = Fst()
    for _ in range(n_states):
        f.add_state()
    f.start = 0
    for s in range(n_states - 1):
        for _ in range(rng.randint(1, 3)):
            d = int(rng.randint(s + 1, n_states))
            lab = int(rng.choice(labels))
            f.add_arc(s, lab, lab, float(rng.uniform(0, 1)), d)
    f.set_final(n_states - 1, 0.0)
    f.connect()
    return f


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    root = tmp_path_factory.mktemp("fst")
    P = jax_system(root)
    for name, text in (("a.fst", A_TEXT), ("b.fst", B_TEXT),
                       ("g_phi.txt", G_TEXT), ("a_phi.txt", PHI_A),
                       ("nopath.fst", "0 1 1 1 0.5\n"),
                       ("phones.txt", "<eps> 0\na 1\nb 2\n"),
                       ("words.scp", "u1 3 4 3\nu2 4\n")):
        with open(P(name), "w") as f:
            f.write(text)
    rng = np.random.RandomState(0)
    save_fst(P("r1.fst"), _random_acceptor(rng, [1, 2, 3]))
    save_fst(P("r2.fst"), _random_acceptor(rng, [1, 2, 3]))
    save_fst(P("lin.fst"), Fst.linear_acceptor([5, 7]))
    rho = Fst()
    s0, s1, s2 = rho.add_state(), rho.add_state(), rho.add_state()
    rho.start = s0
    rho.add_arc(s0, 5, 5, 0.5, s1)
    rho.add_arc(s1, 100, 100, 1.5, s2)
    rho.set_final(s2, 0.0)
    save_fst(P("rho.fst"), rho)
    m = load_gmm_system(P("mono.npz"))
    loop = Fst()
    s = loop.add_state()
    loop.start = s
    loop.set_final(s, 0.0)
    for w in ("YES", "NO"):
        loop.add_arc(s, m.lang.words[w], m.lang.words[w], 0.7, s)
    with open(P("g.fsts"), "w") as f:
        for key in ("utt1", "utt2"):
            f.write(f"{key}\n")
            write_fst_text(f, loop)
            f.write("\n")
    phones = sorted({ph for (ph, _s, _p) in m.trans_model.tuples})
    with open(P("old_ilabels.json"), "w") as f:
        json.dump([[], [0]] + [[p] for p in phones], f)
    _mkgraph_inputs(P, m.lang, save_fst)
    for argv in (["acc-tree-stats", P("mono.npz"), F(P),
                  f"ark:{P('ali.ark')}", P("ts.npz")],
                 ["build-tree", P("mono.npz"), P("ts.npz"), P("tree3.npz"),
                  "--max-leaves", "30"],
                 ["gmm-init-model", P("mono.npz"), P("tree3.npz"),
                  P("ts.npz"), P("tri0.npz")]):
        assert _call(jmain, argv)[1] == 0, argv
    for out, argv in MKGRAPH:
        assert _call(jmain, argv(P, P(out)))[1] == 0, out
    return P


def _out(O, n):
    return os.path.join(O, n)


# (name, argv(P, O)): JAX's files, output and exit code
CASES = [
    ("fst-compose", lambda P, O: ["fst-compose", P("a.fst"), P("b.fst"),
                                  _out(O, "c.fst")]),
    *[(n, lambda P, O, n=n, i=i, x=x: [n, *x, P(i), _out(O, "o.fst")])
      for n, i, x in (
          ("fst-rmepsilon", "a.fst", []),
          ("fst-rmepsilon", "a.fst", ["--use-log"]),
          ("fst-determinize-star", "hclga0.txt", []),
          ("fstdeterminizestar", "lg0.txt", []),
          ("fst-arcsort", "a.fst", []),
          ("fst-arcsort", "a.fst", ["--sort-type", "olabel"]),
          ("fst-project", "a.fst", []),
          ("fst-project", "a.fst", ["--project-output"]),
          ("fst-invert", "a.fst", []),
          ("fst-connect", "r1.fst", []),
          ("fst-minimize-encoded", "lg1.txt", []),
          ("fst-push-special", "g.txt", []),
          ("fstpushspecial", "lg.txt", []),
          ("fst-rmepslocal", "hclga2.txt", []),
          ("fstcopy", "a.fst", []))],
    *[(n, lambda P, O, n=n, i=i: [n, P(i)])
      for n, i in (("fst-info", "lg.txt"), ("fst-info", "a.fst"),
                   ("fst-shortest-path", "a.fst"),
                   ("fst-shortest-path", "nopath.fst"),
                   ("fstisstochastic", "g.txt"),
                   ("fstisstochastic", "lg0.txt"))],
    ("fstisstochastic", lambda P, O: ["fstisstochastic", P("hclg.txt"),
                                      "--delta", "10"]),
    ("fstaddselfloops", lambda P, O: [
        "fstaddselfloops", P("tri0.npz"), P("hclga.txt"), _out(O, "o.fst")]),
    ("fst-rmsymbols", lambda P, O: ["fst-rmsymbols", P("disambig_tids.txt"),
                                    P("hclga1.txt"), _out(O, "o.fst")]),
    ("fst-compose-context", lambda P, O: [
        "fst-compose-context", _out(O, "il.json"), P("lg.txt"),
        _out(O, "o.fst"), "--read-disambig-syms", P("phone_disambig.txt")]),
    ("add-self-loops", lambda P, O: [
        "add-self-loops", P("tri0.npz"), P("hclga.txt"), _out(O, "o.fst"),
        "--disambig-syms", P("disambig_tids.txt")]),
    ("make-h-transducer", lambda P, O: [
        "make-h-transducer", P("ilabels.json"), P("tri0.npz"),
        _out(O, "o.fst"), "--transition-scale", "0.5"]),
    *[(n, lambda P, O, n=n: [n, "99", P("a_phi.txt"), P("g_phi.txt"),
                             _out(O, "o.fst")])
      for n in ("fst-phi-compose", "fstphicompose")],
    ("make-pdf-to-tid-transducer", lambda P, O: [
        "make-pdf-to-tid-transducer", P("mono.npz"), _out(O, "o.fst")]),
    ("transcripts-to-fsts", lambda P, O: [
        "transcripts-to-fsts", P("words.scp"), _out(O, "t.fsts")]),
    ("transcripts-to-fsts", lambda P, O: [
        "transcripts-to-fsts", P("text"), _out(O, "t.fsts"),
        "--word-symbols", P("words.txt")]),
    ("fsts-to-transcripts", lambda P, O: ["fsts-to-transcripts",
                                          P("g.fsts")]),
    ("compile-train-graphs", lambda P, O: [
        "compile-train-graphs", P("mono.npz"), P("text")]),
    ("fstaddsubsequentialloop", lambda P, O: [
        "fstaddsubsequentialloop", "77", P("lin.fst"), _out(O, "o.fst")]),
    ("fstfactor", lambda P, O: ["fstfactor", P("hclg.txt"),
                                _out(O, "f1.fst"), _out(O, "f2.fst")]),
    ("fstmakecontextfst", lambda P, O: [
        "fstmakecontextfst", P("phones.txt"), "9", _out(O, "il.json"),
        _out(O, "C.fst")]),
    ("fstmakecontextsyms", lambda P, O: [
        "fstmakecontextsyms", P("phones.txt"), P("ilabels.json")]),
    ("fstpropfinal", lambda P, O: ["fstpropfinal", "99", P("g_phi.txt"),
                                   _out(O, "o.fst")]),
    *[("fstrand", lambda P, O, x=x: ["fstrand", _out(O, "r.fst"), *x])
      for x in (["--seed", "3"], ["--seed", "11", "--max-states", "40",
                                  "--max-arcs-per-state", "5",
                                  "--allow-empty"])],
    ("fstrhocompose", lambda P, O: ["fstrhocompose", "100", P("lin.fst"),
                                    P("rho.fst"), _out(O, "o.fst")]),
    ("make-ilabel-transducer", lambda P, O: [
        "make-ilabel-transducer", P("old_ilabels.json"), P("mono.npz"),
        _out(O, "new.json"), "--fst-out", _out(O, "m.fst"),
        "--old2new-map", _out(O, "map.txt")]),
    ("compile-train-graphs-fsts", lambda P, O: [
        "compile-train-graphs-fsts", P("mono.npz"), f"ark:{P('g.fsts')}",
        f"ark:{_out(O, 'graphs.fsts')}"]),
    *[(argv(str, "")[0], lambda P, O, out=out, argv=argv:
       argv(P, _out(O, out))) for out, argv in MKGRAPH],
]


@pytest.mark.parametrize("name,argv", CASES,
                         ids=[f"{n}-{i}" for i, (n, _a) in
                              enumerate(CASES)])
def test_command_writes_jax_files(sysd, tmp_path, name, argv):
    same_files(_run(sysd, tmp_path, argv), code=None)


def test_mkgraph_chain_through_the_port(sysd, tmp_path):
    """The chain on a triphone model that the port trained from JAX's
    monophone: `mkgraph`'s state count, JAX's packed arrays, and the same
    words as `mkgraph`'s graph, at WER 0."""
    P = sysd
    T = lambda *n: str(tmp_path.joinpath(*n))                # noqa: E731

    def port(*argv, device=False):
        out, code = _call(tcli.main, list(argv) + (
            ["--device", "cpu"] if device else []))
        assert code == 0, argv
        return out
    port("train-deltas", P("mono.npz"), P("text"), F(P), T("tri.npz"),
         "--num-leaves", "40", "--totgauss", "150", "--num-iters", "8",
         device=True)
    info = port("tree-info", T("tri.npz"))
    assert "context-width 3" in info and "central-position 1" in info
    os.symlink(P("lm.arpa"), T("lm.arpa"))
    _mkgraph_inputs(T, tmio.load_gmm_system(T("tri.npz"), device="cpu")
                    .lang, tsave_fst)
    for out, argv in mkgraph_steps("tri.npz"):
        port(*argv(T, T(out)))
    assert _call(jmain, ["fst-pack-graph", T("tri.npz"), T("hclg.txt"),
                         T("jgraph.npz")])[1] == 0
    a, b = np.load(T("graph.npz")), np.load(T("jgraph.npz"))
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    port("mkgraph", T("tri.npz"), P("lm.arpa"), T("graph_mk.npz"))
    assert tmio.load_hclg(T("graph.npz")).num_states == \
        tmio.load_hclg(T("graph_mk.npz")).num_states
    hyps = []
    for g in ("graph.npz", "graph_mk.npz"):
        hyps.append(port("decode-faster", T("tri.npz"), T(g), F(P),
                         "--transcription-out", T(g + ".txt"),
                         device=True))
        hyps[-1] = open(T(g + ".txt")).read()
    assert hyps[0] == hyps[1]
    assert "%WER 0.00" in port("compute-wer", P("text"), T("graph.npz.txt"))
