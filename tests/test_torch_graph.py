"""Port parity: the port's numpy copies of the decoder's host code produce
arrays equal to kaldi_tpu's (graph build, CSR split, eps folding, corpus
synthesis, tier-table packing), and so do its copies of the GMM path's
graph stack (prepare_lang, arpa_to_g, make_hclg, TrainingGraphCompiler,
the transition model, pack_graph and pack_graphs) for the yesno and
rm-like lexicons; with N-phone context (a synthetic triphone tree carried
across) the HCLGs, training graphs, `compose_context` and the flat
pipeline over the port's own native graph ops are equal too."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.decoder import biggraph as jbig
from kaldi_tpu.decoder import csr_beam as jcsr
from kaldi_tpu.decoder import graph_pack as jgp
from kaldi_tpu.decoder import simulate as jsim
from kaldi_tpu.fst import graph as jgraph
from kaldi_tpu.fst import lang as jlang
from kaldi_tpu.hmm import transition_model as jtm
from kaldi_tpu.lm import arpa as jarpa
from kaldi_tpu.tree import context_dep as jctx
from kaldi_tpu.utils import wer as jwer
from kaldi_tpu_torch.decoder import biggraph as tbig
from kaldi_tpu_torch.decoder import csr_beam as tcsr
from kaldi_tpu_torch.decoder import graph_pack as tgp
from kaldi_tpu_torch.decoder import simulate as tsim
from kaldi_tpu_torch.fst import graph as tgraph
from kaldi_tpu_torch.fst import lang as tlang
from kaldi_tpu_torch.hmm import transition_model as ttm
from kaldi_tpu_torch.lm import arpa as tarpa
from kaldi_tpu_torch.tree import context_dep as tctx
from kaldi_tpu_torch.utils import wer as twer

torch.set_num_threads(2)

CONFIGS = [dict(vocab=300, avg_bigram_succ=20, num_pdfs=64, seed=1),
           dict(vocab=200, avg_bigram_succ=12, num_pdfs=64, seed=3)]


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        else:
            assert x == y, f.name


@pytest.fixture(scope="module", params=range(len(CONFIGS)))
def graphs(request):
    kw = CONFIGS[request.param]
    jg, jn = jbig.make_big_hclg(jbig.BigGraphConfig(**kw))
    tg, tn = tbig.make_big_hclg(tbig.BigGraphConfig(**kw))
    assert jn == tn
    return jg, tg


def test_make_big_hclg_equal(graphs):
    _assert_fields_equal(*graphs)


def test_split_csr_and_eps_depth_equal(graphs):
    jg, tg = graphs
    _assert_fields_equal(jgp.split_csr(jg), tgp.split_csr(tg))
    assert jgp.eps_depth(jg) == tgp.eps_depth(tg) == 1


def test_fold_epsilons_equal(graphs):
    jg, tg = graphs
    jf, tf = jgp.fold_epsilons(jg), tgp.fold_epsilons(tg)
    assert jf is not None and tf is not None
    _assert_fields_equal(jf, tf)
    assert tgp.eps_depth(tf) == 0


def test_make_corpus_equal(graphs):
    jg, tg = graphs
    jw, js, jwords = jsim.make_corpus(jg, 2, 120, np.random.default_rng(0),
                                      noise=0.25)
    tw, ts, twords = tsim.make_corpus(tg, 2, 120, np.random.default_rng(0),
                                      noise=0.25)
    np.testing.assert_array_equal(jw, tw)
    np.testing.assert_array_equal(js, ts)
    assert jwords == twords
    np.testing.assert_array_equal(jsim.fbank_targets(js[0], 118),
                                  tsim.fbank_targets(ts[0], 118))


@pytest.mark.parametrize("force_triple", [False, True])
@pytest.mark.parametrize("hub_threshold", [1024, 64])
@pytest.mark.parametrize("fold", [True, False])
def test_build_tier_tables_equal(graphs, force_triple, hub_threshold, fold):
    jg, tg = graphs
    if fold:
        jg, tg = jgp.fold_epsilons(jg), tgp.fold_epsilons(tg)
    jt = jcsr.build_tier_tables(jgp.split_csr(jg), hub_threshold,
                                force_triple=force_triple)
    tt = tcsr.build_tier_tables(tgp.split_csr(tg), hub_threshold,
                                force_triple=force_triple, device="cpu")
    assert tt.b_apr == jt.b_apr == (3 if force_triple else 4)
    for f in dataclasses.fields(jt):
        x, y = getattr(jt, f.name), getattr(tt, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif isinstance(y, torch.Tensor):
            assert np.array_equal(np.asarray(x), y.numpy()), f.name
            assert np.asarray(x).dtype == y.numpy().dtype, f.name
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    if hub_threshold == 64:
        assert len(tt.hub_bounds) > 1 and tt.hub_onehot is not None


def test_one_row_tier_b_is_padded_to_two_rows():
    """A tier B that packs into exactly one row still gets two rows, so it
    is not mistaken for the empty-tier dummy (the padding row is dead)."""
    arc_start = np.array([0, 3, 4, 5, 6], np.int32)
    g = tgp.PackedGraph(
        arc_start=arc_start, ilabel=np.array([1, 2, 3, 1, 2, 3], np.int32),
        olabel=np.zeros(6, np.int32), cost=np.ones(6, np.float32),
        nextstate=np.array([1, 2, 3, 0, 0, 0], np.int32),
        final=np.zeros(4, np.float32), start=0,
        pdf=np.array([0, 1, 2, 0, 1, 2], np.int32))
    tt = tcsr.build_tier_tables(tgp.split_csr(g), 1024, device="cpu")
    jt = jcsr.build_tier_tables(jgp.split_csr(g), 1024)
    assert tuple(tt.brow.shape) == (2, 16)
    np.testing.assert_array_equal(tt.brow.numpy(), np.asarray(jt.brow))


# --- the GMM path's graph stack (kaldi_tpu/fst, hmm, tree, lm copies) ---

# a bigram LM with backoffs over the yesno words: arpa_to_g's history
# states and #0 backoff arcs
YESNO_BIGRAM = """\\data\\
ngram 1=4
ngram 2=4

\\1-grams:
-0.5\t</s>
-99\t<s>\t-0.3
-0.4\tYES\t-0.2
-0.6\tNO\t-0.25

\\2-grams:
-0.2\t<s> YES
-0.3\tYES NO
-0.1\tNO </s>
-0.4\tNO YES

\\end\\
"""
LEXICONS = {"yesno": (cs.YESNO_LEXICON, cs.YESNO_ARPA),
            "yesno_bigram": (cs.YESNO_LEXICON, YESNO_BIGRAM),
            "rm_like": (cs.RM_LEXICON, cs.rm_unigram_arpa()),
            "tri": (cs.TRI_LEXICON, cs.TRI_ARPA)}
TRANSCRIPTS = {"yesno": [["YES"], ["NO", "YES"], ["YES", "YES", "NO"],
                         ["NO", "NO", "NO", "YES"], ["YES", "NO"]],
               "rm_like": [["ONE", "TWO"], ["THREE", "STOP", "OH"],
                           ["SEVEN"], ["ZERO", "EIGHT", "NINE", "FOUR"],
                           ["FIVE", "SIX", "ONE", "ONE", "TWO"]],
               "tri": [["AB"], ["CA", "AB"], ["BC", "AC", "CA"]]}


def _fst_equal(a, b):
    assert a.start == b.start
    assert a.arcs == b.arcs
    assert a.finals == b.finals


def _syms_equal(a, b):
    assert a._i2s == b._i2s and a._s2i == b._s2i


def _gmm_stack(mod_lang, mod_arpa, mod_graph, mod_tm, mod_ctx, name):
    lex_text, arpa = LEXICONS[name]
    lang = mod_lang.prepare_lang(mod_lang.Lexicon.parse(lex_text), ["SIL"],
                                 "SIL", num_sil_states=3)
    ctx = mod_ctx.MonophoneContextDependency.from_topo(lang.topo)
    tm = mod_tm.TransitionModel(lang.topo,
                                lambda ph, pc: ctx.compute([ph], pc))
    g = mod_arpa.arpa_to_g(mod_arpa.ArpaLm.parse(arpa), lang.words)
    hclg = mod_graph.make_hclg(lang, g, tm, ctx, self_loop_scale=0.1)
    return lang, ctx, tm, g, hclg


@pytest.fixture(scope="module", params=list(LEXICONS))
def gmm_stacks(request):
    j = _gmm_stack(jlang, jarpa, jgraph, jtm, jctx, request.param)
    t = _gmm_stack(tlang, tarpa, tgraph, ttm, tctx, request.param)
    return request.param, j, t


def test_lang_and_g_equal(gmm_stacks):
    _name, (jl, _jc, _jt, jg, _jh), (tl, _tc, _tt, tg, _th) = gmm_stacks
    _syms_equal(jl.phones, tl.phones)
    _syms_equal(jl.words, tl.words)
    _fst_equal(jl.L, tl.L)
    _fst_equal(jl.L_disambig, tl.L_disambig)
    assert jl.num_disambig == tl.num_disambig
    assert jl.disambig_phone_ids == tl.disambig_phone_ids
    _fst_equal(jg, tg)


def test_transition_model_equal(gmm_stacks):
    _name, (_jl, jc, jt, _jg, _jh), (_tl, tc, tt, _tg, _th) = gmm_stacks
    assert jc.num_pdfs == tc.num_pdfs == jt.num_pdfs == tt.num_pdfs
    assert jt.tuples == tt.tuples
    np.testing.assert_array_equal(jt.id2pdf_array, tt.id2pdf_array)
    np.testing.assert_array_equal(jt.log_probs, tt.log_probs)
    counts = np.random.RandomState(0).randint(0, 40, jt.num_transition_ids + 1)
    assert jt.mle_update(counts) == tt.mle_update(counts)
    np.testing.assert_array_equal(jt.log_probs, tt.log_probs)
    assert tt.log_probs.dtype == jt.log_probs.dtype == np.float32


def test_hclg_and_pack_graph_equal(gmm_stacks):
    name, (_jl, _jc, jt, _jg, jh), (_tl, _tc, tt, _tg, th) = gmm_stacks
    _fst_equal(jh.fst, th.fst)
    _assert_fields_equal(jgp.pack_graph(jh.fst, jt.id2pdf_array),
                         tgp.pack_graph(th.fst, tt.id2pdf_array))
    want = {"yesno": 17, "rm_like": 86}.get(name)
    assert want is None or th.fst.num_states == want


@pytest.mark.parametrize("name", list(TRANSCRIPTS))
def test_training_graphs_and_pack_graphs_equal(name):
    stacks = []
    for mods in ((jlang, jarpa, jgraph, jtm, jctx),
                 (tlang, tarpa, tgraph, ttm, tctx)):
        lang, ctx, tm, _g, _h = _gmm_stack(*mods, name)
        comp = mods[2].TrainingGraphCompiler(lang, tm, ctx, 1.0, 0.1)
        stacks.append((tm, [comp.compile_transcript(w)
                            for w in TRANSCRIPTS[name]]))
    (jt, jfs), (tt, tfs) = stacks
    for a, b in zip(jfs, tfs):
        _fst_equal(a, b)
    _assert_fields_equal(jgp.pack_graphs(jfs, jt.id2pdf_array),
                         tgp.pack_graphs(tfs, tt.id2pdf_array))


# --- N-phone context: a synthetic tied-triphone tree (kaldi_tpu's
# tree/synth.py, carried across by params.event_map_from_jax) ---

def _tri_stack(name, side):
    """`name`'s lang and G, a 2 x 3-group synthetic triphone tree and the
    transition model built from it, in the JAX package (side "j") or the
    port ("t"): -> (lang, ctx, tm, g)."""
    from kaldi_tpu.steps.deltas import transition_model_from_tree as jtree_tm
    from kaldi_tpu.tree.synth import synth_triphone_tree
    from kaldi_tpu_torch.params import event_map_from_jax
    from kaldi_tpu_torch.steps.deltas import transition_model_from_tree
    lex_text, arpa = LEXICONS[name]
    mods = (jlang, jarpa) if side == "j" else (tlang, tarpa)
    lang = mods[0].prepare_lang(mods[0].Lexicon.parse(lex_text), ["SIL"],
                                "SIL", num_sil_states=3)
    jl = jlang.prepare_lang(jlang.Lexicon.parse(lex_text), ["SIL"], "SIL",
                            num_sil_states=3)
    ctx = synth_triphone_tree(jl.topo, [jl.phones["SIL"]], 2, 3,
                              np.random.default_rng(0))
    if side == "j":
        tm = jtree_tm(lang, ctx)
    else:
        ctx = tctx.TreeContextDependency(3, 1,
                                         event_map_from_jax(ctx.event_map),
                                         ctx.num_pdfs)
        tm = transition_model_from_tree(lang, ctx)
    g = mods[1].arpa_to_g(mods[1].ArpaLm.parse(arpa), lang.words)
    return lang, ctx, tm, g


@pytest.mark.parametrize("name", list(LEXICONS))
def test_nphone_hclg_equal(name):
    stacks = {side: _tri_stack(name, side) for side in "jt"}
    (jl, jc, jt, jg), (tl, tc, tt, tg) = stacks["j"], stacks["t"]
    assert tt.tuples == jt.tuples
    np.testing.assert_array_equal(tt.id2pdf_array, jt.id2pdf_array)
    jh = jgraph.make_hclg(jl, jg, jt, jc, self_loop_scale=0.1)
    th = tgraph.make_hclg(tl, tg, tt, tc, self_loop_scale=0.1)
    _fst_equal(jh.fst, th.fst)
    _assert_fields_equal(jgp.pack_graph(jh.fst, jt.id2pdf_array),
                         tgp.pack_graph(th.fst, tt.id2pdf_array))
    assert th.fst.num_states > 20


@pytest.mark.parametrize("name", list(TRANSCRIPTS))
def test_nphone_training_graphs_equal(name):
    graphs = []
    for side, mod in (("j", jgraph), ("t", tgraph)):
        lang, ctx, tm, _g = _tri_stack(name, side)
        comp = mod.TrainingGraphCompiler(lang, tm, ctx, 1.0, 0.1)
        graphs.append((tm, [comp.compile_transcript(w)
                            for w in TRANSCRIPTS[name]]))
    (jt, jfs), (tt, tfs) = graphs
    for a, b in zip(jfs, tfs):
        _fst_equal(a, b)
    _assert_fields_equal(jgp.pack_graphs(jfs, jt.id2pdf_array),
                         tgp.pack_graphs(tfs, tt.id2pdf_array))


@pytest.mark.parametrize("name", ["yesno_bigram", "tri"])
def test_compose_context_equal(name):
    from kaldi_tpu.fst import context as jcontext
    from kaldi_tpu.fst.compose import compose as jcompose
    from kaldi_tpu.fst.determinize import determinize_star as jdet
    from kaldi_tpu_torch.fst import context as tcontext
    from kaldi_tpu_torch.fst.compose import compose as tcompose
    from kaldi_tpu_torch.fst.determinize import determinize_star as tdet
    out = []
    for side, compose, det, context in (("j", jcompose, jdet, jcontext),
                                        ("t", tcompose, tdet, tcontext)):
        lang, _c, _tm, g = _tri_stack(name, side)
        lg = det(compose(lang.L_disambig, g), use_log=True)
        dis = set(lang.disambig_phone_ids)
        out.append((context.compose_context(lg, dis, N=3, P=1),
                    context.make_context_fst(list(lang.topo.phones), dis,
                                             len(lang.phones), N=3, P=1)))
    ((jclg, jinfo), (jC, jcinfo)), ((tclg, tinfo), (tC, tcinfo)) = out
    _fst_equal(jclg, tclg)
    assert tinfo == jinfo and len(jinfo) > 10
    _fst_equal(jC, tC)
    assert tcinfo == jcinfo


JAX_FST_FLAGS = ("-O3", "-shared", "-fPIC")     # kaldi_tpu/fst/native_ops.py


def jax_fst_ops(monkeypatch) -> str:
    """Point kaldi_tpu.fst.native_ops at a build of native/fst_ops.cc of
    this test's own, for the test's duration: compiled with JAX's flags
    into a temporary file under build/ and moved into place with
    os.replace, so that xdist workers that build at once never load a
    half-written library (JAX's own build writes `g++ -o` straight to
    native/libkaldi_tpu_fst_ops.so, and a worker that fails to load it
    latches None until it exits). -> the library's path."""
    import hashlib
    import subprocess
    import tempfile
    from kaldi_tpu.fst import native_ops as jno
    src = os.path.join(cs.ROOT, "native", "fst_ops.cc")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(JAX_FST_FLAGS).encode()
                             ).hexdigest()[:16]
    so = os.path.join(cs.ROOT, "build", "kaldi_tpu_fst_ops", key,
                      "libkaldi_tpu_fst_ops.so")
    if not os.path.exists(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
        os.close(fd)
        try:
            subprocess.run(["g++", *JAX_FST_FLAGS, "-o", tmp, src],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if os.path.getmtime(so) < os.path.getmtime(src):
        os.utime(so)        # JAX's loader rebuilds a library older than src
    monkeypatch.setattr(jno, "_SO", so)
    monkeypatch.setattr(jno, "_lib", None)
    monkeypatch.setattr(jno, "_tried", False)
    return so


def _flat_equal(name, context, monkeypatch):
    from kaldi_tpu.fst import mkgraph_flat as jmf
    from kaldi_tpu.fst import native_ops as jno
    from kaldi_tpu_torch.fst import mkgraph_flat as tmf
    from kaldi_tpu_torch.fst import native_ops
    so = jax_fst_ops(monkeypatch)
    assert native_ops.available() and jno.available() and jno._SO == so
    out = []
    for side, mf in (("j", jmf), ("t", tmf)):
        if context == "tri":
            lang, ctx, tm, g = _tri_stack(name, side)
        else:
            mods = ((jlang, jarpa, jgraph, jtm, jctx) if side == "j"
                    else (tlang, tarpa, tgraph, ttm, tctx))
            lang, ctx, tm, g, _h = _gmm_stack(*mods, name)
        flat, stats = mf.make_hclg_flat(lang, g, tm, ctx, self_loop_scale=0.1)
        out.append((flat, stats, mf.pack_graph_flat(flat, tm.id2pdf_array)))
    (jf, js, jp), (tf, ts, tp) = out
    assert ts == js
    _assert_fields_equal(jf, tf)
    _assert_fields_equal(jp, tp)
    assert native_ops.library_path().startswith(os.path.join(
        cs.ROOT, "build", "kaldi_tpu_torch"))


@pytest.mark.parametrize("context", ["mono", "tri"])
@pytest.mark.parametrize("name", ["yesno_bigram", "rm_like", "tri"])
def test_make_hclg_flat_equal(name, context, monkeypatch):
    """The flat pipeline over the native graph ops (the port's own copy of
    native/fst_ops.cc, built at first use) equals JAX's array for array,
    and so does its packed graph. JAX's side loads its library from this
    test's own atomic build (`jax_fst_ops`)."""
    _flat_equal(name, context, monkeypatch)


def test_make_hclg_flat_equal_after_a_failed_jax_load(monkeypatch):
    """A worker whose JAX native_ops latched a failed load (as one that
    read a half-written library does) still holds the flat graphs equal:
    the test loads JAX's library from its own build."""
    from kaldi_tpu.fst import native_ops as jno
    monkeypatch.setattr(jno, "_lib", None)
    monkeypatch.setattr(jno, "_tried", True)
    monkeypatch.setattr(jno, "_SO", os.path.join(cs.ROOT, "build",
                                                 "no_such_library.so"))
    _flat_equal("rm_like", "tri", monkeypatch)


def test_ladder_corpus_equals_tests_ladder_corpus():
    """chip_smoke's copy of the full ladder's corpus synthesis equals
    tests/ladder_corpus.build_corpus with test_ladder_full._mv as its
    vocabulary, at test_ladder_full.py's seed and sizes."""
    import ladder_corpus
    from test_ladder_full import _mv
    kw = dict(cs.LADDER)
    rng = np.random.RandomState(kw.pop("seed"))
    old = ladder_corpus.make_vocab
    ladder_corpus.make_vocab = _mv
    try:
        want = ladder_corpus.build_corpus(rng, **kw)
    finally:
        ladder_corpus.make_vocab = old
    got = cs.ladder_corpus(**cs.LADDER)
    assert got["lex_text"] == want["lex_text"]
    assert got["words"] == want["words"]
    for part in ("train", "test"):
        assert len(got[part]) == len(want[part]) > 0
        for (gu, gw, gws, gs), (wu, ww, wws, ws) in zip(got[part],
                                                        want[part]):
            assert (gu, gws, gs) == (wu, wws, ws)
            np.testing.assert_array_equal(gw, ww)
            assert gw.dtype == ww.dtype


def test_compute_wer_equals_jax():
    """The copy of utils/wer.py scores as JAX's, and chip_smoke's corpus
    WER is its percentage."""
    rng = np.random.RandomState(0)
    for _ in range(50):
        n = rng.randint(1, 5)
        refs = {i: list(rng.randint(0, 4, rng.randint(0, 7)))
                for i in range(n)}
        hyps = {i: list(rng.randint(0, 4, rng.randint(0, 7)))
                for i in range(n) if rng.rand() > 0.2}
        j, t = jwer.compute_wer(refs, hyps), twer.compute_wer(refs, hyps)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert str(t) == str(j)
        assert cs.wer(list(refs.values()),
                      [hyps.get(i, []) for i in refs]) == j.wer
        r, h = refs[0], hyps.get(0, [])
        assert twer.levenshtein_alignment(r, h) == \
            jwer.levenshtein_alignment(r, h)
