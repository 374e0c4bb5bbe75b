"""Port parity: kaldi_tpu_torch's DenseViterbiDecoder and make_decoder
against kaldi_tpu's, on the CPU, with tests/test_dense_decoder.py's
contracts restated on the port.

Every forward path (associative scan, sequential, checkpointed) gives the
words and tids of the same JAX path, cost within 1e-4 relative, on the
yesno HCLG (17 states), the rm-like HCLG (86 states), a deep eps chain,
an eps-free graph and a star graph whose hub state has in-degree 100 (the
gather-min's hub branch), with Gaussian or integer-valued scores (ties).
The checkpointed traceback equals the full arena exactly, and dense equals
the port's padded beam decoder within cost 0.05 (PARITY.md:55).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.decoder import dense as jdense
from kaldi_tpu.decoder import graph_pack as jgp
from kaldi_tpu.fst import graph as jgraph
from kaldi_tpu.fst import lang as jlang
from kaldi_tpu.hmm import transition_model as jtm
from kaldi_tpu.lm import arpa as jarpa
from kaldi_tpu.tree import context_dep as jctx
from kaldi_tpu_torch.decoder import dense as tdense
from kaldi_tpu_torch.decoder import graph_pack as tgp
from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder
from kaldi_tpu_torch.fst import graph as tgraph
from kaldi_tpu_torch.fst import lang as tlang
from kaldi_tpu_torch.hmm import transition_model as ttm
from kaldi_tpu_torch.lm import arpa as tarpa
from kaldi_tpu_torch.tree import context_dep as tctx

torch.set_num_threads(2)

ASSOC = dict(assoc_max_states=64)
SEQ = dict(assoc_max_states=0)
CKPT = dict(assoc_max_states=0, traceback_chunk=8)


def _hclg(mods, lex, arpa):
    lang_m, arpa_m, graph_m, tm_m, ctx_m, gp_m = mods
    lang = lang_m.prepare_lang(lang_m.Lexicon.parse(lex), ["SIL"], "SIL",
                               num_sil_states=3)
    ctx = ctx_m.MonophoneContextDependency.from_topo(lang.topo)
    tm = tm_m.TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    g = arpa_m.arpa_to_g(arpa_m.ArpaLm.parse(arpa), lang.words)
    fst = graph_m.make_hclg(lang, g, tm, ctx, self_loop_scale=0.1).fst
    return gp_m.pack_graph(fst, tm.id2pdf_array), tm.num_pdfs


@pytest.fixture(scope="module", params=["yesno", "rm_like"])
def hclg(request):
    lex, arpa = {"yesno": (cs.YESNO_LEXICON, cs.YESNO_ARPA),
                 "rm_like": (cs.RM_LEXICON, cs.rm_unigram_arpa())}[
        request.param]
    jg, P = _hclg((jlang, jarpa, jgraph, jtm, jctx, jgp), lex, arpa)
    tg, _ = _hclg((tlang, tarpa, tgraph, ttm, tctx, tgp), lex, arpa)
    return request.param, jg, tg, P


def _same(got, want, cost_rel=1e-4):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), b
        if w is None:
            continue
        assert g[0] == w[0], f"utterance {b}: words"
        assert g[1] == w[1], f"utterance {b}: tids"
        assert g[2] == pytest.approx(w[2], rel=cost_rel, abs=1e-4), b


def _check(jg, tg, ll, nf, **opts):
    jd = jdense.DenseViterbiDecoder(jg, jdense.DenseDecoderOpts(**opts))
    td = tdense.DenseViterbiDecoder(tg, tdense.DenseDecoderOpts(**opts),
                                    device="cpu")
    assert td.opts.eps_expansions == jd.opts.eps_expansions
    got = td.decode(torch.from_numpy(ll), nf)
    _same(got, jd.decode(ll, nf))
    return td, got


def _ll(seed, B, T, P, integer=False):
    rng = np.random.RandomState(seed)
    if integer:
        return rng.randint(-20, 1, (B, T, P)).astype(np.float32)
    return (rng.randn(B, T, P) * 5.0).astype(np.float32)


@pytest.mark.parametrize("integer", [False, True], ids=["noise", "ties"])
def test_each_path_matches_jax_on_hclg(hclg, integer):
    name, jg, tg, P = hclg
    nf = np.array([53, 40, 21], np.int32)
    ll = _ll(1, 3, 53, P, integer)
    # the yesno graph takes the associative scan by default, rm-like the
    # sequential pass; each is also held to JAX on the other paths
    paths = [ASSOC, SEQ, CKPT] if name == "yesno" else [SEQ, CKPT]
    out = [_check(jg, tg, ll, nf, acoustic_scale=0.1, **p)[1] for p in paths]
    default = tdense.DenseViterbiDecoder(tg, device="cpu")
    _same(default.decode(ll, nf), out[0], cost_rel=0.0)
    assert all(r is not None and len(r[1]) == n for r, n in zip(out[0], nf))


def test_checkpointed_equals_full_arena(hclg):
    _name, _jg, tg, P = hclg
    nf = np.array([37, 20, 31], np.int32)     # 37 is not a multiple of 8
    ll = _ll(2, 3, 37, P)
    full = tdense.DenseViterbiDecoder(tg, tdense.DenseDecoderOpts(**SEQ),
                                      device="cpu").decode(ll, nf)
    ckpt = tdense.DenseViterbiDecoder(tg, tdense.DenseDecoderOpts(**CKPT),
                                      device="cpu").decode(ll, nf)
    assert ckpt == full


def test_dense_matches_padded_beam(hclg):
    _name, _jg, tg, P = hclg
    nf = np.array([45, 30], np.int32)
    ll = _ll(3, 2, 45, P)
    beam = BeamSearchDecoder(tg, BeamSearchOpts(
        beam=100.0, max_active=tg.num_states + 8, acoustic_scale=0.1),
        device="cpu").decode(ll, nf)
    dense = tdense.DenseViterbiDecoder(tg, device="cpu").decode(ll, nf)
    for d, b in zip(dense, beam):
        assert d[0] == b[0]
        assert d[2] == pytest.approx(b[2], abs=0.05)


def _mini_graph(arcs, num_states, start=0, finals=(1,), with_pdf=True):
    """arcs: [(src, dst, ilabel, olabel, cost, pdf)] -> (JAX, port)
    PackedGraphs (tests/test_dense_decoder.py's helper)."""
    arcs = sorted(arcs, key=lambda a: (a[0], -(a[2] > 0)))
    src = np.array([a[0] for a in arcs])
    arc_start = np.searchsorted(src, np.arange(num_states + 1)).astype(
        np.int32)
    final = np.full(num_states, np.inf, np.float32)
    for f in finals:
        final[f] = 0.0
    kw = dict(arc_start=arc_start,
              ilabel=np.array([a[2] for a in arcs], np.int32),
              olabel=np.array([a[3] for a in arcs], np.int32),
              cost=np.array([a[4] for a in arcs], np.float32),
              nextstate=np.array([a[1] for a in arcs], np.int32),
              final=final, start=start,
              pdf=np.array([a[5] for a in arcs], np.int32) if with_pdf
              else None)
    return jgp.PackedGraph(**kw), tgp.PackedGraph(**kw)


@pytest.mark.parametrize("path", [ASSOC, SEQ, CKPT],
                         ids=["assoc", "sequential", "checkpointed"])
def test_deep_eps_chain(path):
    # emit from 0->1, then 5 chained eps arcs 1..6, state 6 final
    arcs = [(0, 1, 1, 9, 0.1, 0)]
    arcs += [(1 + k, 2 + k, 0, 0, 0.1, -1) for k in range(5)]
    jg, tg = _mini_graph(arcs, 7, finals=(6,))
    td, got = _check(jg, tg, np.zeros((1, 1, 1), np.float32),
                     np.array([1], np.int32), acoustic_scale=1.0, **path)
    assert td.opts.eps_expansions == 5
    assert got[0][0] == [9] and got[0][2] == pytest.approx(0.6, abs=1e-4)


@pytest.mark.parametrize("path", [ASSOC, SEQ, CKPT],
                         ids=["assoc", "sequential", "checkpointed"])
def test_eps_free_graph(path):
    arcs = [(0, 1, 1, 7, 0.5, 0), (1, 1, 2, 0, 0.25, 0)]
    jg, tg = _mini_graph(arcs, 2, finals=(1,))
    td, got = _check(jg, tg, np.zeros((1, 3, 1), np.float32),
                     np.array([3], np.int32), acoustic_scale=1.0, **path)
    assert td.opts.eps_expansions == 0
    assert got[0][0] == [7] and len(got[0][1]) == 3
    assert got[0][2] == pytest.approx(1.0, abs=1e-4)


def _hub_graph(n_words=100):
    """chip_smoke's star graph: a hub of in-degree n_words + 1, integer
    costs."""
    tg = cs.dense_hub_graph(n_words)
    return jgp.PackedGraph(**dataclasses.asdict(tg)), tg


@pytest.mark.parametrize("path", [SEQ, CKPT], ids=["sequential",
                                                   "checkpointed"])
def test_hub_state_with_ties(path):
    jg, tg = _hub_graph()
    td = tdense.DenseViterbiDecoder(tg, tdense.DenseDecoderOpts(**path),
                                    device="cpu")
    assert td._e_tabs[1].numel() == 1 and int(td._e_tabs[1][0]) == 0
    nf = np.array([12, 9, 5], np.int32)
    _td, got = _check(jg, tg, _ll(6, 3, 12, 7, integer=True), nf,
                      acoustic_scale=1.0, **path)
    assert all(r is not None and r[0] for r in got)


def test_graph_without_pdfs_is_rejected():
    _jg, tg = _mini_graph([(0, 1, 1, 0, 0.0, 0)], 2, with_pdf=False)
    with pytest.raises(ValueError):
        tdense.DenseViterbiDecoder(tg, device="cpu")
    with pytest.raises(ValueError):
        BeamSearchDecoder(tg, device="cpu")


def test_make_decoder_dispatch(hclg):
    name, _jg, tg, _P = hclg
    d = tdense.make_decoder(tg, device="cpu")
    assert isinstance(d, tdense.DenseViterbiDecoder)
    assert d.opts.traceback_chunk == 0 and d.device.type == "cpu"
    assert (tg.num_states <= d.opts.assoc_max_states) == (name == "yesno")
    d2 = tdense.make_decoder(tg, dense_threshold=1, device="cpu")
    assert type(d2) is BeamSearchDecoder


def test_make_decoder_picks_checkpointed_dense_and_csr():
    S = 5000
    kw = dict(start=0, arc_start=np.zeros(S + 1, np.int32),
              ilabel=np.zeros(0, np.int32), olabel=np.zeros(0, np.int32),
              cost=np.zeros(0, np.float32), nextstate=np.zeros(0, np.int32),
              pdf=np.zeros(0, np.int32), final=np.zeros(S, np.float32))
    g = tgp.PackedGraph(**kw)
    jg = jgp.PackedGraph(**kw)
    d = tdense.make_decoder(g, batch_hint=(4, 100), device="cpu")
    assert isinstance(d, tdense.DenseViterbiDecoder)
    assert d.opts.traceback_chunk == 0
    for hint, budget in (((64, 2000), 1 << 30), ((64, 2000), 1 << 26)):
        d = tdense.make_decoder(g, batch_hint=hint, arena_budget_bytes=budget,
                                device="cpu")
        jd = jdense.make_decoder(jg, batch_hint=hint,
                                 arena_budget_bytes=budget)
        assert type(d).__name__ == type(jd).__name__
        if isinstance(d, tdense.DenseViterbiDecoder):
            assert d.opts.traceback_chunk == jd.opts.traceback_chunk > 0
    assert type(tdense.make_decoder(g, batch_hint=(64, 2000),
                                    arena_budget_bytes=1 << 20,
                                    device="cpu")) is BeamSearchDecoder
    # a fan-out past 1024 arcs with S over the threshold: the CSR decoder
    _jh, hub = _hub_graph(n_words=1100)
    d = tdense.make_decoder(hub, BeamSearchOpts(max_active=64),
                            dense_threshold=10, device="cpu")
    assert isinstance(d, CsrBeamDecoder)
    assert tdense.make_decoder(
        hub, BeamSearchOpts(max_active=64), dense_threshold=10_000,
        device="cpu").opts == dataclasses.replace(
            tdense.DenseDecoderOpts(), eps_expansions=1)
