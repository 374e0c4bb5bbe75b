"""Port parity: utterance- and frontier-sharded decoding against kaldi_tpu's.

Four gloo ranks run the port on a (2, 2) mesh and a (1, 4) mesh:
`decode_sharded` over 'data' (D = 2) for the dense decoder (the yesno
HCLG), `BeamSearchDecoder` and `CsrBeamDecoder` on
`make_big_hclg(vocab=200, ..., seed=3)` (tests/test_decode_sharded*.py's
graph and loglikes); `decode_frontier_sharded` over 'model' at D = 2 (each
data row of the (2, 2) mesh decodes on its own) and D = 4, on that graph,
with hubs (hub_threshold 64), with a starved tier-B budget, and on the
tier-B eps graph of test_decode_sharded_beam.py:78-108. Every rank returns
the same results; words and tids equal JAX's sharded and unsharded
decodes, costs within 1e-2, and the per-row counters (`last_overflow`
etc.) equal JAX's.
"""

import dataclasses

import numpy as np
import pytest

import jax

from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder as JBeam,
                                           BeamSearchOpts as JBeamOpts)
from kaldi_tpu.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder as JCsr
from kaldi_tpu.decoder.csr_beam import CsrBeamOpts as JCsrOpts
from kaldi_tpu.decoder.dense import DenseViterbiDecoder as JDense
from kaldi_tpu.decoder.graph_pack import PackedGraph as JPackedGraph
from kaldi_tpu.parallel.frontier_decode import (
    decode_frontier_sharded as j_frontier)
from kaldi_tpu.parallel.mesh import (decode_sharded as j_decode_sharded,
                                     make_mesh as j_make_mesh)
from kaldi_tpu_torch.decoder.graph_pack import PackedGraph

from torch_gang import run_gang

BIG = dict(vocab=200, avg_bigram_succ=12, num_pdfs=48, seed=3)
CSR = dict(beam=1e9, max_active=128, acoustic_scale=0.1, expand_budget=4096,
           eps_budget=512)
FRONTIER = {"big": CSR, "hub": dict(CSR, hub_threshold=64),
            "starved": dict(CSR, expand_budget=256, beam=12.0)}
EPS = dict(beam=1e9, max_active=8, acoustic_scale=1.0, expand_budget=64,
           eps_budget=64)
COUNTERS = ("last_overflow", "last_saturated", "last_active_sum",
            "last_active_max")


def _yesno_graph():
    """__graft_entry__.py's yesno HCLG (JAX's packed graph)."""
    from kaldi_tpu.decoder.graph_pack import pack_graph
    from kaldi_tpu.fst.graph import make_hclg
    from kaldi_tpu.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu.hmm.transition_model import TransitionModel
    from kaldi_tpu.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu.tree.context_dep import MonophoneContextDependency
    lang = prepare_lang(Lexicon.parse("YES Y1 Y2\nNO N1 N2"), ["SIL"], "SIL",
                        num_sil_states=3)
    ctx = MonophoneContextDependency.from_topo(lang.topo)
    tm = TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    g = arpa_to_g(ArpaLm.parse(
        "\\data\\\nngram 1=4\n\n\\1-grams:\n-1\tNO\n-1\tYES\n-99\t<s>\n"
        "-1\t</s>\n\n\\end\\\n"), lang.words)
    graph = make_hclg(lang, g, tm, ctx, self_loop_scale=0.1)
    return pack_graph(graph.fst, tm.id2pdf_array), tm.num_pdfs


def _eps_graph():
    """test_decode_sharded_beam.py's tier-B eps graph: the start state has
    3 eps arcs, each target an emitting self-loop and an arc to final."""
    arc_start = np.array([0, 3, 5, 7, 9, 10], np.int32)
    il = np.array([0, 0, 0, 1, 2, 1, 3, 1, 4, 1], np.int32)
    ol = np.array([0, 0, 0, 0, 11, 0, 12, 0, 13, 0], np.int32)
    cost = np.array([0.1, 0.2, 0.3, 0.5, 0.6, 0.5, 0.6, 0.5, 0.6, 0.5],
                    np.float32)
    nxt = np.array([1, 2, 3, 1, 4, 2, 4, 3, 4, 4], np.int32)
    pdf = np.where(il > 0, il - 1, -1).astype(np.int32)
    final = np.array([np.inf, np.inf, np.inf, np.inf, 0.0], np.float32)
    return dict(start=0, arc_start=arc_start, ilabel=il, olabel=ol, cost=cost,
                nextstate=nxt, pdf=pdf, final=final)


def _to_port(g: JPackedGraph) -> PackedGraph:
    return PackedGraph(**{f.name: getattr(g, f.name)
                          for f in dataclasses.fields(PackedGraph)})


@pytest.fixture(scope="module")
def inputs():
    yesno, n_pdfs = _yesno_graph()
    rng = np.random.RandomState(11)
    ll = (rng.randn(8, 40, 48) * 3).astype(np.float32)
    nf = np.array([40, 30, 40, 25, 40, 40, 33, 40], np.int32)
    ll_y = np.random.RandomState(1).randn(8, 12, n_pdfs).astype(np.float32)
    nf_y = np.array([12, 9, 12, 7, 12, 12, 10, 12], np.int32)
    ll_e = (np.random.RandomState(3).randn(1, 6, 4) * 2).astype(np.float32)
    return dict(yesno=yesno, ll=ll, nf=nf, ll_y=ll_y, nf_y=nf_y,
                ll_e=ll_e, nf_e=np.array([6], np.int32))


WORKER = r'''
from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
from kaldi_tpu_torch.decoder.dense import DenseViterbiDecoder
from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
from kaldi_tpu_torch.parallel import decode_frontier_sharded, decode_sharded, make_mesh
A = ARGS
mesh22 = make_mesh(2, 2, device="cpu")
mesh14 = make_mesh(1, 4, device="cpu")
big, _ = make_big_hclg(BigGraphConfig(**A["big"]))
COUNTERS = ("last_overflow", "last_saturated", "last_active_sum",
            "last_active_max")
out = {"dense": decode_sharded(DenseViterbiDecoder(A["yesno"], device="cpu"),
                               A["ll_y"], A["nf_y"], mesh22),
       "beam": decode_sharded(BeamSearchDecoder(big, BeamSearchOpts(
           beam=1e9, max_active=128, acoustic_scale=0.1), device="cpu"),
           A["ll"], A["nf"], mesh22)}
csr = CsrBeamDecoder(big, CsrBeamOpts(**A["csr"]), device="cpu")
out["csr"] = (decode_sharded(csr, A["ll"], A["nf"], mesh22),
              {k: getattr(csr, k) for k in COUNTERS})
cases = {name: (big, opts, A["ll"][:2], A["nf"][:2])
         for name, opts in A["frontier"].items()}
cases["eps"] = (PackedGraph(**A["eps_graph"]), A["eps"], A["ll_e"], A["nf_e"])
for name, (graph, opts, ll, nf) in cases.items():
    dec = CsrBeamDecoder(graph, CsrBeamOpts(**opts), device="cpu")
    for D, mesh in ((2, mesh22), (4, mesh14)):
        res = decode_frontier_sharded(dec, ll, nf, mesh, axis="model")
        out[(name, D)] = (res, dec.last_overflow.copy(),
                          dec.last_exchange_rounds, dec.last_gathered_bytes)
save(out)
'''


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    args = dict(inputs, yesno=_to_port(inputs["yesno"]), big=BIG, csr=CSR,
                frontier=FRONTIER, eps=EPS, eps_graph=_eps_graph())
    return run_gang(tmp_path_factory.mktemp("decode"), "decode", WORKER, 4,
                    args)


def _same(a, b, what):
    assert (a is None) == (b is None), what
    if a is None:
        return
    assert list(a[0]) == list(b[0]), what
    assert list(a[1]) == list(b[1]), what
    assert abs(a[2] - b[2]) < 1e-2, what


def _jax_utt_sharded(dec, ll, nf):
    mesh = j_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    return dec.decode(ll, nf), j_decode_sharded(dec, ll, nf, mesh)


def test_ranks_agree(ranks):
    """Every rank returns every result (gathered, or replicated by the
    frontier exchange)."""
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k in r:
            a, b = r[k], ranks[0][k]
            if k == "csr" or isinstance(k, tuple):
                a, b = a[0], b[0]
            for x, y in zip(a, b):
                _same(x, y, k)
                if x is not None:
                    assert x[2] == y[2], k


def test_dense_decode_sharded(ranks, inputs):
    single, sharded = _jax_utt_sharded(JDense(inputs["yesno"]),
                                       inputs["ll_y"], inputs["nf_y"])
    for r in ranks:
        assert len(r["dense"]) == 8
        for b in range(8):
            _same(r["dense"][b], single[b], b)
            _same(r["dense"][b], sharded[b], b)


def test_beam_search_decode_sharded(ranks, inputs):
    g, _ = make_big_hclg(BigGraphConfig(**BIG))
    single, sharded = _jax_utt_sharded(
        JBeam(g, JBeamOpts(beam=1e9, max_active=128, acoustic_scale=0.1)),
        inputs["ll"], inputs["nf"])
    for r in ranks:
        for b in range(8):
            _same(r["beam"][b], single[b], b)
            _same(r["beam"][b], sharded[b], b)


def test_csr_decode_sharded(ranks, inputs):
    g, _ = make_big_hclg(BigGraphConfig(**BIG))
    dec = JCsr(g, JCsrOpts(**CSR))
    single = dec.decode(inputs["ll"], inputs["nf"])
    counters = {k: getattr(dec, k) for k in COUNTERS}
    sharded = j_decode_sharded(dec, inputs["ll"], inputs["nf"],
                               j_make_mesh(data=2, model=1,
                                           devices=jax.devices()[:2]))
    for r in ranks:
        res, got = r["csr"]
        for b in range(8):
            _same(res[b], single[b], b)
            _same(res[b], sharded[b], b)
        for k in COUNTERS:
            np.testing.assert_array_equal(got[k], counters[k], err_msg=k)


@pytest.mark.parametrize("name", ["big", "hub", "starved", "eps"])
@pytest.mark.parametrize("D", [2, 4])
def test_frontier_sharded(ranks, inputs, name, D):
    """Frontier-sharded decode == JAX's at the same D (words, tids, costs,
    overflow) and == the unsharded CSR decoder where no budget binds."""
    if name == "eps":
        graph, opts = JPackedGraph(**_eps_graph()), EPS
        ll, nf = inputs["ll_e"], inputs["nf_e"]
    else:
        graph, _ = make_big_hclg(BigGraphConfig(**BIG))
        opts = FRONTIER[name]
        ll, nf = inputs["ll"][:2], inputs["nf"][:2]
    dec = JCsr(graph, JCsrOpts(**opts))
    single = dec.decode(ll, nf)
    jres = j_frontier(dec, ll, nf,
                      j_make_mesh(data=1, model=D, devices=jax.devices()[:D]),
                      axis="model")
    j_ovf = dec.last_overflow
    for r in ranks:
        res, ovf, rounds, nbytes = r[(name, D)]
        np.testing.assert_array_equal(ovf, j_ovf)
        assert rounds == int(nf.sum()) * (1 + dec.opts.eps_expansions) \
            + len(nf) * dec.opts.eps_expansions
        assert nbytes > 0
        for b in range(len(nf)):
            assert res[b] is not None
            _same(res[b], jres[b], (name, D, b))
            if name != "starved":
                _same(res[b], single[b], (name, D, b))
    if name == "starved":
        assert j_ovf.sum() > 0        # the budget binds: a real overflow
    elif name == "eps":
        assert j_ovf[0] == 0
