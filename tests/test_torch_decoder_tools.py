"""Port parity: kaldi_tpu_torch/decoder/batching.py, verify.py and
simple.py against kaldi_tpu's on the CPU.

- `bucket_boundaries` gives JAX's buckets; `decode_batched` over the
  port's `CsrBeamDecoder` equals the decode of each utterance alone (B = 1,
  the same loglikes rows cut to its length) and JAX's `decode_batched` over
  JAX's decoder (words, tids, cost 1e-4) on the same seeded features.
- `check_packed_graph` and `check_tier_tables` pass on the port's graphs
  and tier tables (quad and triple tier-B layouts, with a hub), and every
  corruption of tests/test_csr_beam.py:383-430 and :736 and of
  tests/test_cli_more.py:118-149, plus a live tier-B padding arc, raises
  in both packages with the same message.
- `simple_decode` equals JAX's, and the CSR decoder's words and cost at a
  beam wide enough that neither prunes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from kaldi_tpu.decoder import batching as jbatching
from kaldi_tpu.decoder import simple as jsimple
from kaldi_tpu.decoder import verify as jverify
from kaldi_tpu.decoder.biggraph import (BigGraphConfig as JBigGraphConfig,
                                        make_big_hclg as jmake_big_hclg)
from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder as JCsr,
                                        CsrBeamOpts as JCsrOpts)
from kaldi_tpu.decoder.graph_pack import PackedGraph as JPackedGraph
from kaldi_tpu_torch.decoder import batching as tbatching
from kaldi_tpu_torch.decoder import simple as tsimple
from kaldi_tpu_torch.decoder import verify as tverify
from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
from kaldi_tpu_torch.decoder.graph_pack import PackedGraph

torch.set_num_threads(2)

SMALL = cs.TOOLS_GRAPH


@pytest.fixture(scope="module")
def graphs():
    """tests/test_csr_beam.py's small_big_graph in both packages (held
    equal array for array by tests/test_torch_graph.py)."""
    return (make_big_hclg(BigGraphConfig(**SMALL))[0],
            jmake_big_hclg(JBigGraphConfig(**SMALL))[0])


@pytest.mark.parametrize("lengths,kw", [
    ([70, 100, 400, 900], dict(max_buckets=4, min_len=64)),
    ([3, 5, 64, 65, 2000], {}),
    ([10, 10, 10], dict(growth=1.1)),
    ([300, 301, 1000, 1001, 5000], dict(max_buckets=3, growth=2.0)),
])
def test_bucket_boundaries_equal_jax(lengths, kw):
    assert tbatching.bucket_boundaries(lengths, **kw) == \
        jbatching.bucket_boundaries(lengths, **kw)


def test_decode_batched_equals_single_and_jax(graphs):
    tg, jg = graphs
    utts = cs.tools_utts()
    dec = CsrBeamDecoder(tg, CsrBeamOpts(**cs.TOOLS_CSR), device="cpu")
    seen = []

    def score(x):
        assert torch.is_tensor(x) and x.device.type == "cpu"
        seen.append(tuple(x.shape))
        return cs.tools_score(x)
    got = tbatching.decode_batched(dec, utts, score, batch_size=2,
                                   max_buckets=3, device="cpu")
    # the buckets and batches JAX's decode_batched makes
    assert seen == [(2, 64, 8)] * 2 + [(2, 90, 8), (2, 126, 8)]
    assert [(b, [k for k, _f in m]) for b, m in tbatching.bucket_batches(
        utts, 2, 3)] == [(64, ["u0", "u1"]), (64, ["u2"]),
                         (90, ["u3", "u4"]), (126, ["u5", "u6"])]
    assert set(got) == {k for k, _f in utts}
    for k, f in utts:
        one = dec.decode(cs.tools_score(f[None]), np.array([f.shape[0]]))[0]
        assert got[k] is not None and one is not None
        assert list(got[k][0]) == list(one[0]), k
        assert list(got[k][1]) == list(one[1]), k
        assert got[k][2] == pytest.approx(one[2], abs=1e-4), k
    jdec = JCsr(jg, JCsrOpts(**cs.TOOLS_CSR))
    jgot = jbatching.decode_batched(jdec, utts, cs.tools_score, batch_size=2,
                                    max_buckets=3)
    for k, _f in utts:
        assert list(got[k][0]) == list(jgot[k][0]), k
        assert list(got[k][1]) == list(jgot[k][1]), k
        assert got[k][2] == pytest.approx(jgot[k][2], abs=1e-4), k


def test_decode_batched_empty_and_device():
    assert tbatching.decode_batched(None, [], None, device="cpu") == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tbatching.decode_batched(None, [], None)


# ------------------------------------------------------------- verify

def _yesno_like(mod):
    return mod(start=0, arc_start=np.array([0, 2, 3, 3], np.int32),
               ilabel=np.array([5, 0, 6], np.int32),
               olabel=np.array([1, 0, 2], np.int32),
               cost=np.array([0.5, 0.1, 0.2], np.float32),
               nextstate=np.array([1, 2, 2], np.int32),
               pdf=np.array([3, -1, 4], np.int32),
               final=np.array([np.inf, np.inf, 0.0], np.float32))


PACKED_CASES = [
    (dict(nextstate=np.array([1, 5, 2], np.int32)), None, "nextstate"),
    (dict(pdf=np.array([3, -1, 9], np.int32)), 5, "num_pdfs"),
    (dict(ilabel=np.array([0, 5, 6], np.int32),
          pdf=np.array([-1, 3, 4], np.int32)), None, "emitting-first"),
    (dict(pdf=np.array([3, 2, 4], np.int32)), None, "eps arc with pdf"),
    (dict(pdf=np.array([-1, -1, 4], np.int32)), None, "pdf < 0"),
    (dict(final=np.full(3, np.inf, np.float32)), None, "final"),
    (dict(arc_start=np.array([0, 2, 1, 3], np.int32)), None, "monoton"),
    (dict(start=7), None, "start state"),
]


@pytest.mark.parametrize("case", range(len(PACKED_CASES)))
def test_check_packed_graph_cases_equal_jax(case):
    change, num_pdfs, what = PACKED_CASES[case]
    for mod, check in ((PackedGraph, tverify.check_packed_graph),
                       (JPackedGraph, jverify.check_packed_graph)):
        g = _yesno_like(mod)
        check(g, num_pdfs=5)
        with pytest.raises(ValueError, match=what):
            check(dataclasses.replace(g, **change), num_pdfs=num_pdfs)


def test_check_packed_graph_on_big_graphs(graphs):
    tg, jg = graphs
    tverify.check_packed_graph(tg, num_pdfs=64)
    jverify.check_packed_graph(jg, num_pdfs=64)
    with pytest.raises(ValueError, match="num_pdfs"):
        tverify.check_packed_graph(tg, num_pdfs=10)


def _tables(graphs, triple, hub):
    tg, jg = graphs
    kw = dict(max_active=64, expand_budget=256, hub_threshold=hub,
              force_b_triple=triple)
    t = CsrBeamDecoder(tg, CsrBeamOpts(**kw), device="cpu")
    j = JCsr(jg, JCsrOpts(**kw))
    return t, j


@pytest.mark.parametrize("triple", [False, True])
@pytest.mark.parametrize("hub", [64, 4096])
def test_check_tier_tables_equal_jax(graphs, triple, hub):
    t, j = _tables(graphs, triple, hub)
    assert t.tabs.b_apr == j.tabs.b_apr == (3 if triple else 4)
    assert (len(t.tabs.hub_bounds) > 1) == (hub == 64)
    tverify.check_tier_tables(t.graph, t.tabs, hub)
    jverify.check_tier_tables(j.graph, j.tabs, hub)
    for field, row, col, change, what in cs.tier_table_corruptions(t.tabs):
        bad_t = cs.corrupt_tables(t.tabs, field, row, col, change)
        bad_j = cs.corrupt_tables(j.tabs, field, row, col, change,
                                  wrap=jnp.asarray)
        with pytest.raises(ValueError, match=what) as et:
            tverify.check_tier_tables(t.graph, bad_t, hub)
        with pytest.raises(ValueError, match=what) as ej:
            jverify.check_tier_tables(j.graph, bad_j, hub)
        assert str(et.value) == str(ej.value), (field, col)


def test_check_tier_tables_hub_bounds_equal_jax(graphs):
    t, j = _tables(graphs, False, 64)
    for hb in (tuple(reversed(t.tabs.hub_bounds)),
               t.tabs.hub_bounds[:-1] + (t.tabs.hub_bounds[-1] + 1,),
               t.tabs.hub_bounds[:-1]):
        with pytest.raises(ValueError) as et:
            tverify.check_tier_tables(
                t.graph, dataclasses.replace(t.tabs, hub_bounds=hb), 64)
        with pytest.raises(ValueError) as ej:
            jverify.check_tier_tables(
                j.graph, dataclasses.replace(j.tabs, hub_bounds=hb), 64)
        assert str(et.value) == str(ej.value)


# ------------------------------------------------------------- simple

TINY = cs.TOOLS_TINY


@pytest.mark.parametrize("seed", [0, 1])
def test_simple_decode_equals_jax_and_csr(seed):
    tg = make_big_hclg(BigGraphConfig(**TINY))[0]
    jg = jmake_big_hclg(JBigGraphConfig(**TINY))[0]
    ll = (np.random.RandomState(seed).randn(24, 16) * 3).astype(np.float32)
    got = tsimple.simple_decode(tg, ll)
    want = jsimple.simple_decode(jg, ll)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == pytest.approx(want[2], abs=1e-9)
    wide = CsrBeamOpts(beam=1e9, max_active=tg.num_states,
                       acoustic_scale=0.1, expand_budget=1 << 16,
                       eps_budget=1 << 14, hub_threshold=1 << 20)
    csr = CsrBeamDecoder(tg, wide, device="cpu").decode(
        ll[None], np.array([24]))[0]
    assert list(csr[0]) == got[0]
    assert csr[2] == pytest.approx(got[2], abs=1e-4)


def test_chip_smoke_tool_checks_on_the_cpu():
    """chip_smoke.py phase 33's helpers with the CPU on both sides."""
    assert cs.verify_card_vs_cpu(card="cpu")["corruptions"] == 13
    b = cs.batched_card_vs_cpu(card="cpu")
    assert b["batches"] == [(2, 64), (1, 64), (2, 90), (2, 126)]
    for seed in (0, 1):
        assert cs.simple_vs_csr("cpu", seed)["cost_gap"] <= 1e-4
