"""Port parity: kaldi_tpu_torch's CsrBeamDecoder against kaldi_tpu's.

The same numpy log-likelihoods go through both decoders on the CPU. The
contract is PARITY.md's for the CSR decoder: identical words, tids,
overflow, saturation and occupancy counters, cost within 1e-2. The graphs
and options are those of tests/test_csr_beam.py (hub tiers, quad vs
triple rows, the start-state eps bridge, a starved budget, hub_cap) plus
a tie case where every acoustic cost is equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder as JDecoder,
                                        CsrBeamOpts as JOpts,
                                        _dedup_topk as j_dedup,
                                        _segment_map as j_segmap)
from kaldi_tpu.decoder.graph_pack import PackedGraph
from kaldi_tpu_torch.decoder.csr_beam import (BIG, CsrBeamDecoder, CsrBeamOpts,
                                              _dedup_topk, _segment_map)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small_big_graph():
    g, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                        num_pdfs=64, seed=1))
    return g


def _star_hub_graph(n_words=300):
    """test_csr_beam.py's star graph: a hub with > 128 distinct pdfs."""
    deg = np.r_[n_words, np.ones(n_words, np.int64)]
    arc_start = np.r_[0, np.cumsum(deg)].astype(np.int32)
    n_arcs = int(arc_start[-1])
    il = np.ones(n_arcs, np.int32)
    ol = np.zeros(n_arcs, np.int32)
    cost = np.zeros(n_arcs, np.float32)
    nxt = np.zeros(n_arcs, np.int32)
    pdf = np.zeros(n_arcs, np.int32)
    rng = np.random.RandomState(0)
    nxt[:n_words] = np.arange(1, n_words + 1)
    pdf[:n_words] = np.arange(n_words)
    ol[:n_words] = np.arange(1, n_words + 1)
    cost[:n_words] = rng.rand(n_words).astype(np.float32)
    il[:n_words] = np.arange(1, n_words + 1)
    nxt[n_words:] = 0
    pdf[n_words:] = n_words
    il[n_words:] = n_words + 1
    cost[n_words:] = 0.25
    final = np.full(n_words + 1, np.inf, np.float32)
    final[0] = 0.0
    return PackedGraph(start=0, arc_start=arc_start, ilabel=il, olabel=ol,
                       cost=cost, nextstate=nxt, pdf=pdf, final=final)


def _bridge_graph():
    """test_csr_beam.py's start-state eps bridge graph."""
    arcs = [
        (0, 0, 0, 0.3, 1, -1), (0, 0, 0, 0.1, 2, -1), (0, 3, 0, 0.5, 3, 2),
        (1, 1, 0, 0.2, 3, 0), (1, 2, 7, 0.4, 4, 1), (2, 0, 5, 0.2, 1, -1),
        (2, 2, 0, 0.3, 4, 1), (3, 1, 8, 0.1, 4, 0), (3, 3, 0, 0.6, 1, 2),
        (4, 2, 0, 0.2, 3, 1),
    ]
    src = np.array([a[0] for a in arcs])
    return PackedGraph(
        arc_start=np.searchsorted(src, np.arange(6)).astype(np.int32),
        ilabel=np.array([a[1] for a in arcs], np.int32),
        olabel=np.array([a[2] for a in arcs], np.int32),
        cost=np.array([a[3] for a in arcs], np.float32),
        nextstate=np.array([a[4] for a in arcs], np.int32),
        final=np.array([np.inf, np.inf, np.inf, 0.5, 0.0], np.float32),
        start=0, pdf=np.array([a[5] for a in arcs], np.int32))


def _check(graph, ll, nf, **kw):
    jd = JDecoder(graph, JOpts(**kw))
    td = CsrBeamDecoder(graph, CsrBeamOpts(**kw))
    assert td.opts.eps_expansions == jd.opts.eps_expansions
    rj, rt = jd.decode(ll, nf), td.decode(ll, nf)
    for b in range(len(nf)):
        assert (rj[b] is None) == (rt[b] is None), b
        if rj[b] is None:
            continue
        assert list(rt[b][0]) == list(rj[b][0]), b
        assert list(rt[b][1]) == list(rj[b][1]), b
        assert abs(rt[b][2] - rj[b][2]) < 1e-2, b
    for attr in ("last_overflow", "last_saturated", "last_active_sum",
                 "last_active_max"):
        np.testing.assert_array_equal(getattr(td, attr), getattr(jd, attr),
                                      err_msg=attr)
    return td, rt


def _ll(seed, B, T, P, scale=3.0):
    return (np.random.RandomState(seed).randn(B, T, P) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("fold_eps", [True, False])
def test_small_big_graph(small_big_graph, fold_eps):
    td, _ = _check(small_big_graph, _ll(3, 3, 40, 64),
                   np.array([40, 31, 17], np.int32), beam=9.0,
                   max_active=256, acoustic_scale=0.1, expand_budget=4096,
                   eps_budget=1024, fold_eps=fold_eps)
    assert td.opts.eps_expansions == (0 if fold_eps else 1)


def test_hub_tier_onehot():
    g, _ = make_big_hclg(BigGraphConfig(vocab=200, avg_bigram_succ=12,
                                        num_pdfs=64, seed=3))
    td, _ = _check(g, _ll(2, 3, 40, 64), np.array([40, 30, 25], np.int32),
                   beam=1e9, max_active=192, acoustic_scale=0.1,
                   expand_budget=8192, eps_budget=4096, hub_threshold=32)
    assert len(td.tabs.hub_bounds) > 1 and td.tabs.hub_onehot is not None


def test_hub_tier_gather_fallback():
    td, _ = _check(_star_hub_graph(300), _ll(6, 2, 20, 301),
                   np.array([20, 15], np.int32), beam=1e9, max_active=128,
                   acoustic_scale=0.1, expand_budget=4096, eps_budget=256,
                   hub_threshold=32)
    assert len(td.tabs.hub_bounds) > 1 and td.tabs.hub_onehot is None


@pytest.mark.parametrize("force_b_triple", [False, True])
def test_quad_and_triple_rows(small_big_graph, force_b_triple):
    td, _ = _check(small_big_graph, _ll(3, 3, 50, 64),
                   np.array([50, 37, 21], np.int32), beam=9.0,
                   max_active=256, acoustic_scale=0.1, expand_budget=4096,
                   eps_budget=1024, hub_threshold=64,
                   force_b_triple=force_b_triple)
    assert td.tabs.b_apr == (3 if force_b_triple else 4)


@pytest.mark.parametrize("fold_eps", [True, False])
def test_start_state_bridge(fold_eps):
    td, rt = _check(_bridge_graph(), _ll(7, 3, 12, 3, scale=2.0),
                    np.array([12, 9, 5], np.int32), beam=1e9, max_active=64,
                    acoustic_scale=1.0, expand_budget=256, eps_budget=64,
                    hub_threshold=64, fold_eps=fold_eps)
    assert all(r is not None for r in rt)
    assert (td.opts.eps_expansions == 0) == fold_eps


def test_starved_budget_overflow_counted(small_big_graph):
    td, _ = _check(small_big_graph, _ll(1, 1, 30, 64),
                   np.full(1, 30, np.int32), beam=1e9, max_active=256,
                   acoustic_scale=0.1, expand_budget=256, eps_budget=256)
    assert td.last_overflow[0] > 0


@pytest.mark.parametrize("hub_cap", [128, 1])
def test_hub_cap(small_big_graph, hub_cap):
    _check(small_big_graph, _ll(16, 2, 25, 64), np.full(2, 25, np.int32),
           beam=10.0, max_active=256, acoustic_scale=0.1,
           expand_budget=8192, eps_budget=2048, hub_threshold=64,
           hub_cap=hub_cap)


def test_all_costs_tied(small_big_graph):
    """Every acoustic cost equal (what a zero final layer gives): every
    order and tie-break of the search decides the result."""
    td, _ = _check(small_big_graph, np.zeros((2, 30, 64), np.float32),
                   np.array([30, 22], np.int32), beam=13.0, max_active=128,
                   acoustic_scale=0.1, expand_budget=2048, eps_budget=512,
                   hub_threshold=64)
    assert td.last_saturated.all()


def test_lattice_options_rejected(small_big_graph):
    with pytest.raises(ValueError, match="rec_"):
        CsrBeamDecoder(small_big_graph, CsrBeamOpts(rec_cap=16))


def test_segment_map_matches_jax():
    rng = np.random.default_rng(0)
    B, K, C = 3, 40, 64
    deg = rng.integers(0, 5, (B, K)).astype(np.int32)
    deg[:, ::7] = 0
    off = (np.cumsum(deg, axis=1) - deg).astype(np.int32)
    base = rng.integers(0, 1000, (B, K)).astype(np.int32)
    for b_ in (base, None):
        want = j_segmap(jnp.asarray(off), jnp.asarray(deg), C, K, B,
                        base=None if b_ is None else jnp.asarray(b_))
        got = _segment_map(torch.from_numpy(off), torch.from_numpy(deg), C,
                           K, B,
                           base=None if b_ is None else torch.from_numpy(b_))
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    assert (got[3].numpy() > 0).any()          # the budget binds somewhere


@pytest.mark.parametrize("state_sort", [False, True])
def test_dedup_topk_matches_jax_with_ties(state_sort):
    rng = np.random.default_rng(1)
    B, C, K = 3, 200, 48
    st = rng.integers(0, 30, (B, C)).astype(np.int32)
    sc = np.round(rng.uniform(0, 4, (B, C)), 0).astype(np.float32)
    sc[:, ::5] = BIG                          # dead candidates
    sc[0, :3] = -0.0                          # signed zeros tie with 0.0
    rec = np.arange(B * C, dtype=np.int32).reshape(B, C)
    il = rng.integers(0, 9, (B, C)).astype(np.int32)
    want = j_dedup(*(jnp.asarray(a) for a in (st, sc, rec, il)), K,
                   state_sort=state_sort)
    got = _dedup_topk(*(torch.from_numpy(a) for a in (st, sc, rec, il)), K,
                      state_sort=state_sort)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
