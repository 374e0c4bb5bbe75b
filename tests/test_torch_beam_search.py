"""Port parity: kaldi_tpu_torch's padded BeamSearchDecoder against
kaldi_tpu's, on the CPU, on the same graphs and seeded log-likelihoods.

Words and tids are exact and the cost within 1e-2; `decode_raw`'s record
arrays (every round's states and scores, dead slots included) are equal
array for array, since the lattice extractors read the dead slots too.
A star graph with integer costs and log-likelihoods forces score ties in
the dedup and in the top-K cut, and a small beam leaves dead slots, so
the tie-break order is what the comparison checks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.decoder import beam_search as jbs
from kaldi_tpu.decoder.biggraph import (BigGraphConfig as JBigGraphConfig,
                                        make_big_hclg as j_make_big_hclg)
from kaldi_tpu.decoder.graph_pack import PackedGraph as JPackedGraph
from kaldi_tpu_torch.decoder import beam_search as tbs
from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.graph_pack import PackedGraph

torch.set_num_threads(2)


def tie_graph(n_words=8, pdfs=2):
    """State 0 fans out n_words word arcs of cost 0 over `pdfs` pdfs; each
    word state has an emitting arc (cost 1) and an eps arc with a word
    label (cost 0.5) back to 0. The start state n_words + 1 reaches 0 by
    eps arcs directly (olabel 200) and through word state 1, so the start
    closure takes two rounds. Integer-valued costs and log-likelihoods
    make many candidates tie exactly."""
    S0 = n_words + 1
    arcs = []       # (src, il, ol, cost, nxt, pdf)
    for i in range(1, n_words + 1):
        arcs.append((0, i, i, 0.0, i, i % pdfs))
    for i in range(1, n_words + 1):
        arcs.append((i, n_words + 1, 0, 1.0, 0, (i + 1) % pdfs))
        arcs.append((i, 0, 100 + i, 0.5, 0, 0))
    arcs += [(S0, 0, 200, 0.0, 0, 0), (S0, 0, 0, 0.0, 1, 0)]
    arcs.sort(key=lambda a: (a[0], a[1] == 0))      # emitting first
    src = np.array([a[0] for a in arcs])
    arc_start = np.searchsorted(src, np.arange(S0 + 2)).astype(np.int32)
    cols = [np.array([a[k] for a in arcs]) for k in range(1, 6)]
    final = np.full(S0 + 1, np.inf, np.float32)
    final[0] = 0.0
    final[3] = 2.0
    kw = dict(start=S0, arc_start=arc_start,
              ilabel=cols[0].astype(np.int32), olabel=cols[1].astype(np.int32),
              cost=cols[2].astype(np.float32),
              nextstate=cols[3].astype(np.int32), pdf=cols[4].astype(np.int32),
              final=final)
    return PackedGraph(**kw), JPackedGraph(**kw)


def _big():
    g, _ = make_big_hclg(BigGraphConfig(vocab=40, avg_bigram_succ=6,
                                        num_pdfs=16, seed=3))
    jg, _ = j_make_big_hclg(JBigGraphConfig(vocab=40, avg_bigram_succ=6,
                                            num_pdfs=16, seed=3))
    return g, jg


CASES = {
    "big": dict(graph=_big, P=16, opts=dict(beam=11.0, max_active=64),
                ll=lambda rng, B, T, P: rng.standard_normal((B, T, P)) * 3),
    "big_narrow": dict(graph=_big, P=16, opts=dict(beam=4.0, max_active=8),
                       ll=lambda rng, B, T, P:
                       rng.standard_normal((B, T, P)) * 3),
    "ties": dict(graph=tie_graph, P=2, opts=dict(beam=2.5, max_active=4,
                                                 acoustic_scale=1.0),
                 ll=lambda rng, B, T, P: rng.integers(-2, 1, (B, T, P))),
    "ties_wide": dict(graph=tie_graph, P=2, opts=dict(beam=30.0,
                                                      max_active=16,
                                                      acoustic_scale=0.5),
                      ll=lambda rng, B, T, P: rng.integers(-1, 1, (B, T, P))),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    c = CASES[request.param]
    g, jg = c["graph"]()
    t = tbs.BeamSearchDecoder(g, tbs.BeamSearchOpts(**c["opts"]),
                              device="cpu")
    j = jbs.BeamSearchDecoder(jg, jbs.BeamSearchOpts(**c["opts"]))
    rng = np.random.default_rng(len(request.param))
    ll = c["ll"](rng, 3, 23, c["P"]).astype(np.float32)
    return t, j, ll, np.array([23, 17, 9], np.int32), request.param


def test_decode_matches_jax(pair):
    t, j, ll, nf, _name = pair
    assert t.opts.eps_expansions == j.opts.eps_expansions
    got, want = t.decode(ll, nf), j.decode(ll, nf)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert g[0] == list(w[0]) and g[1] == list(w[1])
        assert g[2] == pytest.approx(w[2], abs=1e-2)
    # a tensor input decodes the same
    assert t.decode(torch.from_numpy(ll), nf) == got


def test_decode_raw_records_match_jax(pair):
    t, j, ll, nf, name = pair
    got, want = t.decode_raw(ll, nf), j.decode_raw(ll, nf)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    if name.startswith("ties"):
        # ties and dead slots are part of the records compared above
        assert (got["scores"] >= tbs.BIG / 2).any()
        sc = got["scores"][got["scores"] < tbs.BIG / 2]
        assert len(np.unique(sc)) < len(sc)


def test_dedup_prune_matches_jax():
    """Duplicated states, tied scores (signed zeros among them) and dead
    candidates: the K survivors and their payloads in JAX's order."""
    rng = np.random.default_rng(0)
    N, K = 200, 24
    for trial in range(6):
        st = rng.integers(0, 30, N).astype(np.int32)
        sc = rng.integers(-3, 4, N).astype(np.float32)
        sc[rng.random(N) < 0.1] = -0.0
        sc[rng.random(N) < 0.3] = tbs.BIG
        if trial % 2:
            sc[rng.random(N) < 0.2] = tbs.BIG * 2   # above BIG, clamped
        pv, ol, il = (rng.integers(0, 99, N).astype(np.int32)
                      for _ in range(3))
        got = tbs._dedup_prune(*(torch.from_numpy(a)[None]
                                 for a in (st, sc, pv, ol, il)), K)
        want = jbs._dedup_prune(*(jnp.asarray(a)
                                  for a in (st, sc, pv, ol, il)), K)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_pad_csr_equals_jax():
    g, jg = tie_graph()
    got, want = tbs._pad_csr(g), jbs._pad_csr(jg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_missing_pdfs_raise():
    g, _ = tie_graph()
    g.pdf = None
    with pytest.raises(ValueError, match="pdf"):
        tbs.BeamSearchDecoder(g, device="cpu")
