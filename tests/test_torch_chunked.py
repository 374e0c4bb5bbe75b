"""Port parity: kaldi_tpu_torch's ChunkedCsrBeamDecoder and
AdaptiveCsrBeamDecoder against kaldi_tpu's, on the CPU.

The contracts of tests/test_csr_beam.py (`test_chunked_decoder_equals_one_
shot`, `test_adaptive_decoder_matches_full`,
`test_adaptive_mid_utterance_escalation`): chunked decoding equals the
port's one-shot decode and JAX's chunked decoder for chunk sizes 7, 16
and 50 (one that does not divide T among them): words, tids,
last_saturated and last_overflow identical, cost within 1e-3. The
adaptive decoder equals the full-capacity decoder, and last_escalated,
last_small_chunks (so where the early abort fires) equal JAX's.
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu.decoder.csr_beam import (
    AdaptiveCsrBeamDecoder as JAdaptive, ChunkedCsrBeamDecoder as JChunked,
    CsrBeamOpts as JOpts)
from kaldi_tpu_torch.decoder.csr_beam import (AdaptiveCsrBeamDecoder,
                                              ChunkedCsrBeamDecoder,
                                              CsrBeamDecoder, CsrBeamOpts)

torch.set_num_threads(2)

CHUNK_OPTS = dict(beam=9.0, max_active=128, acoustic_scale=0.1,
                  expand_budget=4096, eps_budget=1024, hub_threshold=64)
FULL_OPTS = dict(beam=8.0, max_active=512, acoustic_scale=0.1,
                 expand_budget=16384, eps_budget=2048)


@pytest.fixture(scope="module")
def small_big_graph():
    g, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                        num_pdfs=64, seed=1))
    return g


def _same(got, want, what, tol=1e-3):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (what, b)
        if w is None:
            continue
        assert list(g[0]) == list(w[0]), (what, b, "words")
        assert list(g[1]) == list(w[1]), (what, b, "tids")
        assert g[2] == pytest.approx(w[2], abs=tol), (what, b)


@pytest.fixture(scope="module")
def chunk_case(small_big_graph):
    ll = (np.random.RandomState(5).randn(3, 50, 64) * 3).astype(np.float32)
    nf = np.array([50, 41, 23], np.int32)
    ref = CsrBeamDecoder(small_big_graph, CsrBeamOpts(**CHUNK_OPTS),
                         device="cpu")
    return ll, nf, ref, ref.decode(ll, nf)


COUNTERS = ("last_saturated", "last_overflow", "last_active_sum",
            "last_active_max")


@pytest.mark.parametrize("tc", [7, 16, 50])
def test_chunked_equals_one_shot_and_jax(small_big_graph, chunk_case, tc):
    ll, nf, ref, r_ref = chunk_case
    jch = JChunked(small_big_graph, JOpts(**CHUNK_OPTS), chunk_frames=tc)
    ch = ChunkedCsrBeamDecoder(small_big_graph, CsrBeamOpts(**CHUNK_OPTS),
                               chunk_frames=tc, device="cpu")
    r_j, r_ch = jch.decode(ll, nf), ch.decode(ll, nf)
    _same(r_ch, r_ref, f"chunked {tc} vs one-shot")
    _same(r_ch, r_j, f"chunked {tc} vs JAX chunked")
    for attr in COUNTERS:
        np.testing.assert_array_equal(getattr(ch, attr), getattr(ref, attr),
                                      err_msg=attr)
        np.testing.assert_array_equal(getattr(ch, attr), getattr(jch, attr),
                                      err_msg=attr)
    assert ch.chunks_run == jch.chunks_run == -(-50 // tc)
    assert not ch.aborted


def test_stop_when_aborts_at_jax_chunk(small_big_graph, chunk_case):
    """The host reads chunk c-1's flags after enqueueing chunk c: a
    stop_when that fires on the first saturation stops both packages
    after the same number of chunks."""
    ll, nf, _ref, _r = chunk_case
    seen = {}

    def stop(tag):
        def fn(sat, ovf):
            seen.setdefault(tag, []).append((sat.copy(), ovf.copy()))
            return bool(sat.any())
        return fn

    jch = JChunked(small_big_graph, JOpts(**CHUNK_OPTS), chunk_frames=7)
    ch = ChunkedCsrBeamDecoder(small_big_graph, CsrBeamOpts(**CHUNK_OPTS),
                               chunk_frames=7, device="cpu")
    jch.decode_async(ll, nf, stop_when=stop("jax"))()
    ch.decode_async(ll, nf, stop_when=stop("port"))()
    assert ch.aborted and jch.aborted
    assert ch.chunks_run == jch.chunks_run < -(-50 // 7)
    assert len(seen["port"]) == len(seen["jax"])
    for (s1, o1), (s2, o2) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(o1, o2)


def _flat(rng, B, T, P):
    return (rng.randn(B, T, P) * 3).astype(np.float32)


def _peaky(rng, B, T, P):
    peak = (rng.randn(B, T, P) * 0.1).astype(np.float32)
    peak[..., 0] += 40.0
    return peak


def _mid(rng, B, T, P):
    """Peaky first half (one dominant pdf per frame), flat noise after."""
    ll = np.zeros((B, T, P), np.float32)
    peak = rng.randint(0, P, (B, T // 2))
    ll[:, : T // 2, :] = -8.0
    for b in range(B):
        ll[b, np.arange(T // 2), peak[b]] = 8.0
    ll[:, T // 2:, :] = rng.randn(B, T - T // 2, P) * 3
    return ll


# scenario -> (loglikes, T, full opts, small_max_active, small budget,
#              chunk frames, escalation expected)
ADAPTIVE = {
    "flat": (_flat, 9, 40, FULL_OPTS, 64, 2048, 128, "some"),
    "peaky": (_peaky, 9, 40, dict(FULL_OPTS, beam=1.0), 128, 4096, 128,
              "none"),
    "mid_utterance": (_mid, 11, 60, dict(FULL_OPTS, beam=10.0), 64, 2048,
                      10, "all"),
}


@pytest.mark.parametrize("scenario", sorted(ADAPTIVE))
def test_adaptive_matches_full_and_jax(small_big_graph, scenario):
    make, seed, T, opts, small_k, small_cb, tc, expect = ADAPTIVE[scenario]
    B, P = 3, 64
    ll = make(np.random.RandomState(seed), B, T, P)
    nf = np.full(B, T, np.int32)
    jad = JAdaptive(small_big_graph, JOpts(**opts), small_max_active=small_k,
                    small_expand_budget=small_cb, chunk_frames=tc)
    ad = AdaptiveCsrBeamDecoder(small_big_graph, CsrBeamOpts(**opts),
                                small_max_active=small_k,
                                small_expand_budget=small_cb,
                                chunk_frames=tc, device="cpu")
    r_j, r_ad = jad.decode(ll, nf), ad.decode(ll, nf)
    r_full = ad.full.decode(ll, nf)
    _same(r_ad, r_full, f"{scenario}: adaptive vs full")
    _same(r_ad, r_j, f"{scenario}: adaptive vs JAX adaptive")
    np.testing.assert_array_equal(ad.last_escalated, jad.last_escalated)
    assert ad.last_small_chunks == jad.last_small_chunks
    esc = ad.last_escalated
    assert {"some": esc.any(), "none": not esc.any(),
            "all": esc.all()}[expect], esc
    if scenario == "mid_utterance":
        # the all-escalated abort stopped the small program early
        assert ad.last_small_chunks < 6
