"""Port parity: kaldi_tpu_torch's lattice path against kaldi_tpu's.

The same numpy log-likelihoods go through both packages on the CPU:

  - `CsrBeamDecoder.decode_raw` in six record configurations (defaults,
    rec_cap with rec_beam, rec_f16, rec_flat, a forced flat overflow that
    falls back to dense records, and unfolded eps arcs with init rounds)
    and on the star hub graph: states, counts, rec_trunc, best_slot,
    rec_wire_slots and the last_* counters identical; f32 scores within
    1e-4; scores rebuilt from float16 within 1e-2 (one f16 step at
    rec_beam <= 8);
  - `raw_lattice_from_decode`, native and numpy, against JAX's on the
    same records: the same node count and sorted (src, il, ol, dst) arc
    tuples, arc and final costs within 1e-4; and the lattices of the
    port's own records;
  - `write_lattice_text` byte-identical to JAX's.

Then the reference's lattice contracts (tests/test_csr_beam.py) restated
on the port: best path of the lattice == decoder best path, stream ==
sync, native == numpy, the hub tier, and the record-compaction contracts.
"""

import dataclasses as dc
import io
import os

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder as JDecoder,
                                        CsrBeamOpts as JOpts)
from kaldi_tpu.decoder.graph_pack import PackedGraph
from kaldi_tpu.lat.generate import raw_lattice_from_decode as j_raw_lattice
from kaldi_tpu.lat.io import write_lattice_text as j_write_text
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
from kaldi_tpu_torch.lat import native_gen
from kaldi_tpu_torch.lat.functions import lattice_best_path
from kaldi_tpu_torch.lat.generate import (decode_to_lattices,
                                          decode_to_lattices_stream,
                                          raw_lattice_from_decode)
from kaldi_tpu_torch.lat.io import (read_lattice_ark, write_lattice_ark,
                                    write_lattice_text)

torch.set_num_threads(2)

BASE = dict(beam=10.0, max_active=256, acoustic_scale=0.1,
            expand_budget=8192, eps_budget=2048)
REC = dict(rec_cap=128, rec_beam=6.0)
# name -> (graph, options); one loglike shape per graph
CONFIGS = {
    "defaults": ("small", {}),
    "rec_cap_beam": ("small", REC),
    "rec_f16": ("small", dict(REC, rec_f16=True)),
    # rec_flat_cap == rec_cap: the flat buffer cannot overflow
    "rec_flat": ("small", dict(REC, rec_f16=True, rec_flat=True,
                               rec_flat_cap=128)),
    # one flat slot per frame: overflow, and the dense re-decode
    "flat_overflow": ("small", dict(REC, rec_f16=True, rec_flat=True,
                                    rec_flat_cap=1)),
    "init_rounds": ("small", dict(REC, fold_eps=False)),
    "star_hub": ("star", dict(max_active=128, expand_budget=4096,
                              eps_budget=256, hub_threshold=32, rec_cap=96,
                              rec_beam=8.0, rec_f16=True)),
}
F16 = {n for n, (_g, kw) in CONFIGS.items() if kw.get("rec_f16")}


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


def _ll(seed, B, T, P):
    return (np.random.RandomState(seed).randn(B, T, P) * 3).astype(np.float32)


@pytest.fixture(scope="module")
def small_big_graph():
    g, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                        num_pdfs=64, seed=1))
    return g


@pytest.fixture(scope="module")
def inputs(small_big_graph):
    return {"small": (small_big_graph, _ll(11, 2, 25, 64),
                      np.array([25, 20], np.int32)),
            "star": (_star_hub_graph(300), _ll(6, 2, 20, 301),
                     np.array([20, 15], np.int32))}


@pytest.fixture(scope="module")
def runs(inputs):
    """name -> (jax decoder, jax records, port decoder, port records, nf);
    each JAX program is built once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            gname, kw = CONFIGS[name]
            g, ll, nf = inputs[gname]
            kw = dict(BASE, **kw)
            jd = JDecoder(g, JOpts(**kw))
            td = CsrBeamDecoder(g, CsrBeamOpts(**kw), device="cpu")
            cache[name] = (jd, jd.decode_raw(ll, nf), td,
                           td.decode_raw(ll, nf), nf)
        return cache[name]
    return get


COUNTERS = ("last_overflow", "last_saturated", "last_rec_trunc",
            "last_active_sum", "last_active_max", "last_flat_fallbacks")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_raw_matches_jax(runs, name):
    jd, rj, td, rt, _nf = runs(name)
    assert list(rt) == list(rj)
    for key in rj:
        want, got = np.asarray(rj[key]), np.asarray(rt[key])
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if want.dtype.kind != "f":
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        tol = 1e-2 if (name in F16 and key in ("scores", "init_scores")) \
            else 1e-4
        # dead slots hold the same sentinel on both sides
        np.testing.assert_array_equal(want >= 5e9, got >= 5e9, err_msg=key)
        live = want < 5e9
        assert np.abs(np.where(live, got - want, 0)).max(initial=0) <= tol, \
            key
    for attr in COUNTERS:
        np.testing.assert_array_equal(getattr(td, attr), getattr(jd, attr),
                                      err_msg=attr)
    assert td.opts.eps_expansions == jd.opts.eps_expansions
    if name == "flat_overflow":
        assert td.last_flat_fallbacks > 0
        # the fallback's records are the dense mode's
        _jd, _rj, _td, dense, _ = runs("rec_f16")
        assert "rec_wire_slots" not in rt
        for key in ("states", "scores", "init_states", "rec_trunc"):
            np.testing.assert_array_equal(rt[key], dense[key], err_msg=key)
    if name == "rec_flat":
        assert td.last_flat_fallbacks == 0 and rt["rec_wire_slots"] > 0
    if name == "init_rounds":
        assert rt["init_states"].shape[1] == 1


def _arrays(lat):
    """-> (n_states, int arc columns [A, 4] sorted, costs [A, 2] in that
    order, finals sorted)."""
    n, src, il, ol, gc, ac, dst = lat.to_arrays()
    ints = np.stack([np.asarray(a, np.int64) for a in (src, il, ol, dst)], 1)
    costs = np.stack([np.asarray(gc, np.float64),
                      np.asarray(ac, np.float64)], 1)
    order = np.lexsort((costs[:, 1], costs[:, 0], ints[:, 3], ints[:, 2],
                        ints[:, 1], ints[:, 0]))
    finals = sorted((int(s), float(g), float(a))
                    for s, (g, a) in lat.finals.items())
    return n, ints[order], costs[order], finals


def _same_lattice(got, want, what):
    assert (got is None) == (want is None), what
    if want is None:
        return
    gn, gi, gc, gf = _arrays(got)
    wn, wi, wc, wf = _arrays(want)
    assert gn == wn, f"{what}: {gn} nodes vs {wn}"
    np.testing.assert_array_equal(gi, wi, err_msg=what)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-4, err_msg=what)
    assert [f[0] for f in gf] == [f[0] for f in wf], what
    np.testing.assert_allclose([f[1:] for f in gf], [f[1:] for f in wf],
                               rtol=0, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lattices_match_jax(runs, name):
    jd, rj, td, rt, nf = runs(name)
    for b in range(len(nf)):
        for native in (True, False):
            want = j_raw_lattice(jd, rj, nf, b, 6.0, use_native=native)
            kind = "native" if native else "numpy"
            _same_lattice(raw_lattice_from_decode(td, rj, nf, b, 6.0,
                                                  use_native=native),
                          want, f"{kind} on JAX's records, utt {b}")
            _same_lattice(raw_lattice_from_decode(td, rt, nf, b, 6.0,
                                                  use_native=native),
                          want, f"{kind} on the port's records, utt {b}")
            assert want is not None


def test_native_extractor_counts_and_builds_outside_the_source():
    before = native_gen.extractions
    so = native_gen.library_path()
    assert "build" in so.split(os.sep)
    assert not so.startswith(os.path.dirname(native_gen.SRC))
    g, _ = make_big_hclg(BigGraphConfig(vocab=40, avg_bigram_succ=6,
                                        num_pdfs=16, seed=3))
    dec = CsrBeamDecoder(g, CsrBeamOpts(**dict(BASE, max_active=64)),
                         device="cpu")
    ll, nf = _ll(2, 2, 12, 16), np.array([12, 9], np.int32)
    lats = decode_to_lattices(dec, ll, nf, 6.0, num_threads=2)
    assert all(lat is not None for lat in lats)
    assert native_gen.extractions == before + 2


def test_write_lattice_text_matches_jax(runs, tmp_path):
    jd, rj, td, rt, nf = runs("defaults")
    for b in range(len(nf)):
        jl = j_raw_lattice(jd, rj, nf, b, 6.0, use_native=False)
        tl = raw_lattice_from_decode(td, rt, nf, b, 6.0, use_native=False)
        jf, tf = io.StringIO(), io.StringIO()
        j_write_text(jf, f"utt{b}", jl)
        write_lattice_text(tf, f"utt{b}", tl)
        assert tf.getvalue() == jf.getvalue()
        assert tf.getvalue().count("\n") > tl.num_states
    # the ark round trip keeps every path
    lats = {f"utt{b}": raw_lattice_from_decode(td, rt, nf, b, 6.0)
            for b in range(len(nf))}
    path = tmp_path / "lat.txt"
    write_lattice_ark(str(path), lats)
    back = dict(read_lattice_ark(str(path)))
    assert sorted(back) == sorted(lats)
    for key, lat in lats.items():
        want = lattice_best_path(lat)
        got = lattice_best_path(back[key])
        assert got[0] == want[0] and got[1] == want[1]
        assert abs(got[2] - want[2]) < 1e-3


# ---- the reference's lattice contracts (tests/test_csr_beam.py), on the port


def _paths(lat, ndigits=3, max_paths=200000):
    return {(w, t): round(c, ndigits)
            for (w, t, c) in lat.paths(max_paths=max_paths)}


def _decoder(graph, **kw):
    return CsrBeamDecoder(graph, CsrBeamOpts(**kw), device="cpu")


def test_csr_lattice_extraction(small_big_graph):
    """The lattice's best path equals the decoder's best path, and the
    lattice holds alternatives."""
    ll, nf = _ll(5, 2, 40, 64), np.array([40, 30], np.int32)
    dec = _decoder(small_big_graph, beam=1e9, max_active=256,
                   acoustic_scale=0.1, expand_budget=16384, eps_budget=4096)
    best = dec.decode(ll, nf)
    lats = decode_to_lattices(dec, ll, nf, lattice_beam=8.0)
    for b in range(2):
        words, tids, cost = lattice_best_path(lats[b])
        assert words == best[b][0] and tids == best[b][1]
        assert abs(cost - best[b][2]) < 1e-2
        assert lats[b].num_arcs > lats[b].num_states - 1


def test_decode_to_lattices_stream_matches_sync(small_big_graph):
    rng = np.random.RandomState(7)
    B, T, P = 2, 30, 64
    dec = _decoder(small_big_graph, beam=1e9, max_active=128,
                   acoustic_scale=0.1, expand_budget=8192, eps_budget=4096)
    batches = [((rng.randn(B, T, P) * 3).astype(np.float32),
                np.array([T, T - 5 * i], np.int32)) for i in range(3)]
    want = [decode_to_lattices(dec, ll, nf, lattice_beam=8.0, num_threads=1)
            for ll, nf in batches]
    got = list(decode_to_lattices_stream(dec, batches, lattice_beam=8.0,
                                         num_threads=2))
    assert len(got) == len(want)
    for wlats, glats in zip(want, got):
        for w, g in zip(wlats, glats):
            _same_lattice(g, w, "stream vs sync")


def test_native_lattice_extraction_matches_python(small_big_graph):
    ll, nf = _ll(8, 2, 30, 64), np.array([30, 22], np.int32)
    dec = _decoder(small_big_graph, beam=1e9, max_active=128,
                   acoustic_scale=0.1, expand_budget=8192, eps_budget=2048)
    raw = dec.decode_raw(ll, nf)
    for b in range(2):
        lat_py = raw_lattice_from_decode(dec, raw, nf, b, 6.0,
                                         use_native=False)
        lat_cc = raw_lattice_from_decode(dec, raw, nf, b, 6.0,
                                         use_native=True)
        assert _paths(lat_py) == _paths(lat_cc)
        bp_py, bp_cc = lattice_best_path(lat_py), lattice_best_path(lat_cc)
        assert bp_py[:2] == bp_cc[:2] and abs(bp_py[2] - bp_cc[2]) < 1e-3


def test_hub_tier_lattice_extraction():
    g, _ = make_big_hclg(BigGraphConfig(vocab=200, avg_bigram_succ=12,
                                        num_pdfs=64, seed=3))
    ll, nf = _ll(4, 2, 40, 64), np.array([40, 30], np.int32)
    dec = _decoder(g, beam=1e9, max_active=192, acoustic_scale=0.1,
                   expand_budget=8192, eps_budget=4096, hub_threshold=32)
    assert len(dec.tabs.hub_bounds) > 1
    best = dec.decode(ll, nf)
    lats = decode_to_lattices(dec, ll, nf, lattice_beam=8.0)
    for b in range(2):
        words, tids, cost = lattice_best_path(lats[b])
        assert words == best[b][0] and tids == best[b][1]
        assert abs(cost - best[b][2]) < 1e-2


def test_record_compaction_preserves_lattices(small_big_graph):
    g = small_big_graph
    ll, nf = _ll(11, 2, 30, 64), np.array([30, 24], np.int32)
    base = CsrBeamOpts(beam=10.0, max_active=256, acoustic_scale=0.1,
                       expand_budget=8192, eps_budget=2048)
    dec = CsrBeamDecoder(g, base, device="cpu")
    raw_full = dec.decode_raw(ll, nf)
    assert (dec.last_rec_trunc == 0).all()
    occupancy_max = int(dec.last_active_max.max())
    dec_c = CsrBeamDecoder(g, dc.replace(base, rec_cap=occupancy_max),
                           device="cpu")
    raw_c = dec_c.decode_raw(ll, nf)
    assert (dec_c.last_rec_trunc == 0).all()
    assert raw_c["states"].shape[-1] == occupancy_max
    for native in (False, True):
        for b in range(2):
            lat_f = raw_lattice_from_decode(dec, raw_full, nf, b, 6.0,
                                            use_native=native)
            lat_c = raw_lattice_from_decode(dec_c, raw_c, nf, b, 6.0,
                                            use_native=native)
            assert _paths(lat_f) == _paths(lat_c)
    dec_t = CsrBeamDecoder(g, dc.replace(base, rec_cap=8), device="cpu")
    dec_t.decode_raw(ll, nf)
    assert dec_t.last_rec_trunc.sum() > 0


def test_record_compaction_rec_beam(small_big_graph):
    ll, nf = _ll(12, 2, 25, 64), np.full(2, 25, np.int32)
    dec = _decoder(small_big_graph, beam=12.0, max_active=256,
                   acoustic_scale=0.1, expand_budget=8192, eps_budget=2048,
                   rec_beam=6.0, rec_cap=128)
    best = dec.decode(ll, nf)
    raw = dec.decode_raw(ll, nf)
    for b in range(2):
        words, _tids, cost = lattice_best_path(
            raw_lattice_from_decode(dec, raw, nf, b, 6.0))
        assert words == best[b][0] and abs(cost - best[b][2]) < 1e-2


def test_record_compaction_f16_matches_f32(small_big_graph):
    ll, nf = _ll(13, 2, 25, 64), np.array([25, 20], np.int32)
    base = CsrBeamOpts(beam=10.0, max_active=256, acoustic_scale=0.1,
                       expand_budget=8192, eps_budget=2048, rec_cap=128,
                       rec_beam=8.0)
    d32 = CsrBeamDecoder(small_big_graph, base, device="cpu")
    d16 = CsrBeamDecoder(small_big_graph, dc.replace(base, rec_f16=True),
                         device="cpu")
    r32, r16 = d32.decode_raw(ll, nf), d16.decode_raw(ll, nf)
    assert r16["scores"].dtype == np.float32
    alive = r32["scores"] < 5e9
    assert (alive == (r16["scores"] < 5e9)).all()
    assert np.abs(np.where(alive, r32["scores"] - r16["scores"], 0)
                  ).max() < 0.02
    for b in range(2):
        w32, t32, c32 = lattice_best_path(
            raw_lattice_from_decode(d32, r32, nf, b, 6.0))
        w16, t16, c16 = lattice_best_path(
            raw_lattice_from_decode(d16, r16, nf, b, 6.0))
        assert w32 == w16 and t32 == t16 and abs(c32 - c16) < 0.05


@pytest.mark.parametrize("fold_eps", [True, False])
def test_record_flat_matches_dense(small_big_graph, fold_eps):
    """The rebuilt dense view of flat records carries the dense-mode
    records, and the lattices have the same paths. With unfolded eps arcs
    the init snapshots (rec_cap wide) sit beside narrower flat frames,
    which the port's extractors pad (the reference's assert them equal)."""
    ll, nf = _ll(14, 3, 30, 64), np.array([30, 22, 27], np.int32)
    base = CsrBeamOpts(beam=10.0, max_active=256, acoustic_scale=0.1,
                       expand_budget=8192, eps_budget=2048, rec_cap=128,
                       rec_beam=6.0, rec_f16=True, fold_eps=fold_eps)
    dd = CsrBeamDecoder(small_big_graph, base, device="cpu")
    df = CsrBeamDecoder(small_big_graph,
                        dc.replace(base, rec_flat=True, rec_flat_cap=128),
                        device="cpu")
    rd, rf = dd.decode_raw(ll, nf), df.decode_raw(ll, nf)
    assert df.last_flat_fallbacks == 0 and rf["rec_wire_slots"] > 0
    assert (rf["init_states"].shape[1] == 0) == fold_eps
    Keff = rf["states"].shape[-1]
    valid = (np.arange(rd["states"].shape[1])[None, :, None, None]
             < nf[:, None, None, None])
    alive_d = (rd["scores"][..., :Keff] < 5e9) & valid
    alive_f = (rf["scores"] < 5e9) & valid
    assert (alive_d == alive_f).all()
    assert not ((rd["scores"][..., Keff:] < 5e9) & valid).any()
    np.testing.assert_array_equal(np.where(alive_d, rd["states"][..., :Keff],
                                           -1),
                                  np.where(alive_f, rf["states"], -1))
    np.testing.assert_allclose(np.where(alive_d, rd["scores"][..., :Keff], 0),
                               np.where(alive_f, rf["scores"], 0), atol=1e-3)
    for native in (False, True):
        for b in range(3):
            ld = raw_lattice_from_decode(dd, rd, nf, b, 6.0,
                                         use_native=native)
            lf = raw_lattice_from_decode(df, rf, nf, b, 6.0,
                                         use_native=native)
            assert _paths(ld, 2) == _paths(lf, 2)


def test_record_flat_overflow_fallback(small_big_graph):
    ll, nf = _ll(15, 2, 25, 64), np.full(2, 25, np.int32)
    base = CsrBeamOpts(beam=10.0, max_active=256, acoustic_scale=0.1,
                       expand_budget=8192, eps_budget=2048, rec_cap=128,
                       rec_beam=6.0)
    dd = CsrBeamDecoder(small_big_graph, base, device="cpu")
    df = CsrBeamDecoder(small_big_graph,
                        dc.replace(base, rec_flat=True, rec_flat_cap=1),
                        device="cpu")
    rd, rf = dd.decode_raw(ll, nf), df.decode_raw(ll, nf)
    assert df.last_flat_fallbacks > 0
    for b in range(2):
        assert _paths(raw_lattice_from_decode(dd, rd, nf, b, 6.0), 2,
                      100000) == \
            _paths(raw_lattice_from_decode(df, rf, nf, b, 6.0), 2, 100000)


def test_rec_beam_can_break_a_lattice_as_in_jax(runs):
    """rec_beam drops the slots more than rec_beam behind the frame best,
    yet the best complete path can pass through such a slot. With
    loglikes of a wide spread (a confident AM), no path survives the
    records of an utterance and its lattice is None; JAX's records and
    extractors give the same None, and with nothing masked (rec_beam =
    beam) every utterance has its lattice."""
    ll = (np.random.RandomState(0).randn(2, 25, 64) * 30).astype(np.float32)
    nf = np.array([25, 20], np.int32)
    for name, broken in (("rec_cap_beam", True), ("defaults", False)):
        jd, _rj, td, _rt, _nf = runs(name)
        rj, rt = jd.decode_raw(ll, nf), td.decode_raw(ll, nf)
        np.testing.assert_array_equal(rt["states"], rj["states"])
        nones = []
        for b in range(2):
            for native in (True, False):
                want = j_raw_lattice(jd, rj, nf, b, 6.0, use_native=native)
                got = raw_lattice_from_decode(td, rt, nf, b, 6.0,
                                              use_native=native)
                _same_lattice(got, want, f"{name}, utt {b}, native={native}")
            nones.append(got is None)
        assert any(nones) == broken, (name, nones)
