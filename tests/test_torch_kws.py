"""Port parity: kaldi_tpu_torch.kws against kaldi_tpu.kws, on the CPU.

The factor index, search, TWV scoring and proxy keywords (host code,
copied verbatim) on the port's yesno denominator lattices
(`build_system` of tests/test_torch_lat_posteriors.py): each index equals
JAX's (arrays exactly; its forward-backward's f64 alpha, beta and total
exactly), every keyword's hits equal JAX's, the TWV dict equals JAX's; an
index file pickled by either package ("kws_index_v1") loads in the other.
Then tests/test_kws.py's contracts on the port.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu import kws as jkws
from kaldi_tpu.kws import index as jindex
from kaldi_tpu_torch import kws as tkws
from kaldi_tpu_torch.kws import index as tindex
from kaldi_tpu_torch.lat.lattice import Lattice
from kaldi_tpu_torch.params import lattice_from_jax
from test_torch_lat_posteriors import build_system, lattice_to_jax

torch.set_num_threads(2)


def _same_index(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert sorted(da) == sorted(db)
    for k, v in da.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == db[k].dtype and np.array_equal(v, db[k]), k
        else:
            assert v == db[k], k


@pytest.fixture(scope="module")
def system():
    s = build_system(jax_decode=False)
    lats = [(u, lat) for lat, (u, _f, _w) in zip(s["tlats"], s["train"])
            if lat is not None]
    s["jidx"] = [jkws.lattice_to_kws_index(lattice_to_jax(lat), u)
                 for u, lat in lats]
    s["tidx"] = [tkws.lattice_to_kws_index(
        lattice_from_jax(lattice_to_jax(lat)), u) for u, lat in lats]
    return s


def test_index_equals_jax(system):
    for a, b in zip(system["tidx"], system["jidx"]):
        _same_index(a, b)


def test_search_and_twv_equal_jax(system):
    w = system["lang"].words
    Y, N = w["YES"], w["NO"]
    keywords = {"yes": [Y], "no": [N], "yes no": [Y, N], "no no": [N, N],
                "yes yes no": [Y, Y, N], "oov": [99]}
    hits_t, hits_j = {}, {}
    for kw, ids in keywords.items():
        hits_t[kw] = tkws.search_index(system["tidx"], ids)
        hits_j[kw] = jkws.search_index(system["jidx"], ids)
        assert hits_t[kw] == hits_j[kw], kw
    assert hits_t["yes"] and not hits_t["oov"]
    # references: each training utterance's words at their word-level
    # positions, 50 frames apart
    refs = {}
    for u, _f, ws in system["train"]:
        for k, word in enumerate(ws):
            refs.setdefault(word.lower(), []).append((u, 50 * k,
                                                      50 * k + 40))
    dur = float(sum(system["nf"])) / 100.0
    for opts in (tkws.TwvOptions(), tkws.TwvOptions(score_threshold=0.2)):
        jopts = jkws.TwvOptions(**dataclasses.asdict(opts))
        assert tkws.compute_twv(refs, hits_t, dur, opts) == \
            jkws.compute_twv(refs, hits_j, dur, jopts)
    assert tkws.align_hits(refs, hits_t, 30) == \
        jkws.align_hits(refs, hits_j, 30)


def test_single_word_posterior_is_its_forward_backward_sum(system):
    """A one-word keyword's unmerged hits sum to the word's expected count
    by the lattice's forward-backward (`kws_word_posterior_gap`, which
    phase 30 holds too), within 1e-9."""
    w = system["lang"].words
    lats = [lat for lat in system["tlats"] if lat is not None]
    for lat, ix in zip(lats, system["tidx"]):
        for word in (w["YES"], w["NO"]):
            assert cs.kws_word_posterior_gap(lat, ix, [word]) <= 1e-9


def test_index_files_cross_load(system, tmp_path):
    pt, pj = str(tmp_path / "t.pkl"), str(tmp_path / "j.pkl")
    tindex.save_kws_index(pt, system["tidx"])
    jindex.save_kws_index(pj, system["jidx"])
    for a, b in zip(jindex.load_kws_index(pt), system["tidx"]):
        _same_index(a, b)
    for a, b in zip(tindex.load_kws_index(pj), system["jidx"]):
        _same_index(a, b)
    u = tkws.union_kws_indexes([tindex.load_kws_index(pj),
                                system["tidx"][:2]])
    assert [ix.utt_id for ix in u] == sorted(ix.utt_id
                                             for ix in system["tidx"])


def test_proxy_keywords_equal_jax():
    lexicon = {"cat": [["k", "ae", "t"]], "cut": [["k", "ah", "t"]],
               "dog": [["d", "ao", "g"]], "at": [["ae", "t"]],
               "kay": [["k", "ey"]]}
    conf = {("d", "t"): 0.3, ("t", "d"): 0.3}
    for oov in (["k", "ae", "d"], ["d", "ao", "k"], ["ae", "k", "ey"]):
        got = tkws.generate_proxy_keywords(oov, copy.deepcopy(lexicon),
                                           conf, nbest=5, beam=3.0)
        assert got == jkws.generate_proxy_keywords(oov, lexicon, conf,
                                                   nbest=5, beam=3.0)
    words, cost = tkws.generate_proxy_keywords(["k", "ae", "d"], lexicon,
                                               conf, nbest=3, beam=2.0)[0]
    assert words == ("cat",) and cost == pytest.approx(0.3)


def _two_path_lattice():
    lat = Lattice()
    s0, s1, s2, s3 = (lat.add_state() for _ in range(4))
    lat.start = s0
    lat.add_arc(s0, 1, 7, 1.0, 0.0, s1)
    lat.add_arc(s0, 2, 8, 2.0, 0.0, s1)
    lat.add_arc(s1, 3, 9, 0.0, 0.0, s2)
    lat.add_arc(s2, 0, 0, 0.0, 0.0, s3)
    lat.set_final(s3)
    return lat


def test_kws_contracts():
    """tests/test_kws.py's posterior, factor, eps-join and TWV checks on
    the port."""
    idx = tkws.lattice_to_kws_index(_two_path_lattice(), "utt1")
    pa = np.exp(-1) / (np.exp(-1) + np.exp(-2))
    h7, h8 = tkws.search_index([idx], [7]), tkws.search_index([idx], [8])
    assert h7[0][3] == pytest.approx(pa, abs=1e-6)
    assert h8[0][3] == pytest.approx(1 - pa, abs=1e-6)
    assert (h7[0][1], h7[0][2]) == (0, 1)
    h = tkws.search_index([idx], [7, 9])
    assert len(h) == 1 and h[0][3] == pytest.approx(pa, abs=1e-6)
    assert (h[0][1], h[0][2]) == (0, 2)
    assert tkws.search_index([idx], [9])[0][3] == pytest.approx(1.0,
                                                                abs=1e-6)
    assert tkws.search_index([idx], [8, 7]) == []
    lat = Lattice()
    s0, s1, s2, s3 = (lat.add_state() for _ in range(4))
    lat.start = s0
    lat.add_arc(s0, 1, 5, 0.5, 0.0, s1)
    lat.add_arc(s1, 0, 0, 0.1, 0.0, s2)
    lat.add_arc(s2, 2, 6, 0.5, 0.0, s3)
    lat.set_final(s3)
    h = tkws.search_index([tkws.lattice_to_kws_index(lat, "u")], [5, 6])
    assert len(h) == 1 and h[0][3] == pytest.approx(1.0, abs=1e-6)
    refs = {"kw1": [("u1", 100, 130), ("u2", 50, 80)],
            "kw2": [("u1", 300, 340)]}
    hits = {"kw1": [("u1", 105, 128, 0.9), ("u3", 10, 40, 0.8)], "kw2": []}
    res = tkws.compute_twv(refs, hits, audio_duration_sec=600.0)
    exp1 = 1.0 - 0.5 - tkws.TwvOptions().beta * (1.0 / (600.0 - 2))
    assert res["per_kw"]["kw1"] == pytest.approx(exp1, abs=1e-6)
    assert res["per_kw"]["kw2"] == pytest.approx(0.0, abs=1e-6)
    assert res["atwv"] == pytest.approx(exp1 / 2, abs=1e-6)
    assert res["stwv"] == pytest.approx(0.25, abs=1e-6)
    res = tkws.compute_twv({"kw": [("u1", 10, 20)]},
                           {"kw": [("u1", 12, 22, 0.2)]}, 100.0)
    assert res["per_kw"]["kw"] == pytest.approx(0.0)
    assert res["stwv"] == pytest.approx(1.0)
