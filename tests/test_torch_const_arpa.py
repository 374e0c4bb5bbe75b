"""Port parity: kaldi_tpu_torch.lm.const_arpa and lm.synth against
kaldi_tpu's, on the CPU.

tests/test_const_arpa.py's contracts, restated on ARPA text written out
in chip_smoke.ARPA_SHAPES (the reference fixtures are absent from this
tree) in the reference's three shapes: a plain trigram (after
src/lm/input.arpa), a trigram whose histories lack their own entries
(after missing_backoffs.arpa) and a 4-gram with backoff weights on
entries that extend nothing and a history whose prefix is no entry
(after unused_backoffs.arpa). The packed tables equal JAX's array for array;
`sentence_logprob` equals JAX's exactly and `ArpaLm.score_sentence`
within 1e-4 (the columns are f32); `step_batch` equals JAX's and the
scalar `step` exactly, out-of-domain words included; the batch rescorer's
lattices equal JAX's batch rescorer's array for array, on lattices of the
port's decoders (the yesno padded decoder's and a 40-word hub graph's CSR
decoder's) and on random topologically sorted lattices, with the scalar
rescorer's best path and cost; `synth_trigram_arpa` equals JAX's entry for
entry. chip_smoke's card-vs-CPU helpers of phase 29 run here with the
CPU on both sides.
"""

import copy
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.fst.fst import SymbolTable as JSymbols
from kaldi_tpu.lat.functions import lattice_best_path as jbest
from kaldi_tpu.lm import const_arpa as jca
from kaldi_tpu.lm.arpa import ArpaLm as JArpa
from kaldi_tpu.lm.synth import (synth_lexicon_text as jlex_text,
                                synth_trigram_arpa as jsynth)
from kaldi_tpu_torch.fst.fst import SymbolTable
from kaldi_tpu_torch.lat.functions import lattice_best_path
from kaldi_tpu_torch.lat.lattice import Lattice
from kaldi_tpu_torch.lm import const_arpa as tca
from kaldi_tpu_torch.lm.arpa import ArpaLm
from kaldi_tpu_torch.lm.synth import synth_lexicon_text, synth_trigram_arpa
from test_torch_lat_posteriors import build_system, lattice_to_jax

torch.set_num_threads(2)

LMS = cs.ARPA_SHAPES
PLAIN = LMS["plain"]
TABLES = ("row_lo", "col_word", "col_cost", "col_next", "backoff_cost",
          "backoff_state", "_ent_key", "_hist_pad")


def _tables(words):
    jw, tw = JSymbols(), SymbolTable()
    for t in (jw, tw):
        t.add("<eps>")
        for w in words:
            t.add(w)
        t.add("#0")
    return jw, tw


def _pair(text, words=("a", "b", "c", "<s>", "</s>")):
    jw, tw = _tables(words)
    return (jca.ConstArpaLm(JArpa.parse(text), jw),
            tca.ConstArpaLm(ArpaLm.parse(text), tw), tw)


@pytest.mark.parametrize("name", sorted(LMS))
def test_tables_equal_jax(name):
    jc, tc, _w = _pair(LMS[name])
    jc._batch_tables()
    tc._batch_tables()
    assert tc._hist_index == jc._hist_index
    assert tc._state_hist == jc._state_hist
    assert tc._ext_index == jc._ext_index
    for a in TABLES:
        x, y = getattr(jc, a), getattr(tc, a)
        assert x.dtype == y.dtype and np.array_equal(x, y), a
    assert tc._wspan == jc._wspan
    assert sorted(tc._ext_tabs) == sorted(jc._ext_tabs)
    for L, (k, v) in jc._ext_tabs.items():
        assert np.array_equal(tc._ext_tabs[L][0], k)
        assert np.array_equal(tc._ext_tabs[L][1], v)


@pytest.mark.parametrize("name", sorted(LMS))
def test_sentence_logprob_equals_jax_and_arpa(name):
    jc, tc, words = _pair(LMS[name])
    lm = ArpaLm.parse(LMS[name])
    rng = np.random.RandomState(0)
    for _ in range(40):
        sent = [str(rng.choice(["a", "b", "c"]))
                for _ in range(rng.randint(1, 7))]
        ids = [words[w] for w in sent]
        got = tc.sentence_logprob(ids)
        assert got == jc.sentence_logprob(ids), sent
        assert got == pytest.approx(lm.score_sentence(sent), abs=1e-4), sent


def test_trigram_state_tracking():
    """tests/test_const_arpa.py:52's contract: P(b | <s> a) is the
    trigram, not a backed-off bigram."""
    _jc, tc, words = _pair(PLAIN)
    s = tc.start_state()
    s, _c = tc.step(s, words["a"])
    _s2, c = tc.step(s, words["b"])
    assert c == pytest.approx(0.34958 * math.log(10), abs=1e-4)


@pytest.mark.parametrize("name", sorted(LMS))
def test_step_batch_equals_jax_and_step(name):
    """20,000 queries over every state and word ids inside, straddling and
    beyond the packed column domain: next states and f64 costs equal
    JAX's step_batch and the scalar step exactly, finals too."""
    jc, tc, _w = _pair(LMS[name])
    jc._batch_tables()
    W = jc._wspan
    rng = np.random.RandomState(1)
    N = 20000
    states = rng.randint(0, jc.num_states, N)
    words = np.concatenate([rng.randint(-4, W + 8, N - 40),
                            np.arange(W - 5, W + 15),
                            rng.randint(W, 4 * W, 20)]).astype(np.int64)
    jn, jcost = jc.step_batch(states, words)
    tn, tcost = tc.step_batch(states, words, device="cpu")
    assert tn.dtype == np.int64 and tcost.dtype == np.float64
    assert np.array_equal(tn, jn) and np.array_equal(tcost, jcost)
    for i in range(0, N, 37):
        assert tc.step(int(states[i]), int(words[i])) == \
            (tn[i], tcost[i]), i
    assert np.array_equal(tc.final_cost_batch(states[:500], device="cpu"),
                          jc.final_cost_batch(states[:500]))
    assert [tc.final_cost(int(s)) for s in states[:50]] == \
        list(tc.final_cost_batch(states[:50], device="cpu"))


def _same_lattice(got, want, what):
    g, w = got.to_arrays(), want.to_arrays()
    assert g[0] == w[0], what
    for x, y in zip(g[1:], w[1:]):
        assert np.array_equal(x, y), what
    assert got.start == want.start, what
    assert list(got.finals.items()) == list(want.finals.items()), what


def _yesno_arpa(words):
    """A trigram over the yesno words, with backoffs."""
    a, b = words
    return (f"\\data\\\nngram 1=4\nngram 2=4\nngram 3=2\n\n\\1-grams:\n"
            f"-0.4\t{a}\t-0.2\n-0.3\t{b}\t-0.25\n-99\t<s>\t-0.3\n"
            f"-0.9\t</s>\n\n\\2-grams:\n-0.2\t{a} {b}\t-0.1\n"
            f"-0.5\t{b} {b}\t-0.15\n-0.25\t<s> {a}\t-0.2\n"
            f"-0.6\t{a} </s>\n\n\\3-grams:\n-0.1\t<s> {a} {b}\n"
            f"-0.35\t{b} {b} </s>\n\n\\end\\\n")


@pytest.fixture(scope="module")
def yesno():
    return build_system(jax_decode=False)


def _rescore_both(lats, jc, tc, scales=(0.5, 1.0, -1.0)):
    n = 0
    for lat in lats:
        if lat is None:
            continue
        jl = lattice_to_jax(lat)
        for scale in scales:
            want = jca.lattice_lmrescore_const_arpa_batch(
                copy.deepcopy(jl), jc, scale)
            got = tca.lattice_lmrescore_const_arpa_batch(lat, tc, scale,
                                                         device="cpu")
            _same_lattice(got, want, scale)
            scalar = tca.lattice_lmrescore_const_arpa(lat, tc, scale)
            n += 1
            if scalar.num_states == 0:          # no path reaches a final
                assert got.num_states == 0
                continue
            gb, sb = lattice_best_path(got), lattice_best_path(scalar)
            assert gb[0] == sb[0] and gb[2] == pytest.approx(sb[2],
                                                             abs=1e-9)
    return n


def test_batch_rescoring_equals_jax_on_yesno_lattices(yesno):
    lang = yesno["lang"]
    text = _yesno_arpa(["YES", "NO"])
    jw, tw = JSymbols(), SymbolTable()
    for i in range(len(lang.words)):
        jw.add(lang.words.sym(i))
        tw.add(lang.words.sym(i))
    jc = jca.ConstArpaLm(JArpa.parse(text), jw)
    tc = tca.ConstArpaLm(ArpaLm.parse(text), tw)
    tca.stats.update(lattices=0, levels=0, scalar=0)
    n = _rescore_both(yesno["tlats"], jc, tc)
    assert n >= 36 and tca.stats["lattices"] == n
    assert tca.stats["scalar"] == 0 and tca.stats["levels"] > n


def test_batch_rescoring_equals_jax_on_hub_lattices():
    words, lats = cs.hub_lattices()
    jw, tw = _tables(words)
    jl = jsynth(words, 300, 300, rng=np.random.default_rng(3))
    tl = synth_trigram_arpa(words, 300, 300, rng=np.random.default_rng(3))
    jc, tc = jca.ConstArpaLm(jl, jw), tca.ConstArpaLm(tl, tw)
    assert _rescore_both(lats, jc, tc) >= 6


def test_batch_rescoring_equals_jax_on_random_lattices():
    """tests/test_const_arpa.py:216's random topological lattices, with
    out-of-vocabulary olabels, at three scales."""
    jc, tc, words = _pair(PLAIN)
    assert _rescore_both(_random_lattices(words, 8), jc, tc) == 24


def _random_lattices(words, n):
    return cs.random_topo_lattices(1, n, [words["a"], words["b"],
                                          words["c"], 0, 99])


def test_many_lattices_at_once_equal_jax_one_by_one(yesno):
    """`lattice_lmrescore_const_arpa_many` runs the lattices' BFS levels
    together (one sync per level of the deepest): each lattice still
    equals JAX's batch rescorer's, an empty and a non-topological lattice
    among them."""
    jc, tc, words = _pair(PLAIN)
    rand = _random_lattices(words, 5)
    back = Lattice()
    s0, s1, s2 = back.add_state(), back.add_state(), back.add_state()
    back.start = s0
    back.add_arc(s0, 1, words["a"], 0.1, 0.2, s2)
    back.add_arc(s2, 2, words["b"], 0.1, 0.2, s1)
    back.set_final(s1)
    lats = rand[:2] + [Lattice(), back] + rand[2:]
    tca.stats.update(levels=0, scalar=0)
    got = tca.lattice_lmrescore_const_arpa_many(lats, tc, 0.5, device="cpu")
    assert tca.stats["scalar"] == 1
    assert tca.stats["levels"] < sum(
        len(lat.topological_order()) for lat in rand)
    for lat, g in zip(lats, got):
        want = jca.lattice_lmrescore_const_arpa_batch(lattice_to_jax(lat),
                                                      jc, 0.5)
        _same_lattice(g, want, "many")


def test_non_topological_lattice_takes_the_scalar_path():
    """An acyclic lattice with an arc to a lower-numbered state goes to the
    scalar rescorer, as in JAX, and is counted."""
    jc, tc, words = _pair(PLAIN)
    lat = Lattice()
    s0, s1, s2 = lat.add_state(), lat.add_state(), lat.add_state()
    lat.start = s0
    lat.add_arc(s0, 1, words["a"], 0.1, 0.2, s2)
    lat.add_arc(s2, 2, words["b"], 0.1, 0.2, s1)
    lat.add_arc(s0, 3, words["c"], 0.5, 0.5, s1)
    lat.set_final(s1)
    tca.stats["scalar"] = 0
    got = tca.lattice_lmrescore_const_arpa_batch(lat, tc, 1.0, device="cpu")
    want = jca.lattice_lmrescore_const_arpa_batch(lattice_to_jax(lat), jc,
                                                  1.0)
    assert tca.stats["scalar"] == 1
    _same_lattice(got, want, "scalar")
    assert jbest(want)[0] == lattice_best_path(got)[0] == \
        [words["a"], words["b"]]


def test_rescoring_swaps_lm_scores():
    """tests/test_const_arpa.py:64's contract on the port: an LM that
    prefers the other path flips the best path, and scale -1 restores."""
    _jw, words = _tables(["a", "b"])
    A, B = words["a"], words["b"]
    lat = Lattice()
    s0, s1, s2 = lat.add_state(), lat.add_state(), lat.add_state()
    lat.start = s0
    lat.add_arc(s0, 1, A, 0.0, 1.0, s1)
    lat.add_arc(s0, 2, B, 0.0, 1.1, s2)
    lat.set_final(s1)
    lat.set_final(s2)
    clm = tca.ConstArpaLm(ArpaLm.parse(
        "\\data\\\nngram 1=4\n\n\\1-grams:\n-9\ta\n-0.01\tb\n-99\t<s>\n"
        "-0.01\t</s>\n\n\\end\\\n"), words)
    for rescore in (tca.lattice_lmrescore_const_arpa,
                    lambda lat, lm, s: tca.lattice_lmrescore_const_arpa_batch(
                        lat, lm, s, device="cpu")):
        res = rescore(lat, clm, 1.0)
        assert lattice_best_path(res)[0] == [B]
        assert lattice_best_path(rescore(res, clm, -1.0))[0] == [A]


def test_synth_equals_jax():
    """The same default_rng seed gives JAX's lexicon and its ArpaLm entry
    for entry, in insertion order (which fixes ConstArpaLm's state ids)."""
    jt, jws = jlex_text(300, rng=np.random.default_rng(5))
    tt, tws = synth_lexicon_text(300, rng=np.random.default_rng(5))
    assert (tt, tws) == (jt, jws)
    jl = jsynth(jws, 4000, 4000, rng=np.random.default_rng(7))
    tl = synth_trigram_arpa(tws, 4000, 4000, rng=np.random.default_rng(7))
    assert tl.order == jl.order == 3
    for a, b in zip(tl.ngrams, jl.ngrams):
        assert list(a.items()) == list(b.items())
    jw, tw = _tables(tws)
    jc, tc = jca.ConstArpaLm(jl, jw), tca.ConstArpaLm(tl, tw)
    jc._batch_tables()
    tc._batch_tables()
    for a in TABLES:
        assert np.array_equal(getattr(tc, a), getattr(jc, a)), a


def test_device_tables_are_cached():
    _jc, tc, _w = _pair(PLAIN)
    tabs = tc.device_tables("cpu")
    assert tc.device_tables("cpu") is tabs
    assert tc.table_bytes(tabs) >= tc._ent_key.nbytes + tc.col_cost.nbytes


@pytest.mark.parametrize("name", sorted(LMS))
def test_card_helpers_on_the_cpu(name):
    """chip_smoke's step_batch and rescoring checks (phase 29), the CPU on
    both sides: nothing differs."""
    assert not any(cs.step_batch_card_vs_cpu(cs.shape_lm(name),
                                             card="cpu").values())
    lats = cs.random_topo_lattices(2, 4, [1, 2, 3, 0, 99])
    assert cs.rescore_card_vs_cpu(lats, cs.shape_lm(name), 0.5,
                                  card="cpu")[-1] == 0
