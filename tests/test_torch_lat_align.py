"""Port parity: kaldi_tpu_torch.lat.align against kaldi_tpu's, on the CPU.

Every function of lat/align.py (host code, copied verbatim) on the port's
yesno denominator lattices (`build_system` of
tests/test_torch_lat_posteriors.py: the port's padded decoder, each
lattice copied into JAX's class) with each package's transition model:
the same result exactly, words, ids, frames, arc structure and the f64
costs. Then tests/test_lat_align.py's contracts on the port.
"""

import copy

import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.lat import align as jal
from kaldi_tpu.lat import functions as jfun
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.lat import align as tal
from kaldi_tpu_torch.lat import functions as tfun
from kaldi_tpu_torch.lat.lattice import Lattice
from kaldi_tpu_torch.params import lattice_from_jax
from kaldi_tpu_torch.utils.wer import levenshtein_alignment
from test_torch_lat_posteriors import build_system, form, lattice_to_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def system():
    s = build_system(jax_decode=False)
    lang = s["lang"]
    lex = {}
    for line in cs.YESNO_LEXICON.splitlines():
        w, *pron = line.split()
        lex.setdefault(lang.words[w], []).append(
            tuple(lang.phones[p] for p in pron))
    s["lex"] = lex
    s["sil"] = frozenset({lang.phones["SIL"]})
    s["pairs"] = [(lat, lattice_to_jax(lat), [lang.words[w] for w in ws])
                  for lat, (_u, _f, ws) in zip(s["tlats"], s["train"])
                  if lat is not None]
    assert len(s["pairs"]) >= 12
    return s


# name -> f(align module, functions module, lattice, transition model,
# system, reference word ids, next lattice)
FUNCTIONS = {
    "ali_to_phones": lambda m, f, lat, tm, s, ref, nxt: m.ali_to_phones(
        tm, f.lattice_best_path(lat)[1]),
    "ali_to_phones_per_frame": lambda m, f, lat, tm, s, ref, nxt:
        m.ali_to_phones(tm, f.lattice_best_path(lat)[1], per_frame=True),
    "words_to_ctm": lambda m, f, lat, tm, s, ref, nxt: m.words_to_ctm(
        f.lattice_best_path(lat)[1], f.lattice_best_path(lat)[0], tm,
        s["lex"], s["sil"]),
    "word_align_lattice": lambda m, f, lat, tm, s, ref, nxt:
        m.word_align_lattice(lat, tm, s["lex"], s["sil"]),
    "lattice_oracle": lambda m, f, lat, tm, s, ref, nxt: m.lattice_oracle(
        lat, ref),
    "lattice_oracle_wrong_ref": lambda m, f, lat, tm, s, ref, nxt:
        m.lattice_oracle(lat, ref[::-1] + [99]),
    "lattice_confidence": lambda m, f, lat, tm, s, ref, nxt:
        m.lattice_confidence(lat),
    "push_lattice": lambda m, f, lat, tm, s, ref, nxt: m.push_lattice(lat),
    "minimize_lattice": lambda m, f, lat, tm, s, ref, nxt:
        m.minimize_lattice(lat),
    "lattice_union": lambda m, f, lat, tm, s, ref, nxt: m.lattice_union(
        lat, nxt),
    "lattice_interp": lambda m, f, lat, tm, s, ref, nxt: m.lattice_interp(
        lat, f.lattice_scale(copy.deepcopy(lat), 1.0, 0.5), 0.3),
    "phone_align_lattice": lambda m, f, lat, tm, s, ref, nxt:
        m.phone_align_lattice(lat, tm),
    "phone_align_lattice_phones": lambda m, f, lat, tm, s, ref, nxt:
        m.phone_align_lattice(lat, tm, replace_output_symbols=True),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_align_function_equals_jax(system, name):
    fn = FUNCTIONS[name]
    jtm = system["jmodel"].trans_model
    ttm = system["model"].trans_model
    pairs = system["pairs"]
    # interp's two n-best lists (128 and 1024 paths) take most of the time
    for i, (tlat, jlat, ref) in enumerate(
            pairs[:4] if name == "lattice_interp" else pairs):
        tn, jn = pairs[(i + 1) % len(pairs)][:2]
        want = fn(jal, jfun, copy.deepcopy(jlat), jtm, system, ref,
                  copy.deepcopy(jn))
        got = fn(tal, tfun, lattice_from_jax(jlat), ttm, system, ref,
                 lattice_from_jax(jn))
        assert form(got) == form(want), (name, i)


def test_oracle_no_worse_than_best_path(system):
    """The oracle's edits never exceed the best path's."""
    for tlat, _j, ref in system["pairs"]:
        edits, words = tal.lattice_oracle(tlat, ref)
        best = tfun.lattice_best_path(tlat)[0]
        _p, (s, i, d) = levenshtein_alignment(ref, best)
        assert edits <= s + i + d and len(words) > 0


class TmStub:
    """tests/test_lat_align.py's stub: tids encode (phone*100 +
    hmm_state*10 + selfloop)."""

    def transition_id_to_phone(self, tid):
        return tid // 100

    def transition_id_to_hmm_state(self, tid):
        return (tid % 100) // 10

    def is_self_loop(self, tid):
        return tid % 10 == 1

    def is_final(self, tid):
        return (tid % 100) // 10 == 1 and tid % 10 == 0


def _abc_lattice():
    """Paths: A-B (cost 1), A-C (cost 2), D (cost 5)."""
    lat = Lattice()
    s = [lat.add_state() for _ in range(5)]
    lat.start = s[0]
    lat.add_arc(s[0], 1, 10, 0.5, 0.0, s[1])
    lat.add_arc(s[1], 2, 11, 0.5, 0.0, s[2])
    lat.add_arc(s[1], 3, 12, 1.5, 0.0, s[3])
    lat.add_arc(s[0], 4, 13, 5.0, 0.0, s[4])
    for t in (s[2], s[3], s[4]):
        lat.set_final(t)
    return lat


def _costs(lat):
    return sorted((tuple(w), round(c, 6)) for (w, _t, c) in
                  tfun.nbest(lat, 10))


def test_stub_contracts():
    """tests/test_lat_align.py's ali_to_phones, words_to_ctm, oracle,
    confidence, push, minimize, union and interp checks on the port."""
    tm = TmStub()
    tids = [300, 301, 310, 500, 510]
    assert tal.ali_to_phones(tm, tids) == [(3, 0, 3), (5, 3, 2)]
    assert tal.ali_to_phones(tm, tids, per_frame=True) == [3, 3, 3, 5, 5]
    assert tal.words_to_ctm([300, 301, 310, 500, 510, 700, 710, 711],
                            [42, 43], tm, {42: [(3, 5)], 43: [(7,)]}) == \
        [(42, 0, 5), (43, 5, 3)]
    lat = _abc_lattice()
    assert tal.lattice_oracle(lat, [10, 11]) == (0, [10, 11])
    assert tal.lattice_oracle(lat, [10, 99])[0] == 1
    assert tal.lattice_oracle(lat, [13])[0] == 0
    assert tal.lattice_oracle(lat, [99, 98, 97])[0] == 3
    assert tal.lattice_confidence(lat) == pytest.approx(1.0)
    one = Lattice()
    a, b = one.add_state(), one.add_state()
    one.start = a
    one.add_arc(a, 1, 5, 0.3, 0.0, b)
    one.set_final(b)
    assert tal.lattice_confidence(one) == float("inf")
    pushed = tal.push_lattice(lat)
    assert _costs(pushed) == _costs(lat)
    assert tfun.lattice_best_path(pushed)[2] == pytest.approx(1.0)
    m = Lattice()
    s = [m.add_state() for _ in range(6)]
    m.start = s[0]
    m.add_arc(s[0], 1, 10, 1.0, 0.0, s[1])
    m.add_arc(s[0], 2, 11, 2.0, 0.0, s[2])
    m.add_arc(s[1], 3, 12, 1.0, 0.0, s[3])
    m.add_arc(s[2], 3, 12, 1.0, 0.0, s[4])
    m.set_final(s[3])
    m.set_final(s[4])
    mini = tal.minimize_lattice(m)
    assert _costs(mini) == _costs(m) and mini.num_states < m.num_states
    bl = Lattice()
    b0, b1, b2 = bl.add_state(), bl.add_state(), bl.add_state()
    bl.start = b0
    bl.add_arc(b0, 1, 10, 0.2, 0.0, b1)
    bl.add_arc(b1, 2, 11, 0.2, 0.0, b2)
    bl.set_final(b2)
    seqs = {tuple(w) for (w, _t, _c) in tfun.nbest(
        tal.lattice_union(lat, bl), 20)}
    assert (10, 11) in seqs and (13,) in seqs
    paths = tfun.nbest(tal.lattice_interp(lat, bl, alpha=0.5), 10)
    assert len(paths) == 1 and tuple(paths[0][0]) == (10, 11)
    assert paths[0][2] == pytest.approx(0.5 * 1.0 + 0.5 * 0.4)
    assert {tuple(w) for (w, _t, _c) in tfun.nbest(
        tal.lattice_union(lat, Lattice()), 20)} >= {(10, 11)}


def test_word_align_multi_pron():
    """A word with prons (3,) and (3, 5) pronounced (3, 5) is emitted once
    on every path (tests/test_lat_align.py:221)."""
    lat = Lattice()
    s = [lat.add_state() for _ in range(5)]
    lat.start = s[0]
    lat.add_arc(s[0], 300, 7, 0.1, 0.0, s[1])
    lat.add_arc(s[1], 310, 0, 0.1, 0.0, s[2])
    lat.add_arc(s[2], 500, 0, 0.1, 0.0, s[3])
    lat.add_arc(s[3], 510, 0, 0.1, 0.0, s[4])
    lat.set_final(s[4])
    paths = tal.word_align_lattice(lat, TmStub(), {7: [(3,), (3, 5)]}).paths()
    assert paths and all(sum(1 for w in ws if w == 7) == 1
                         for (ws, _t, _c) in paths)


def _fwd_sl(phones):
    topo = HmmTopology.three_state(phones, num_states=1)
    tm = TransitionModel(topo, lambda ph, pc: ph - 1)
    fwd, sl = {}, {}
    for tid in range(1, tm.num_transition_ids + 1):
        ph = tm.transition_id_to_phone(tid)
        (sl if tm.is_self_loop(tid) else fwd)[ph] = tid
    return tm, fwd, sl


def test_phone_align_contracts():
    """tests/test_lat_align.py:268 and :324 on the port: a linear tid
    lattice splits into one arc per phone with summed costs and its word
    (or phone ids), and a completed phone before a branch is flushed
    once."""
    tm, fwd, sl = _fwd_sl([1, 2])
    lat = Lattice()
    st = [lat.add_state() for _ in range(4)]
    lat.start = st[0]
    for k, (tid, w) in enumerate([(fwd[1], 9), (sl[1], 0), (fwd[2], 0)]):
        lat.add_arc(st[k], tid, w, 0.1, 0.5, st[k + 1])
    lat.set_final(st[-1])
    al = tal.phone_align_lattice(lat, tm)
    a1 = al.arcs[al.start][0]
    a2 = al.arcs[a1.nextstate][0]
    assert (a1.tids, a2.tids) == ((fwd[1], sl[1]), (fwd[2],))
    assert (a1.olabel, a2.olabel) == (9, 0)
    assert a1.graph_cost == pytest.approx(0.2) and \
        a1.acoustic_cost == pytest.approx(1.0)
    al2 = tal.phone_align_lattice(lat, tm, replace_output_symbols=True)
    b1 = al2.arcs[al2.start][0]
    assert [b1.olabel, al2.arcs[b1.nextstate][0].olabel] == [1, 2]
    tm, fwd, sl = _fwd_sl([1, 2, 3])
    lat = Lattice()
    s = [lat.add_state() for _ in range(4)]
    lat.start = s[0]
    lat.add_arc(s[0], fwd[1], 7, 0.0, 0.5, s[1])
    lat.add_arc(s[1], sl[1], 0, 0.0, 0.5, s[2])
    lat.add_arc(s[2], fwd[2], 8, 0.0, 1.0, s[3])
    lat.add_arc(s[2], fwd[3], 9, 0.0, 2.0, s[3])
    lat.set_final(s[3])
    al = tal.phone_align_lattice(lat, tm)
    assert len(al.arcs[al.start]) == 1
    a1 = al.arcs[al.start][0]
    assert a1.tids == (fwd[1], sl[1])
    assert sorted(a.olabel for a in al.arcs[a1.nextstate]) == [8, 9]
    assert len(al.paths()) == 2
