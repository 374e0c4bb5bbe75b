"""Port parity: kaldi_tpu_torch.lat.mbr and steps.score against
kaldi_tpu's, on the CPU.

MBR decoding, word confidences, expected WER and the LM-weight x
word-insertion-penalty sweep (host code, copied verbatim) on the port's
yesno denominator lattices (`build_system` of
tests/test_torch_lat_posteriors.py) give JAX's results exactly: words,
sausage bins and posteriors, every grid point's WER counts and the chosen
point. Then tests/test_score_sweep.py's and test_signal_pitch.py:105's
(`mbr_decode`) contracts on the port.
"""

import copy

import pytest
import torch

from kaldi_tpu.lat import mbr as jmbr
from kaldi_tpu.steps import score as jscore
from kaldi_tpu_torch.lat import mbr as tmbr
from kaldi_tpu_torch.lat.lattice import Lattice
from kaldi_tpu_torch.params import lattice_from_jax
from kaldi_tpu_torch.steps import score as tscore
from test_torch_lat_posteriors import build_system, form, lattice_to_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def system():
    s = build_system(jax_decode=False)
    lang = s["lang"]
    s["pairs"] = [(u, lattice_to_jax(lat), [lang.words[w] for w in ws])
                  for lat, (u, _f, ws) in zip(s["tlats"], s["train"])
                  if lat is not None]
    return s


def test_mbr_equals_jax(system):
    for _u, jlat, ref in system["pairs"]:
        want = jmbr.mbr_decode(copy.deepcopy(jlat), max_paths=50)
        got = tmbr.mbr_decode(lattice_from_jax(jlat), max_paths=50)
        assert form(got) == form(want)
        assert tmbr.word_confidences(*got) == jmbr.word_confidences(*want)
        for hyp in (got[0], ref):
            assert tmbr.expected_wer(lattice_from_jax(jlat), hyp, 50) == \
                jmbr.expected_wer(copy.deepcopy(jlat), hyp, 50)


def _stats(grid):
    return {k: (v.n_ref, v.n_sub, v.n_ins, v.n_del, v.n_sent, v.n_sent_err)
            for k, v in grid.items()}


@pytest.mark.parametrize("words", [False, True], ids=["ids", "symbols"])
def test_score_sweep_equals_jax(system, words):
    lang = system["lang"]
    lats = {u: lattice_from_jax(j) for u, j, _r in system["pairs"]}
    jlats = {u: copy.deepcopy(j) for u, j, _r in system["pairs"]}
    lats["missing"] = jlats["missing"] = None
    refs = {u: ([lang.words.sym(w) for w in r] if words else r)
            for u, _j, r in system["pairs"]}
    refs["missing"] = [lang.words["YES"]] if not words else ["YES"]
    kw = dict(words=lang.words if words else None, lm_scales=(1, 5, 9, 13),
              word_ins_penalties=(0.0, 0.5, 1.0))
    got = tscore.score_lattices(lats, refs, **kw)
    jkw = dict(kw, words=system["jlang"].words if words else None)
    want = jscore.score_lattices(jlats, refs, **jkw)
    assert got[1] == want[1]
    assert _stats(got[2]) == _stats(want[2])
    assert str(got[0]) == str(want[0])


def _lat(word_costs):
    lat = Lattice()
    lat.start = lat.add_state()
    for ws, (g, a) in word_costs.items():
        cur = lat.start
        for w in ws:
            ns = lat.add_state()
            lat.add_arc(cur, 1, w, g / len(ws), a / len(ws), ns)
            cur = ns
        lat.set_final(cur)
    return lat


def test_sweep_contracts():
    """tests/test_score_sweep.py on the port: a high lmwt fixes an
    acoustically wrong path, a word-insertion penalty kills an insertion,
    and the chosen point is the grid's argmin."""
    lattices = {"u1": _lat({(5, 6): (6.0, 0.5), (7,): (2.0, 5.0)}),
                "u2": _lat({(8,): (1.0, 1.0)})}
    stats, _pt, grid = tscore.score_lattices(
        lattices, {"u1": [7], "u2": [8]}, lm_scales=(1, 5, 15),
        word_ins_penalties=(0.0, 1.0), decode_acoustic_scale=1.0)
    assert stats.wer == 0.0 and grid[(1, 0.0)].wer > 0.0
    assert stats.wer == min(s.wer for s in grid.values())
    stats, (_lmwt, wip), grid = tscore.score_lattices(
        {"u": _lat({(5, 6): (1.0, 0.9), (5,): (1.0, 1.0)})}, {"u": [5]},
        lm_scales=(1,), word_ins_penalties=(0.0, 0.5),
        decode_acoustic_scale=1.0)
    assert grid[(1, 0.0)].wer > 0.0 and grid[(1, 0.5)].wer == 0.0
    assert wip == 0.5 and stats.wer == 0.0


def test_mbr_contracts():
    """tests/test_signal_pitch.py:105 on the port."""
    lat = Lattice()
    s = [lat.add_state() for _ in range(4)]
    lat.start = s[0]
    lat.add_arc(s[0], 1, 1, 0.0, 0.0, s[1])
    lat.add_arc(s[1], 2, 2, 0.0, 0.5, s[2])
    lat.add_arc(s[1], 3, 3, 0.0, 1.5, s[3])
    lat.set_final(s[2])
    lat.set_final(s[3])
    hyp, bins = tmbr.mbr_decode(lat)
    assert hyp == [1, 2]
    conf = tmbr.word_confidences(hyp, bins)
    assert conf[0] == pytest.approx(1.0, abs=1e-6) and 0.5 < conf[1] < 1.0
    assert tmbr.expected_wer(lat, hyp) < tmbr.expected_wer(lat, [1, 3])
    assert tmbr.expected_wer(Lattice(), [1, 2]) == float("inf")
