"""Port parity: kaldi_tpu_torch's `viterbi_align` and `equal_align` against
kaldi_tpu's on padded batches of yesno and rm-like training graphs, from
the same log-likelihoods, on the CPU.

Tids and words must be identical and costs within 1e-5 relative; an
utterance too short for its transcript has no path (None in both). The
log-likelihoods are Gaussian noise, or integers so that arcs tie and the
backpointer's tie rule (the smallest arc index within 1e-6) decides.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.decoder import graph_pack as jgp
from kaldi_tpu.decoder import viterbi as jvit
from kaldi_tpu.fst import graph as jgraph
from kaldi_tpu.fst import lang as jlang
from kaldi_tpu.hmm import transition_model as jtm
from kaldi_tpu.tree import context_dep as jctx
from kaldi_tpu_torch.decoder import graph_pack as tgp
from kaldi_tpu_torch.decoder import viterbi as tvit
from kaldi_tpu_torch.fst import graph as tgraph
from kaldi_tpu_torch.fst import lang as tlang
from kaldi_tpu_torch.hmm import transition_model as ttm
from kaldi_tpu_torch.tree import context_dep as tctx

torch.set_num_threads(2)

CASES = {
    "yesno": (cs.YESNO_LEXICON,
              [["YES", "NO"], ["NO"], ["YES", "YES", "NO", "NO"],
               ["NO", "YES", "YES"], ["YES", "NO", "YES", "NO"]],
              [60, 33, 90, 71, 5]),
    "rm_like": (cs.RM_LEXICON,
                [["ONE", "TWO", "THREE"], ["STOP"], ["FIVE", "SIX"],
                 ["ZERO", "OH", "NINE", "EIGHT"], ["SEVEN", "FOUR"]],
                [80, 41, 66, 120, 9]),
}


def _batch(mods, lex, transcripts):
    lang_m, graph_m, tm_m, ctx_m, gp_m = mods
    lang = lang_m.prepare_lang(lang_m.Lexicon.parse(lex), ["SIL"], "SIL",
                               num_sil_states=3)
    ctx = ctx_m.MonophoneContextDependency.from_topo(lang.topo)
    tm = tm_m.TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    comp = graph_m.TrainingGraphCompiler(lang, tm, ctx, 1.0, 0.1)
    fsts = [comp.compile_transcript(w) for w in transcripts]
    return gp_m.pack_graphs(fsts, tm.id2pdf_array), tm.num_pdfs


@pytest.fixture(scope="module", params=list(CASES))
def batches(request):
    lex, transcripts, lengths = CASES[request.param]
    jb, P = _batch((jlang, jgraph, jtm, jctx, jgp), lex, transcripts)
    tb, _ = _batch((tlang, tgraph, ttm, tctx, tgp), lex, transcripts)
    return jb, tb, P, np.array(lengths, np.int32)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]
        assert g[2] == pytest.approx(w[2], rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("kind", ["noise", "integer_ties"])
def test_viterbi_align_matches_jax(batches, kind):
    jb, tb, P, nf = batches
    rng = np.random.RandomState(5)
    shape = (len(nf), int(nf.max()), P)
    if kind == "noise":
        ll = (rng.randn(*shape) * 4.0).astype(np.float32)
    else:
        ll = rng.randint(-3, 1, shape).astype(np.float32)
    for scale in (1.0, 0.1):
        want = jvit.viterbi_align(jb, ll, nf, scale)
        got = tvit.viterbi_align(tb, torch.from_numpy(ll), nf, scale,
                                 device="cpu")
        _same(got, want)
    assert got[-1] is None and all(r is not None for r in got[:-1])
    assert all(len(r[0]) == n for r, n in zip(got[:-1], nf))


def test_equal_align_matches_jax(batches):
    jb, tb, _P, nf = batches
    for seed in (0, 3):
        _same(tvit.equal_align(tb, nf, seed, device="cpu"),
              jvit.equal_align(jb, nf, seed))


def test_viterbi_align_needs_a_card_unless_asked_for_the_cpu(batches):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _jb, tb, P, nf = batches
    with pytest.raises(RuntimeError):
        tvit.viterbi_align(tb, np.zeros((len(nf), 10, P), np.float32), nf)
