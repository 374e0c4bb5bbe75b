"""Port parity: kaldi_tpu_torch.decoder.biglm against kaldi_tpu's, on the
CPU.

tests/test_ubm_biglm.py:50-138's setup (a two-word lexicon, a unigram G
swapped for a bigram ConstArpaLm) built by both packages: the port's
`decode_biglm_exact` (JAX's host oracle, copied) equals JAX's exactly,
words and cost; the port's `decode_biglm` (the padded decoder's lattices,
then the old G out and the new LM in) equals JAX's rescoring pipeline run
on the same lattices carried into JAX's classes, exactly; and both of
test_ubm_biglm.py's contracts hold on the port (the swap flips the best
path with the big LM's exact cost; the fast path equals the exact oracle,
words equal, cost within 1e-3).
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder import biglm as jbiglm
from kaldi_tpu.decoder.graph_pack import pack_graph as jpack
from kaldi_tpu.fst.graph import make_hclg as jmake_hclg
from kaldi_tpu.fst.lang import Lexicon as JLexicon, prepare_lang as jprepare
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.lat import functions as jfun
from kaldi_tpu.lm.arpa import ArpaLm as JArpa, arpa_to_g as jarpa_to_g
from kaldi_tpu.lm.const_arpa import (ConstArpaLm as JConst,
                                     lattice_lmrescore_const_arpa as jresc)
from kaldi_tpu.tree.context_dep import MonophoneContextDependency as JCtx
from kaldi_tpu_torch.decoder import biglm
from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.graph_pack import pack_graph
from kaldi_tpu_torch.fst.fst import SymbolTable
from kaldi_tpu_torch.fst.graph import make_hclg
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.lat.functions import (compose_lattice_with_lm,
                                           lattice_best_path)
from kaldi_tpu_torch.lat.generate import decode_to_lattices
from kaldi_tpu_torch.lat.lattice import Lattice
from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
from kaldi_tpu_torch.lm.const_arpa import (ConstArpaLm,
                                           lattice_lmrescore_const_arpa)
from kaldi_tpu_torch.tree.context_dep import MonophoneContextDependency
from test_torch_lat_posteriors import lattice_to_jax

torch.set_num_threads(2)

UNI = ("\\data\\\nngram 1=4\n\n\\1-grams:\n-0.30103\ta\n-0.30103\tb\n"
       "-99\t<s>\n-0.1\t</s>\n\n\\end\\\n")
BIG = ("\\data\\\nngram 1=4\nngram 2=2\n\n\\1-grams:\n-0.5\ta -0.1\n"
       "-0.5\tb -0.1\n-99\t<s> -0.1\n-0.5\t</s>\n\n\\2-grams:\n"
       "-0.05\tb a\n-3.0\ta b\n\n\\end\\\n")
LATTICE_BEAM = 100.0


def _side(lex_cls, prep, ctx_cls, tm_cls, arpa_cls, to_g, const_cls, hclg,
          pack):
    lang = prep(lex_cls.parse("a AY\nb BE"), ["SIL"], "SIL",
                num_sil_states=1, num_nonsil_states=2)
    ctx = ctx_cls.from_topo(lang.topo)
    tm = tm_cls(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    g = to_g(arpa_cls.parse(UNI), lang.words)
    clm = const_cls(arpa_cls.parse(BIG), lang.words)
    graph = hclg(lang, g, tm, ctx, self_loop_scale=0.1)
    return dict(lang=lang, tm=tm, g=g, clm=clm,
                packed=pack(graph.fst, tm.id2pdf_array))


@pytest.fixture(scope="module")
def setup():
    t = _side(Lexicon, prepare_lang, MonophoneContextDependency,
              TransitionModel, ArpaLm, arpa_to_g, ConstArpaLm, make_hclg,
              pack_graph)
    j = _side(JLexicon, jprepare, JCtx, JTm, JArpa, jarpa_to_g, JConst,
              jmake_hclg, jpack)
    rng = np.random.RandomState(4)
    B, T, P = 3, 24, t["tm"].num_pdfs
    ll = (rng.randn(B, T, P) * 2).astype(np.float32)
    nf = np.array([24, 18, 24], np.int32)
    dec = BeamSearchDecoder(t["packed"], BeamSearchOpts(
        beam=1e9, max_active=128, acoustic_scale=0.1), device="cpu")
    return dict(t=t, j=j, ll=ll, nf=nf, dec=dec)


def test_exact_oracle_equals_jax(setup):
    t, j = setup["t"], setup["j"]
    for kw in ({}, dict(lm_scale=0.5, acoustic_scale=0.2)):
        got = biglm.decode_biglm_exact(
            t["packed"], setup["ll"], setup["nf"], t["g"],
            t["lang"].words["#0"], t["clm"], **kw)
        want = jbiglm.decode_biglm_exact(
            j["packed"], setup["ll"], setup["nf"], j["g"],
            j["lang"].words["#0"], j["clm"], **kw)
        assert got == want


def test_decode_biglm_equals_jax_rescoring(setup):
    """The port's decode_biglm == JAX's compose + rescore + best path on
    the port decoder's own lattices, exactly; and == the exact oracle
    (test_ubm_biglm.py:92's contract): words equal, cost within 1e-3."""
    t, j = setup["t"], setup["j"]
    ll, nf = setup["ll"], setup["nf"]
    fast = biglm.decode_biglm(setup["dec"], ll, nf, t["g"],
                              t["lang"].words["#0"], t["clm"],
                              lattice_beam=LATTICE_BEAM)
    lats = decode_to_lattices(setup["dec"], ll, nf,
                              lattice_beam=LATTICE_BEAM)
    exact = biglm.decode_biglm_exact(t["packed"], ll, nf, t["g"],
                                     t["lang"].words["#0"], t["clm"])
    for b, lat in enumerate(lats):
        assert (fast[b] is None) == (lat is None) == (exact[b] is None)
        if lat is None:
            continue
        no_old = jfun.compose_lattice_with_lm(
            lattice_to_jax(lat), j["g"], j["lang"].words["#0"],
            lm_scale=-1.0)
        res = jfun.lattice_best_path(jresc(no_old, j["clm"], 1.0))
        assert fast[b] == (res[0], res[2]), b
        assert fast[b][0] == exact[b][0], b
        assert fast[b][1] == pytest.approx(exact[b][1], abs=1e-3)


def test_swap_changes_best_path():
    """test_ubm_biglm.py:50's contract on the port: swapping a unigram G
    for a bigram that favours the other path flips the decision, with the
    big LM's exact cost."""
    words = SymbolTable()
    for s in ("a", "b", "#0"):
        words.add(s)
    A, B = words["a"], words["b"]
    g_uni = arpa_to_g(ArpaLm.parse(UNI), words)
    big = ArpaLm.parse(BIG)
    clm = ConstArpaLm(big, words)
    uni_w = 0.30103 * np.log(10)
    lat = Lattice()
    s0, s1, s2, s3, s4 = (lat.add_state() for _ in range(5))
    lat.start = s0
    eos_w = 0.1 * np.log(10)
    lat.add_arc(s0, 1, A, uni_w, 0.40, s1)
    lat.add_arc(s1, 2, B, uni_w, 0.40, s2)
    lat.add_arc(s0, 3, B, uni_w, 0.45, s3)
    lat.add_arc(s3, 4, A, uni_w, 0.45, s4)
    lat.set_final(s2, eos_w)
    lat.set_final(s4, eos_w)
    assert lattice_best_path(lat)[0] == [A, B]
    no_old = compose_lattice_with_lm(lat, g_uni, words["#0"], lm_scale=-1.0)
    res = lattice_best_path(lattice_lmrescore_const_arpa(no_old, clm, 1.0))
    assert res[0] == [B, A]
    assert res[2] == pytest.approx(0.9 - big.score_sentence(["b", "a"]),
                                   abs=1e-4)
