"""Port parity: the LDA, MLLT and fMLLR transforms and SAT
(kaldi_tpu_torch.transform.{lda, mllt, fmllr, fmpe}, steps.sat) against
kaldi_tpu's on the CPU, on tests/test_sat_lda.py's SAT corpus and options
(chip_smoke.sat_corpus, the port's MFCC fed to both packages);
train_lda_mllt is held to JAX in tests/test_torch_lda_mllt.py.

- The host solves (`estimate_lda`, `update_mllt`, `estimate_fmllr`,
  `compose_transforms`) equal JAX's exactly on the same seeded statistics.
- The port's fMLLR and MLLT statistics, whose Gaussian posteriors come
  from the port's `_aligned_posteriors`, within 1e-5 of JAX's, relative to
  the same sums taken with every posterior 1 and absolute values; the
  affine transform within 1e-6 of the sum of the absolute terms behind
  each output.
- `train_sat` from the same monophone (JAX's, carried across) gives JAX's
  leaf and gaussian counts, words and WER, and meets test_sat_lda.py's
  contract (three speaker transforms, SAT <= SI and SAT < 25).
- `decode_fmllr` of a `SatModel` carried across by
  `params.sat_model_from_jax` gives JAX's words.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder as JBeam,
                                           BeamSearchOpts as JBeamOpts)
from kaldi_tpu.decoder.graph_pack import pack_graph as jpack_graph
from kaldi_tpu.fst.graph import make_hclg as jmake_hclg
from kaldi_tpu.fst.lang import Lexicon as JLexicon, prepare_lang as jprepare
from kaldi_tpu.lm.arpa import ArpaLm as JArpa, arpa_to_g as jarpa_to_g
from kaldi_tpu.steps import lda_mllt as jlda
from kaldi_tpu.steps import mono as jmono
from kaldi_tpu.steps import sat as jsat
from kaldi_tpu.steps.tdnn import align_with_gmm as jalign_with_gmm
from kaldi_tpu.transform import fmllr as jfmllr
from kaldi_tpu.transform import fmpe as jfmpe
from kaldi_tpu.transform import lda as jlda_t
from kaldi_tpu.transform import mllt as jmllt
from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu_torch.decoder.graph_pack import pack_graph
from kaldi_tpu_torch.fst.graph import make_hclg
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
from kaldi_tpu_torch.params import mono_model_from_jax, sat_model_from_jax
from kaldi_tpu_torch.steps import lda_mllt as tlda
from kaldi_tpu_torch.steps import sat as tsat
from kaldi_tpu_torch.transform import fmllr as tfmllr
from kaldi_tpu_torch.transform import fmpe as tfmpe
from kaldi_tpu_torch.transform import lda as tlda_t
from kaldi_tpu_torch.transform import mllt as tmllt

torch.set_num_threads(2)


def _langs():
    return (jprepare(JLexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                     num_sil_states=3),
            prepare_lang(Lexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                         num_sil_states=3))


@pytest.fixture(scope="module")
def sat():
    train, test, refs = cs.sat_corpus("cpu")
    jl, tl = _langs()
    jm = jmono.train_mono(jl, [(u, f, w) for (u, f, w, _s) in train],
                          jmono.MonoTrainOpts(**cs.SAT_LDA_MONO))
    js = jsat.train_sat(jl, train, jm, jsat.SatTrainOpts(**cs.SAT_SMALL))
    ts = tsat.train_sat(tl, train, mono_model_from_jax(jm, tl, "cpu"),
                        tsat.SatTrainOpts(**cs.SAT_SMALL))
    return dict(train=train, test=test, refs=refs, jl=jl, tl=tl, jm=jm,
                js=js, ts=ts)


# --- the host solves on seeded statistics ---

def _spd(rng, n, k):
    """k symmetric positive definite [n, n] matrices."""
    a = rng.randn(k, n, n)
    return a @ a.transpose(0, 2, 1) + n * np.eye(n)


def test_estimate_lda_equal():
    rng = np.random.RandomState(0)
    x = rng.randn(500, 12) @ rng.randn(12, 12)
    c = rng.randint(0, 7, 500)
    w = rng.rand(200)
    out = []
    for mod in (jlda_t, tlda_t):
        st = mod.LdaStats(7, 12)
        st.accumulate(x[:300], c[:300])
        st.accumulate(x[300:], c[300:], weights=w)
        out.append(mod.estimate_lda(st, 5))
    (ja, je), (ta, te) = out
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(te, je)
    assert ta.shape == (5, 13)


def test_update_mllt_equal():
    out = []
    for mod in (jmllt, tmllt):
        st = mod.MlltStats(6)
        st.G = _spd(np.random.RandomState(1), 6, 6) * 40.0
        st.beta = 400.0
        out.append(mod.update_mllt(st, num_iters=30))
        out.append(mod.mllt_objf(st, out[-1][0]))
    (jM, ji), jo, (tM, ti), to = out
    np.testing.assert_array_equal(tM, jM)
    assert ti == ji and to == jo


@pytest.mark.parametrize("case", ["identity-start", "init", "below-count"])
def test_estimate_fmllr_equal(case):
    rng = np.random.RandomState(2)
    D = 5
    K = rng.randn(D, D + 1) * 30.0
    G = _spd(rng, D + 1, D) * 50.0
    init = np.concatenate([np.eye(D) + rng.randn(D, D) * 0.05,
                           rng.randn(D, 1)], axis=1)
    out = []
    for mod in (jfmllr, tfmllr):
        st = mod.FmllrStats(D)
        st.beta, st.K, st.G = 300.0, K.copy(), G.copy()
        kw = {"identity-start": {}, "init": dict(init=init),
              "below-count": dict(min_count=1000.0)}[case]
        W, impr, count = mod.estimate_fmllr(st, **kw)
        out.append((W, impr, count, mod.fmllr_auxf(np.asarray(W, np.float64),
                                                   st)))
    (jW, ji, jc, ja), (tW, ti, tc, ta) = out
    np.testing.assert_array_equal(tW, jW)
    assert (ti, tc, ta) == (ji, jc, ja)
    assert tW.dtype == np.float32


def test_compose_transforms_equal():
    rng = np.random.RandomState(3)
    a, b = rng.randn(6, 7), rng.randn(6, 7)
    np.testing.assert_array_equal(tfmpe.compose_transforms(a, b),
                                  jfmpe.compose_transforms(a, b))


# --- the device parts against JAX ---

def _rel_to(got, want, scale):
    """max |got - want| / scale (scale > 0 where it counts)."""
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))
                        / np.maximum(scale, 1e-30)))


def test_fmllr_and_mllt_stats_match_jax(sat):
    """Both statistics over JAX's monophone alignments of the SAT corpus:
    the port's within 1e-5 of JAX's, relative to the same sums with each
    posterior 1 and the terms' absolute values (the posteriors within a
    pdf are what the GEMM's cancellation can move)."""
    jm = sat["jm"]
    tm = mono_model_from_jax(jm, sat["tl"], "cpu")
    utts = [(u, f, w) for (u, f, w, _s) in sat["train"]]
    aligned = jalign_with_gmm(jm, utts)
    D = jm.am.dim
    jf, tf = jfmllr.FmllrStats(D), tfmllr.FmllrStats(D)
    ones_f = jfmllr.FmllrStats(D)
    jmll, tmll = jmllt.MlltStats(D), tmllt.MlltStats(D)
    ones_g = np.zeros((D, D, D))
    for feats, pdfs in aligned:
        jf.accumulate_from_alignment(jm.am, feats, pdfs)
        tf.accumulate_from_alignment(tm.am, feats, pdfs)
        jlda.accumulate_mllt_from_alignment(jm.am, feats, pdfs, jmll)
        tlda.accumulate_mllt_from_alignment(tm.am, feats, pdfs, tmll)
        ones_f.add(cs.fmllr_term_scale(jm.am, feats, pdfs))
        ones_g += cs.mllt_term_scale(jm.am, feats, pdfs)
    assert tf.beta == pytest.approx(jf.beta, rel=1e-5)
    errs = {"fmllr K": _rel_to(tf.K, jf.K, ones_f.K),
            "fmllr G": _rel_to(tf.G, jf.G, ones_f.G),
            "mllt G": _rel_to(tmll.G, jmll.G, ones_g)}
    assert max(errs.values()) <= 1e-5, errs
    # the soft path: two pdfs per frame, weights summing to 1
    feats, pdfs = aligned[0]
    rng = np.random.RandomState(4)
    post = [[(int(p), 0.7), (int(rng.randint(jm.am.num_pdfs)), 0.3)]
            for p in pdfs]
    jp, tp = jfmllr.FmllrStats(D), tfmllr.FmllrStats(D)
    jp.accumulate_from_posteriors(jm.am, feats, post)
    tp.accumulate_from_posteriors(tm.am, feats, post)
    assert tp.beta == pytest.approx(jp.beta, rel=1e-6)
    assert _rel_to(tp.K, jp.K, np.abs(jp.K).max()) <= 1e-5
    assert _rel_to(tp.G, jp.G, np.abs(jp.G).max()) <= 1e-5


def test_posterior_bound_covers_a_loglike_shift():
    """chip_smoke's card-vs-CPU bound on the posterior-fed statistics,
    with a CPU AM whose mixture weights moved by ~1e-4 in place of the
    card's (the loglikes shift, the statistics' terms do not): the
    posteriors and statistics stay within it and the loglikes within 1e-5
    of their terms; moved means (terms that differ) break the bound."""
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
    from kaldi_tpu_torch.steps import mono, tdnn
    lang = cs.gmm_stack(cs.YESNO_LEXICON, cs.YESNO_ARPA)[0]
    train_d = cs.lda_corpus("cpu")[0][:8]
    m = mono.train_mono(lang, train_d, mono.MonoTrainOpts(**cs.SAT_LDA_MONO),
                        device="cpu")
    ali = tdnn.align_with_gmm(m, train_d)
    rng = np.random.RandomState(0)
    moved = [p.copy() for p in m.am.pdfs]
    for p in moved:
        w = p.weights * np.exp(rng.randn(p.num_gauss) * 1e-4)
        p.weights = w / w.sum()
    _st, errs = cs.posterior_stats_card_vs_cpu(
        m.am, AmDiagGmm(moved, "cpu"), ali)
    assert errs["shift"] > 0.0 and 0.0 < errs["at gamma"] < 1.0
    check = cs._Limits()
    cs.check_posterior_stats(check, "weights moved", errs)
    assert check.failed == []
    for p in moved:
        p.means = p.means * (1.0 + 1e-3)
    _st, errs = cs.posterior_stats_card_vs_cpu(
        m.am, AmDiagGmm(moved, "cpu"), ali)
    check = cs._Limits()
    cs.check_posterior_stats(check, "means moved", errs)
    assert any("over its bound" in f for f in check.failed)


def test_apply_affine_transform_matches_jax():
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 50, 13) * 4.0).astype(np.float32)
    W = rng.randn(13, 14)
    want = np.asarray(jfmllr.apply_affine_transform(x, W))
    got = tfmllr.apply_affine_transform(x, W)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert _rel_to(got.numpy(), want, cs.affine_term_scale(x, W)) <= 1e-6


def _decoder(model, side):
    """The padded beam decoder at test_sat_lda.py's beam over the yesno
    HCLG of `model`, of the JAX package (side "j") or the port ("t")."""
    if side == "j":
        g = jarpa_to_g(JArpa.parse(cs.YESNO_ARPA), model.lang.words)
        graph = jmake_hclg(model.lang, g, model.trans_model, model.ctx_dep,
                           self_loop_scale=0.1)
        return JBeam(jpack_graph(graph.fst, model.trans_model.id2pdf_array),
                     JBeamOpts(beam=16.0, max_active=256, acoustic_scale=0.1))
    g = arpa_to_g(ArpaLm.parse(cs.YESNO_ARPA), model.lang.words)
    graph = make_hclg(model.lang, g, model.trans_model, model.ctx_dep,
                      self_loop_scale=0.1)
    return BeamSearchDecoder(
        pack_graph(graph.fst, model.trans_model.id2pdf_array),
        BeamSearchOpts(beam=16.0, max_active=256, acoustic_scale=0.1),
        device=model.am.device)


def _words(lang, res):
    return [[lang.words.sym(w) for w in r[0]] if r else [] for r in res]


def test_train_sat_matches_jax(sat):
    js, ts = sat["js"], sat["ts"]
    assert sorted(ts.transforms) == sorted(js.transforms) == \
        ["s0", "s1", "s2"]
    assert ts.model.am.num_pdfs == js.model.am.num_pdfs
    assert ts.model.am.total_gauss == js.model.am.total_gauss
    test, refs = sat["test"], sat["refs"]
    wers = {}
    for side, model, mod in (("j", js, jsat), ("t", ts, tsat)):
        dec = _decoder(model.model, side)
        hyps = mod.decode_fmllr(model, dec, test, model.model.lang,
                                fmllr_min_count=50.0)
        feats, nf = cs.pad_batch([f for _u, f, _s in test])
        ll = (model.model.am.loglikes_np(feats) if side == "j"
              else model.model.am.loglikes(feats))
        si = _words(model.model.lang, dec.decode(ll, nf))
        sat_h = [[model.model.lang.words.sym(w) for w in hyps[u]]
                 for u, _f, _s in test]
        want = [refs[u] for u, _f, _s in test]
        wers[side] = (cs.wer(want, sat_h), cs.wer(want, si), sat_h)
    assert wers["t"] == wers["j"]
    w_sat, w_si, _h = wers["t"]
    assert w_sat <= w_si
    assert w_sat < 25.0, (w_sat, w_si)


def test_decode_fmllr_of_a_carried_model_matches_jax(sat):
    js = sat["js"]
    ts = sat_model_from_jax(js, sat["tl"], "cpu")
    for spk in js.transforms:
        np.testing.assert_array_equal(ts.transforms[spk], js.transforms[spk])
    test = sat["test"]
    jdec = _decoder(js.model, "j")
    tdec = _decoder(ts.model, "t")
    jh = jsat.decode_fmllr(js, jdec, test, sat["jl"], fmllr_min_count=50.0)
    th = tsat.decode_fmllr(ts, tdec, test, sat["tl"], fmllr_min_count=50.0)
    assert th == jh
    f = test[0][1]
    assert _rel_to(ts.transform("s0", f), np.asarray(js.transform("s0", f)),
                   cs.affine_term_scale(f, js.transforms["s0"])) <= 1e-6
