"""Port parity: fMPE (kaldi_tpu_torch.transform.fmpe), its posterior GMM
(steps.ubm) and fMMI training (steps.fmmi) against kaldi_tpu's, on the
CPU.

- `train_diag_ubm` on the yesno system's pooled training features: the
  same GMM exactly (host numpy in both).
- `Fmpe._h`, `apply`, `direct_differential` and `train_step` with the
  same GMM, projection and posteriors: exactly JAX's (host numpy; the
  differential reads the AM's pdfs as numpy DiagGmms in both). A JAX
  `Fmpe` carried across by `params.fmpe_from_jax` gives the same
  features.
- A whole fMMI run of each package (tests/test_fmmi.py's options, two
  iterations: one fMPE update and one EBW update) on 6 utterances from
  the same model, each on its own denominator lattices: the objective
  history within 1e-4 of JAX's, the same decoded words on the test set
  with fMPE features, and a projection that moved.
"""

import numpy as np
import pytest

import chip_smoke as cs
from kaldi_tpu.steps import fmmi as jfmmi
from kaldi_tpu.steps import ubm as jubm
from kaldi_tpu.transform import fmpe as jfmpe
from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.graph_pack import pack_graph
from kaldi_tpu_torch.params import diag_gmm_from_jax, fmpe_from_jax
from kaldi_tpu_torch.steps import fmmi as tfmmi
from kaldi_tpu_torch.steps import ubm as tubm
from kaldi_tpu_torch.transform import fmpe as tfmpe
from test_torch_lat_posteriors import build_system


@pytest.fixture(scope="module")
def system():
    """The yesno system, its lattices the port's (JAX's copies of them for
    JAX's side)."""
    return build_system(jax_decode=False)


def _pooled(system):
    return np.concatenate([f for _u, f, _w in system["train"]]) \
        .astype(np.float64)


@pytest.fixture(scope="module")
def ubms(system):
    x = _pooled(system)
    return (jubm.train_diag_ubm(x, jubm.DiagUbmTrainOpts(num_gauss=8,
                                                         num_iters=2)),
            tubm.train_diag_ubm(x, tubm.DiagUbmTrainOpts(num_gauss=8,
                                                         num_iters=2),
                                host_numpy=True))


def test_train_diag_ubm_equals_jax(ubms):
    j, t = ubms
    assert t.num_gauss == j.num_gauss == 8
    for f in ("weights", "means", "vars"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


def _fmpe_pair(ubms, seed: int):
    """The same Fmpe in both packages, with a random projection."""
    j, _t = ubms
    jf = jfmpe.Fmpe(j, j.dim, jfmpe.FmpeOptions(learning_rate=0.01))
    jf.M = np.random.RandomState(seed).randn(*jf.M.shape) * 0.01
    return jf, fmpe_from_jax(jf)


@pytest.mark.parametrize("seed", [0, 1])
def test_fmpe_equals_jax(system, ubms, seed):
    """_h, apply, direct_differential and train_step on utterances of the
    training set, with the MMI posteriors of their lattices."""
    jf, tf = _fmpe_pair(ubms, seed)
    assert tf.M.shape == jf.M.shape and tf.dim == jf.dim
    jam, tam = system["jmodel"].am, system["model"].am
    post_of = [p for p in _mmi_posts(system)]
    for b, (_u, f, _w) in enumerate(system["train"][:4]):
        np.testing.assert_array_equal(tf._h(f), jf._h(f))
        np.testing.assert_array_equal(tf.apply(f), jf.apply(f))
        fo = tf.apply(f)
        dj = jf.direct_differential(jam, fo, post_of[b])
        dt = tf.direct_differential(tam, fo, post_of[b])
        np.testing.assert_array_equal(dt, dj)
        assert np.abs(dt).max() > 0
        jf.train_step(f, dj)
        tf.train_step(f, dt)
        np.testing.assert_array_equal(tf.M, jf.M)


def _mmi_posts(system):
    """Each training utterance's MMI posteriors from its JAX lattice and a
    reference alignment (the lattice's best path)."""
    import copy
    from kaldi_tpu.lat import functions as jfun
    from kaldi_tpu.lat import posteriors as jpost
    tm = system["jmodel"].trans_model
    out = []
    for b, lat in enumerate(system["jlats"]):
        if lat is None:
            out.append([])
            continue
        lat = copy.deepcopy(lat)
        ali = jfun.lattice_best_path(lat)[1]
        jpost.rescore_lattice(lat, system["ll"][b], tm, 0.1)
        out.append(jpost.lattice_forward_backward_mmi(lat, ali, tm)[0])
    return out


def test_compose_transforms_equals_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(5, 6), rng.randn(5, 6)
    np.testing.assert_array_equal(tfmpe.compose_transforms(a, b),
                                  jfmpe.compose_transforms(a, b))


def test_whole_fmmi_run_equals_jax(system):
    """Two fMMI iterations (one fMPE and one EBW update) of each package
    from the same model on 6 utterances, each on its own lattices: the
    objective history within 1e-4 of JAX's, the same posterior GMM, a
    projection that moved, the same decoded words with each package's
    fMPE features and model."""
    s = system
    sil = {s["lang"].phones["SIL"]}
    utts = s["train"][:6]
    kw = dict(num_iters=2, lattice_beam=8.0, fmpe_gauss=8)
    jf, jam, jh = jfmmi.train_fmmi(
        s["jmodel"], s["jden"], utts, jfmmi.FmmiTrainOpts(
            fmpe=jfmpe.FmpeOptions(learning_rate=0.002), **kw),
        silence_phones=sil)
    stats: list = []
    tf, tam, th = tfmmi.train_fmmi(
        s["model"], s["den_graph"], utts, tfmmi.FmmiTrainOpts(
            fmpe=tfmpe.FmpeOptions(learning_rate=0.002), **kw),
        silence_phones=sil, iter_stats=stats)
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-4)
    assert np.abs(tf.M).max() > 0 and tam.device.type == "cpu"
    assert [st["iter"] for st in stats] == [0, 1]
    assert "fmpe" in stats[0] and "update" in stats[1]
    np.testing.assert_array_equal(tf.gmm.means,
                                  diag_gmm_from_jax(jf.gmm).means)
    feats, nf = cs.pad_batch([tf.apply(f).astype(np.float32)
                              for _u, f, _w in s["test"]])
    jfeats, _ = cs.pad_batch([jf.apply(f).astype(np.float32)
                              for _u, f, _w in s["test"]])
    dec = BeamSearchDecoder(pack_graph(s["den_graph"].fst,
                                       s["model"].trans_model.id2pdf_array),
                            BeamSearchOpts(beam=16.0, max_active=256,
                                           acoustic_scale=0.1), device="cpu")
    got = [r[0] if r else None for r in dec.decode(tam.loglikes_np(feats),
                                                   nf)]
    want = [r[0] if r else None for r in dec.decode(
        jam.loglikes_np(jfeats), nf)]
    assert got == want


@pytest.mark.slow
def test_fmmi_on_the_rm_like_tri_is_worse_than_its_base_in_jax_too():
    """The reference's own fault, ported as it is (about 5 min on the
    CPU): fMMI at tests/test_fmmi.py's options (4 iterations, 8 fMPE
    gaussians, learning rate 0.002) from tests/test_rm_like_recipe.py's
    triphone model diverges in JAX: the MMI objective per frame climbs
    far above 0 on the fixed denominator lattices while the test WER rises
    well above the triphone's own, which PARITY.md:34 would not allow
    (it pins fMMI on the yesno system of test_fmmi.py, where it holds).
    chip_smoke.py phase 22 (a) reports the port's run of the same. The
    features are the port's MFCCs on the CPU."""
    from kaldi_tpu.decoder.beam_search import BeamSearchOpts as JOpts
    from kaldi_tpu.decoder.dense import make_decoder as jmake_decoder
    from kaldi_tpu.decoder.graph_pack import pack_graph as jpack_graph
    from kaldi_tpu.fst.graph import make_hclg as jmake_hclg
    from kaldi_tpu.fst.lang import Lexicon as JLexicon
    from kaldi_tpu.fst.lang import prepare_lang as jprepare
    from kaldi_tpu.lm.arpa import ArpaLm as JArpa, arpa_to_g as jarpa_to_g
    from kaldi_tpu.steps.deltas import DeltasTrainOpts, train_deltas
    from kaldi_tpu.steps.mono import MonoTrainOpts, train_mono
    from kaldi_tpu.utils.wer import compute_wer
    rng = np.random.RandomState(17)
    tr, te = cs.rm_corpus(rng, 42), cs.rm_corpus(rng, 12)
    train = [(f"tr{i}", cs.mfcc_deltas(w, "cpu"), ws)
             for i, (ws, w) in enumerate(tr)]
    test = [(f"te{i}", cs.mfcc_deltas(w, "cpu"), ws)
            for i, (ws, w) in enumerate(te)]
    lang = jprepare(JLexicon.parse(cs.RM_LEXICON), ["SIL"], "SIL",
                    num_sil_states=3)
    g = jarpa_to_g(JArpa.parse(cs.rm_unigram_arpa()), lang.words)
    mono = train_mono(lang, train, MonoTrainOpts(**cs.RM_MONO))
    tri = train_deltas(lang, train, mono, DeltasTrainOpts(**cs.RM_TRI))
    graph = jmake_hclg(lang, g, tri.trans_model, tri.ctx_dep,
                       self_loop_scale=0.1)
    dec = jmake_decoder(jpack_graph(graph.fst, tri.trans_model.id2pdf_array),
                        JOpts(beam=14.0, max_active=1024, acoustic_scale=0.1))

    def wer(am, transform):
        fb, nf = cs.pad_batch([transform(f).astype(np.float32)
                               for _u, f, _w in test])
        res = dec.decode(am.loglikes_np(fb), nf)
        return compute_wer(
            {u: w for u, _f, w in test},
            {u: [lang.words.sym(x) for x in r[0]] if r else []
             for (u, _f, _w), r in zip(test, res)}).wer

    fm, am, hist = jfmmi.train_fmmi(
        tri, graph, train, jfmmi.FmmiTrainOpts(
            fmpe=jfmpe.FmpeOptions(learning_rate=0.002), **cs.RM_FMMI),
        silence_phones={lang.phones["SIL"]})
    base = wer(tri.am, lambda f: f)
    assert base <= 10.0
    assert max(hist) > 0.3 and wer(am, fm.apply) > base + 10.0


@pytest.mark.slow
def test_fmmi_on_the_ports_yesno_mono_is_worse_than_its_base_in_jax_too(
        system):
    """The reference's own fault on tests/test_fmmi.py's setup: on this
    file's yesno system (the port's monophone, carried to JAX; it differs
    from the one JAX trains in tests/test_discriminative.py only by EM
    drift) JAX's fMMI at test_fmmi.py's options raises the test WER above
    its base, which PARITY.md:34 would not allow (on JAX's own monophone
    it ties its base). About 40 s on the CPU."""
    from kaldi_tpu.decoder.beam_search import BeamSearchOpts as JOpts
    from kaldi_tpu.decoder.dense import make_decoder as jmake_decoder
    from kaldi_tpu.decoder.graph_pack import pack_graph as jpack_graph
    s = system
    lang = s["jlang"]
    fm, am, _hist = jfmmi.train_fmmi(
        s["jmodel"], s["jden"], s["train"][:10], jfmmi.FmmiTrainOpts(
            fmpe=jfmpe.FmpeOptions(learning_rate=0.002), **cs.RM_FMMI),
        silence_phones={lang.phones["SIL"]})
    dec = jmake_decoder(jpack_graph(s["jden"].fst,
                                    s["jmodel"].trans_model.id2pdf_array),
                        JOpts(beam=16.0, max_active=256, acoustic_scale=0.1))

    def wer(am_, transform):
        fb, nf = cs.pad_batch([transform(f).astype(np.float32)
                               for _u, f, _w in s["test"]])
        res = dec.decode(am_.loglikes_np(fb), nf)
        return cs.wer([w for _u, _f, w in s["test"]],
                      [[lang.words.sym(x) for x in r[0]] if r else []
                       for r in res])

    assert wer(am, fm.apply) > wer(s["jmodel"].am, lambda f: f)
