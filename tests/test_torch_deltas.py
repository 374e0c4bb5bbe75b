"""Port parity: tied-triphone training (kaldi_tpu_torch.steps.deltas)
against kaldi_tpu's on tests/test_triphone_e2e.py's corpus and options,
on the CPU. Both packages get the same numpy features (the port's MFCC)
and start from the same monophone model (JAX's, carried across by
`params.mono_model_from_jax`).

- `build_triphone_tree`: the tree node for node, `id2pdf`, the transition
  tuples and the leaf statistics equal JAX's, and so does the AM that
  `init_am_from_leaf_stats` makes of them.
- One EM iteration from the same triphone model (JAX's, carried across by
  `params.tri_model_from_jax`): statistics and updated parameters within
  1e-5 (a variance within 1e-5 of its second moment), identical
  alignments, and the loglikes within 1e-5 of the sum of absolute terms
  of their GEMM (`chip_smoke.gmm_term_scale`): MFCC loglikes of narrow
  triphone gaussians cancel, down to some 1e-4 relative here.
- A whole `train_deltas`, each package on its own: the same leaf and
  gaussian counts, identical decoded words and WER 0 for both, as
  test_triphone_e2e.py asks. The parameters themselves drift apart over
  EM (ROADMAP §3 traps) and are not compared.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder as JBeam,
                                           BeamSearchOpts as JBeamOpts)
from kaldi_tpu.decoder.graph_pack import pack_graph as jpack_graph
from kaldi_tpu.decoder.viterbi import viterbi_align as jviterbi_align
from kaldi_tpu.fst.graph import make_hclg as jmake_hclg
from kaldi_tpu.fst.lang import Lexicon as JLexicon, prepare_lang as jprepare
from kaldi_tpu.lm.arpa import ArpaLm as JArpa, arpa_to_g as jarpa_to_g
from kaldi_tpu.steps import deltas as jdeltas
from kaldi_tpu.steps import mono as jmono
from kaldi_tpu.utils.wer import compute_wer as jcompute_wer
from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu_torch.decoder.graph_pack import pack_graph
from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.fst.graph import make_hclg
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
from kaldi_tpu_torch.params import mono_model_from_jax, tri_model_from_jax
from kaldi_tpu_torch.steps import deltas as tdeltas
from kaldi_tpu_torch.steps import mono as tmono
from kaldi_tpu_torch.utils.wer import compute_wer
from test_torch_tree import assert_trees_equal

torch.set_num_threads(2)

MONO = dict(num_iters=10, totgauss=40, max_iter_inc=6,
            realign_iters=tuple(range(1, 10)))
TRI = dict(num_iters=15, totgauss=100, max_iter_inc=10, num_leaves=25,
           tree_thresh=20.0, realign_iters=(2, 4, 6, 8, 10, 12))


@pytest.fixture(scope="module")
def tri():
    rng = np.random.RandomState(11)
    feat = lambda w: cs.mfcc_deltas(w, "cpu")       # noqa: E731
    train, test = cs.tri_corpus(rng, 30, feat), cs.tri_corpus(rng, 8, feat)
    jl = jprepare(JLexicon.parse(cs.TRI_LEXICON), ["SIL"], "SIL",
                  num_sil_states=3)
    tl = prepare_lang(Lexicon.parse(cs.TRI_LEXICON), ["SIL"], "SIL",
                      num_sil_states=3)
    jm = jmono.train_mono(jl, train, jmono.MonoTrainOpts(**MONO))
    jt = jdeltas.train_deltas(jl, train, jm, jdeltas.DeltasTrainOpts(**TRI))
    tt = tdeltas.train_deltas(tl, train, mono_model_from_jax(jm, tl, "cpu"),
                              tdeltas.DeltasTrainOpts(**TRI))
    return dict(train=train, test=test, jl=jl, tl=tl, jm=jm, jt=jt, tt=tt)


def test_build_triphone_tree_matches_jax(tri):
    jo, to = jdeltas.DeltasTrainOpts(**TRI), tdeltas.DeltasTrainOpts(**TRI)
    jc, jtm, jls = jdeltas.build_triphone_tree(tri["jl"], tri["jm"],
                                               tri["train"], jo)
    tm = mono_model_from_jax(tri["jm"], tri["tl"], "cpu")
    tc, ttm, tls = tdeltas.build_triphone_tree(tri["tl"], tm, tri["train"],
                                               to)
    assert (tc.context_width, tc.central_position, tc.num_pdfs) == \
        (jc.context_width, jc.central_position, jc.num_pdfs)
    assert jc.num_pdfs > tri["jm"].am.num_pdfs
    assert_trees_equal(jc.event_map, tc.event_map)
    assert ttm.tuples == jtm.tuples
    np.testing.assert_array_equal(ttm.id2pdf_array, jtm.id2pdf_array)
    for a, b in zip(jls, tls):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.count == b.count
            np.testing.assert_array_equal(a.x, b.x)
            np.testing.assert_array_equal(a.x2, b.x2)
    jam = jdeltas.init_am_from_leaf_stats(jls, 39)
    tam = tdeltas.init_am_from_leaf_stats(tls, 39, "cpu")
    assert tam.device.type == "cpu"
    for a, b in zip(jam.pdfs, tam.pdfs):
        for f in ("weights", "means", "vars"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def _em_iteration(jm, tm, utts, target, stat_rel):
    """One EM iteration of each package from models that agree: loglikes
    within 1e-5 of their GEMM terms' magnitude, identical alignments, the
    statistics within `stat_rel` of the same sums over each pdf's frames
    at weight 1, then the update. -> the worst statistic's share."""
    jb, feats, nf = _jax_batch(jm, utts)
    tb, tfeats, tnf = tmono.compile_and_pad(tm.lang, tm.trans_model,
                                            tm.ctx_dep, utts, 1.0, 0.1)
    np.testing.assert_array_equal(tfeats, feats)
    jll = jm.am.loglikes_np(feats)
    tll = tm.am.loglikes(feats)
    # MFCC loglikes cancel: each is held to 1e-5 of its GEMM terms' sum
    assert np.all(np.abs(tll.numpy() - jll)
                  <= 1e-5 * cs.gmm_term_scale(tm.am, feats))
    ja = jviterbi_align(jb, jll, nf, 0.1)
    ta = viterbi_align(tb, tll, nf, 0.1, device="cpu")
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a[0], b[0])
    jacc, jcounts, jn = jmono._accumulate(jm, feats, nf, ja)
    tacc, tcounts, tn = tmono._accumulate(tm, feats, nf, ta)
    assert jn == tn == len(nf)
    np.testing.assert_array_equal(jcounts, tcounts)
    assert tacc.tot_like == pytest.approx(jacc.tot_like, rel=1e-5)
    # the loglikes' error moves posterior mass between the gaussians of
    # one pdf: each statistic is held to a share of the same sum over all
    # the pdf's frames at weight 1 (count, sum |x|, sum x^2)
    scales = pdf_frame_sums(feats, nf, ja, jm.trans_model.id2pdf_array,
                            jm.am.num_pdfs)
    worst = 0.0
    for p, (a, b) in enumerate(zip(jacc.accs, tacc.accs)):
        for f, scale in zip(("occ", "mean_acc", "var_acc"), scales):
            err = np.abs(getattr(b, f) - getattr(a, f))
            worst = max(worst, float(np.max(err / np.maximum(scale[p],
                                                             1e-300))))
    assert worst <= stat_rel, worst
    jdeltas._update(jm, jacc, jcounts, jdeltas.DeltasTrainOpts(**TRI), target)
    tdeltas._update(tm, tacc, tcounts, tdeltas.DeltasTrainOpts(**TRI), target)
    return worst


def test_em_iterations_from_the_tree_match_jax(tri):
    """train_deltas' first two EM iterations from the tree's one-gaussian
    init (JAX's tree and AM, carried across): statistics within 1e-5 of
    their pdfs' frame sums, then the updated parameters within 1e-5
    relative (a variance within 1e-5 of its second moment)."""
    jc, jtm, jls = jdeltas.build_triphone_tree(
        tri["jl"], tri["jm"], tri["train"], jdeltas.DeltasTrainOpts(**TRI))
    jm = jmono.MonoModel(jdeltas.init_am_from_leaf_stats(jls, 39), jtm, jc,
                         tri["jl"])
    tm = tri_model_from_jax(jm, tri["tl"], "cpu")
    for target in (jm.am.total_gauss + 40, jm.am.total_gauss + 80):
        _em_iteration(jm, tm, tri["train"], target, 1e-5)
        assert tm.am.total_gauss == jm.am.total_gauss > jm.am.num_pdfs
        for a, b in zip(jm.am.pdfs, tm.am.pdfs):
            np.testing.assert_allclose(b.weights, a.weights, rtol=1e-5)
            np.testing.assert_allclose(b.means, a.means, rtol=1e-5,
                                       atol=1e-6)
            assert np.all(np.abs(b.vars - a.vars)
                          <= 1e-5 * (a.vars + a.means ** 2))
        np.testing.assert_allclose(tm.trans_model.log_probs[1:],
                                   jm.trans_model.log_probs[1:], rtol=1e-6)


def test_em_iteration_at_the_trained_model(tri):
    """One EM iteration at JAX's trained triphone model, whose narrowest
    gaussians have variances near 1e-5: the f32 loglikes of the two
    packages (each its own GEMM order) differ by up to some 5e-7 of their
    terms' magnitude, 1e-3 absolute and more, and so the posteriors of
    gaussians of one pdf that nearly tie. The alignments stay identical;
    the statistics are held to 2e-4 of their pdfs' frame sums (9e-5 seen
    on the CPU)."""
    tm = tri_model_from_jax(tri["jt"], tri["tl"], "cpu")
    jm = jmono.MonoModel(tri["jt"].am.copy(), _jax_tm(tri),
                         tri["jt"].ctx_dep, tri["jl"])     # a copy to update
    worst = _em_iteration(jm, tm, tri["train"], jm.am.total_gauss + 10, 2e-4)
    assert worst > 0.0
    assert tm.am.total_gauss == jm.am.total_gauss


def pdf_frame_sums(feats, nf, align, tid2pdf, num_pdfs):
    """Per pdf, over the frames aligned to it: (count [P], sum |x| [P, D],
    sum x^2 [P, D]) in f64."""
    D = feats.shape[-1]
    n = np.zeros(num_pdfs)
    s1, s2 = np.zeros((num_pdfs, D)), np.zeros((num_pdfs, D))
    for b, res in enumerate(align):
        pdfs = tid2pdf[res[0][: nf[b]]]
        x = feats[b, : nf[b]].astype(np.float64)
        np.add.at(n, pdfs, 1.0)
        np.add.at(s1, pdfs, np.abs(x))
        np.add.at(s2, pdfs, x * x)
    return n, s1, s2


def _jax_tm(tri):
    tm = jdeltas.transition_model_from_tree(tri["jl"], tri["jt"].ctx_dep)
    tm.load_log_probs(tri["jt"].trans_model.log_probs.copy())
    return tm


def _jax_batch(m, utts):
    comp = jmono.TrainingGraphCompiler(m.lang, m.trans_model, m.ctx_dep,
                                       1.0, 0.1)
    feats, nf = cs.pad_batch([f for _u, f, _w in utts])
    return (jmono.pack_graphs([comp.compile_transcript(w)
                               for _u, _f, w in utts],
                              m.trans_model.id2pdf_array), feats, nf)


def decode_words(model, test, side: str):
    """Words of `test` through the model's HCLG and the padded beam
    decoder at test_triphone_e2e.py's beam, in the JAX package (side "j")
    or the port ("t") -> (hyps, WER)."""
    feats, nf = cs.pad_batch([f for _u, f, _w in test])
    if side == "j":
        g = jarpa_to_g(JArpa.parse(cs.TRI_ARPA), model.lang.words)
        graph = jmake_hclg(model.lang, g, model.trans_model, model.ctx_dep,
                           self_loop_scale=0.1)
        dec = JBeam(jpack_graph(graph.fst, model.trans_model.id2pdf_array),
                    JBeamOpts(beam=200.0, max_active=512, acoustic_scale=0.1))
        res = dec.decode(model.am.loglikes_np(feats), nf)
        wer_of = jcompute_wer
    else:
        g = arpa_to_g(ArpaLm.parse(cs.TRI_ARPA), model.lang.words)
        graph = make_hclg(model.lang, g, model.trans_model, model.ctx_dep,
                          self_loop_scale=0.1)
        dec = BeamSearchDecoder(
            pack_graph(graph.fst, model.trans_model.id2pdf_array),
            BeamSearchOpts(beam=200.0, max_active=512, acoustic_scale=0.1),
            device=model.am.device)
        res = dec.decode(model.am.loglikes(feats), nf)
        wer_of = compute_wer
    hyps = {u: [model.lang.words.sym(w) for w in r[0]] if r else []
            for (u, _f, _w), r in zip(test, res)}
    return hyps, wer_of({u: w for u, _f, w in test}, hyps).wer


def test_train_deltas_matches_jax(tri):
    jt, tt = tri["jt"], tri["tt"]
    assert tt.ctx_dep.num_pdfs == jt.ctx_dep.num_pdfs == tt.am.num_pdfs
    assert tt.am.total_gauss == jt.am.total_gauss
    assert_trees_equal(jt.ctx_dep.event_map, tt.ctx_dep.event_map)
    jh, jwer = decode_words(jt, tri["test"], "j")
    th, twer = decode_words(tt, tri["test"], "t")
    assert th == jh
    assert jwer == twer == 0.0


def test_train_deltas_reports_each_iteration(tri):
    stats = []
    tdeltas.train_deltas(
        tri["tl"], tri["train"][:6],
        mono_model_from_jax(tri["jm"], tri["tl"], "cpu"),
        tdeltas.DeltasTrainOpts(**dict(TRI, num_iters=4,
                                       realign_iters=(2,))),
        iter_stats=stats)
    assert [s["iter"] for s in stats] == [1, 2, 3]
    assert set(stats[0]) >= {"tree", "loglikes", "align", "accumulate",
                             "update"}
    assert "loglikes" in stats[1] and "loglikes" not in stats[2]
