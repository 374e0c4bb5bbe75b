"""Port parity: flat-start monophone training (kaldi_tpu_torch.steps.mono)
against kaldi_tpu's on the yesno corpus, on the CPU, and the port's
`recipe-yesno` command.

- One EM iteration from the same model (a JAX model carried across with
  `params.mono_model_from_jax`): log-likelihoods, the per-pdf statistics
  and tot_like within rtol 1e-5 and identical alignments; the updated
  weights and means within rtol 1e-5, and each variance within 1e-5 of
  its second moment var + mean^2 (a variance is E[x^2] - mean^2: the
  cancellation leaves it the second moment's error, not its own).
- `train_mono` with tests/test_yesno_e2e.py's options (12 iterations,
  totgauss 60), each package on its own: the same number of gaussians,
  identical decoded words and WER 0 for both, and the training frames'
  mean best-pdf log-likelihood within 1e-3 relative. The
  parameters themselves are not held close: EM over split gaussians
  amplifies last-bit differences in exp and log from one iteration to
  the next, by orders of magnitude over the run even when both packages
  are fed the same alignments.
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
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.lm.arpa import ArpaLm as JArpa, arpa_to_g as jarpa_to_g
from kaldi_tpu.steps import mono as jmono
from kaldi_tpu.utils.wer import compute_wer as jcompute_wer
from kaldi_tpu_torch import cli
from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu_torch.decoder.graph_pack import pack_graph
from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.fst.graph import make_hclg
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
from kaldi_tpu_torch.params import mono_model_from_jax
from kaldi_tpu_torch.steps import mono as tmono
from kaldi_tpu_torch.utils.wer import compute_wer

torch.set_num_threads(2)

OPTS = dict(num_iters=12, totgauss=60, max_iter_inc=8,
            realign_iters=tuple(range(1, 12)))


def _corpus(rng, n):
    out = []
    for i in range(n):
        ws = [rng.choice(["YES", "NO"]) for _ in range(rng.randint(2, 6))]
        out.append((f"u{i}", cs.mfcc_deltas(cs.yesno_synth(ws, rng), "cpu"),
                    ws))
    return out


@pytest.fixture(scope="module")
def yesno():
    rng = np.random.RandomState(42)
    train, test = _corpus(rng, 24), _corpus(rng, 8)
    jlang = jprepare(JLexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                     num_sil_states=3)
    tlang = prepare_lang(Lexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                         num_sil_states=3)
    jm = jmono.train_mono(jlang, train, jmono.MonoTrainOpts(**OPTS))
    tm = tmono.train_mono(tlang, train, tmono.MonoTrainOpts(**OPTS),
                          device="cpu")
    return dict(train=train, test=test, jlang=jlang, tlang=tlang, jm=jm,
                tm=tm)


def _jax_copy(model):
    tm = JTm(model.lang.topo, lambda ph, pc: model.ctx_dep.compute([ph], pc))
    tm.load_log_probs(model.trans_model.log_probs.copy())
    return jmono.MonoModel(model.am.copy(), tm, model.ctx_dep, model.lang)


def test_one_em_iteration_matches_jax(yesno):
    feats, nf = cs.pad_batch([f for _u, f, _w in yesno["train"]])
    jm = _jax_copy(yesno["jm"])
    tm = mono_model_from_jax(yesno["jm"], yesno["tlang"], device="cpu")
    assert tm.am.total_gauss == jm.am.total_gauss > jm.am.num_pdfs
    comp = jmono.TrainingGraphCompiler(jm.lang, jm.trans_model, jm.ctx_dep,
                                       1.0, 0.1)
    jb = jmono.pack_graphs([comp.compile_transcript(w)
                            for _u, _f, w in yesno["train"]],
                           jm.trans_model.id2pdf_array)
    tcomp = tmono.TrainingGraphCompiler(tm.lang, tm.trans_model, tm.ctx_dep,
                                        1.0, 0.1)
    tb = tmono.pack_graphs([tcomp.compile_transcript(w)
                            for _u, _f, w in yesno["train"]],
                           tm.trans_model.id2pdf_array)
    jll = jm.am.loglikes_np(feats)
    tll = tm.am.loglikes(feats)
    np.testing.assert_allclose(tll.numpy(), jll, rtol=1e-5, atol=1e-5)
    ja = jviterbi_align(jb, jll, nf, 0.1)
    ta = viterbi_align(tb, tll, nf, 0.1, device="cpu")
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a[0], b[0])
    jacc, jcounts, jn = jmono._accumulate(jm, feats, nf, ja)
    tacc, tcounts, tn = tmono._accumulate(tm, feats, nf, ta)
    assert jn == tn == len(nf)
    np.testing.assert_array_equal(jcounts, tcounts)
    assert tacc.tot_like == pytest.approx(jacc.tot_like, rel=1e-5)
    assert tacc.tot_frames == jacc.tot_frames
    for a, b in zip(jacc.accs, tacc.accs):
        for f in ("occ", "mean_acc", "var_acc"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
    jo, to = jmono.MonoTrainOpts(**OPTS), tmono.MonoTrainOpts(**OPTS)
    target = jm.am.total_gauss + 6
    jmono._update(jm, jacc, jcounts, jo, target)
    tmono._update(tm, tacc, tcounts, to, target)
    assert tm.am.total_gauss == jm.am.total_gauss == target
    for a, b in zip(jm.am.pdfs, tm.am.pdfs):
        np.testing.assert_allclose(b.weights, a.weights, rtol=1e-5)
        np.testing.assert_allclose(b.means, a.means, rtol=1e-5, atol=1e-6)
        # a variance is E[x^2] - mean^2: its error is the second moment's
        assert np.all(np.abs(b.vars - a.vars)
                      <= 1e-5 * (a.vars + a.means ** 2))
    np.testing.assert_allclose(tm.trans_model.log_probs[1:],
                               jm.trans_model.log_probs[1:], rtol=1e-6)


def _decode(yesno, side):
    m = yesno[side + "m"]
    feats, nf = cs.pad_batch([f for _u, f, _w in yesno["test"]])
    if side == "j":
        g = jarpa_to_g(JArpa.parse(cs.YESNO_ARPA), m.lang.words)
        graph = jmake_hclg(m.lang, g, m.trans_model, m.ctx_dep,
                           self_loop_scale=0.1)
        dec = JBeam(jpack_graph(graph.fst, m.trans_model.id2pdf_array),
                    JBeamOpts(beam=16.0, max_active=256, acoustic_scale=0.1))
        res = dec.decode(m.am.loglikes_np(feats), nf)
        wer_of = jcompute_wer
    else:
        g = arpa_to_g(ArpaLm.parse(cs.YESNO_ARPA), m.lang.words)
        graph = make_hclg(m.lang, g, m.trans_model, m.ctx_dep,
                          self_loop_scale=0.1)
        dec = BeamSearchDecoder(
            pack_graph(graph.fst, m.trans_model.id2pdf_array),
            BeamSearchOpts(beam=16.0, max_active=256, acoustic_scale=0.1),
            device="cpu")
        res = dec.decode(m.am.loglikes(feats), nf)
        wer_of = compute_wer
    hyps = {u: [m.lang.words.sym(w) for w in r[0]]
            for (u, _f, _w), r in zip(yesno["test"], res)}
    refs = {u: w for u, _f, w in yesno["test"]}
    return hyps, wer_of(refs, hyps).wer


def test_train_mono_matches_jax(yesno):
    jm, tm = yesno["jm"], yesno["tm"]
    assert tm.am.total_gauss == jm.am.total_gauss
    assert tm.am.num_pdfs == jm.am.num_pdfs
    for a, b in zip(jm.am.pdfs, tm.am.pdfs):
        assert a.num_gauss == b.num_gauss
    jh, jwer = _decode(yesno, "j")
    th, twer = _decode(yesno, "t")
    assert th == jh
    assert jwer == twer == 0.0
    feats = np.concatenate([f for _u, f, _w in yesno["train"]])[None]
    jl = float(np.mean(np.max(jm.am.loglikes_np(feats), axis=-1)))
    tl = float(np.mean(np.max(tm.am.loglikes_np(feats), axis=-1)))
    assert tl == pytest.approx(jl, rel=1e-3)


def test_train_mono_reports_each_iteration():
    rng = np.random.RandomState(4)
    train = _corpus(rng, 4)
    lang = prepare_lang(Lexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                        num_sil_states=3)
    stats = []
    tmono.train_mono(lang, train, tmono.MonoTrainOpts(
        num_iters=3, totgauss=20, max_iter_inc=2, realign_iters=(1,)),
        device="cpu", iter_stats=stats)
    assert [s["iter"] for s in stats] == [0, 1, 2]
    assert set(stats[1]) >= {"loglikes", "align", "accumulate", "update"}
    assert "loglikes" not in stats[2] and stats[2]["aligned"] == 4
    assert all(np.isfinite(s["loglike_per_frame"]) for s in stats)


def test_recipe_yesno_cli_on_the_cpu(capsys):
    assert cli.main(["recipe-yesno", "--device", "cpu"]) == 0
    assert "%WER 0.00" in capsys.readouterr().out
