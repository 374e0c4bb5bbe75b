"""Port parity, end to end: nnet3 TDNN and LSTM hybrids on the yesno
system (kaldi_tpu_torch.steps.nnet3_train against kaldi_tpu's), and nnet3
sMBR on shared denominator lattices, on the CPU.

The corpus and options are tests/test_yesno_e2e.py's (24 training and 8
test utterances at seed 42; monophone 12 iterations / 60 gaussians; the
TDNN at 30 epochs, lr 0.1 -> 0.01, minibatch 64, momentum 0.9) and
tests/test_nnet3_recurrent.py:154-222's for the LSTM (cell 64, proj 32,
splice (-1, 0, 1), 40 epochs, lr 0.15 -> 0.02). The features are the
port's MFCC, fed to both packages, and the JAX monophone is carried
across (`params.mono_model_from_jax`), so both align alike. The inits
differ (a torch.Generator against a jax.random key), so the nets differ:
each package decodes its own through its own HCLG and beam search, and
both give the reference words (WER 0; PARITY.md:27, :39).

sMBR (PARITY.md:40): JAX's trained TDNN carried into the port
(`params.am_nnet3_from_jax`); denominator lattices from the port's
decoder over its loglikes, JAX's copies of them built arc for arc; the
numerator from the monophone's alignment. One step of the surrogate
loss from the same posteriors within 1e-5 of its terms; two epochs in
each package with the objective history within 1e-4 of JAX's (each
package rescores with its own f32 loglikes, as in
tests/test_torch_nnet_discriminative.py) and the expected frame accuracy
not falling (JAX's own bound, tests/test_nnet3_recurrent.py:298).
"""

import copy

import jax
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
from kaldi_tpu.nnet import discriminative as jdisc
from kaldi_tpu.nnet3 import training as jtrain
from kaldi_tpu.steps import mono as jmono
from kaldi_tpu.steps import nnet3_train as jsteps
from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu_torch.decoder.graph_pack import pack_graph
from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.fst.graph import make_hclg
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.lat.generate import decode_to_lattices
from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
from kaldi_tpu_torch.nnet import discriminative as tdisc
from kaldi_tpu_torch.nnet3 import training as ttrain
from kaldi_tpu_torch.params import (am_nnet3_from_jax, lattice_from_jax,
                                    mono_model_from_jax, nnet3_params_from_jax)
from kaldi_tpu_torch.steps import nnet3_train as tsteps
from kaldi_tpu_torch.steps.mono import compile_and_pad
from test_torch_lat_posteriors import lattice_to_jax

torch.set_num_threads(2)

DECODE = dict(beam=16.0, max_active=256, acoustic_scale=0.1)
TDNN_OPTS = dict(initial_lr=0.1, final_lr=0.01, num_epochs=30,
                 minibatch_size=64, momentum=0.9)
LSTM = dict(cell_dim=64, proj_dim=32, splice=(-1, 0, 1))
LSTM_OPTS = dict(initial_lr=0.15, final_lr=0.02, num_epochs=40,
                 minibatch_size=64, momentum=0.9)


@pytest.fixture(scope="module")
def yesno():
    rng = np.random.RandomState(42)

    def utt(name):
        ws = [str(rng.choice(["YES", "NO"])) for _ in range(rng.randint(2, 6))]
        return (name, cs.mfcc_deltas(cs.yesno_synth(ws, rng), "cpu"), ws)

    train = [utt(f"train_{i}") for i in range(24)]
    test = [utt(f"test_{i}") for i in range(8)]
    jlang = jprepare(JLexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                     num_sil_states=3)
    tlang = prepare_lang(Lexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                         num_sil_states=3)
    jm = jmono.train_mono(jlang, train, jmono.MonoTrainOpts(
        num_iters=12, totgauss=60, max_iter_inc=8,
        realign_iters=tuple(range(1, 12))))
    tm = mono_model_from_jax(jm, tlang, "cpu")
    jdec = JBeam(jpack_graph(jmake_hclg(
        jlang, jarpa_to_g(JArpa.parse(cs.YESNO_ARPA), jlang.words),
        jm.trans_model, jm.ctx_dep, self_loop_scale=0.1).fst,
        jm.trans_model.id2pdf_array), JBeamOpts(**DECODE))
    tdec = BeamSearchDecoder(pack_graph(make_hclg(
        tlang, arpa_to_g(ArpaLm.parse(cs.YESNO_ARPA), tlang.words),
        tm.trans_model, tm.ctx_dep, self_loop_scale=0.1).fst,
        tm.trans_model.id2pdf_array), BeamSearchOpts(**DECODE),
        device="cpu")
    return dict(train=train, test=test, jlang=jlang, tlang=tlang, jm=jm,
                tm=tm, jdec=jdec, tdec=tdec)


def _words(dec, lang, am, utts):
    feats, nf = cs.pad_batch([f for _u, f, _w in utts])
    res = dec.decode(am.loglikes_np(feats), nf)
    return [[lang.words.sym(int(w)) for w in r[0]] if r else None
            for r in res]


def _both(s, jres, tres):
    refs = [w for _u, _f, w in s["test"]]
    jw = _words(s["jdec"], s["jlang"], jres.am, s["test"])
    tw = _words(s["tdec"], s["tlang"], tres.am, s["test"])
    assert jw == refs, jw          # JAX's WER 0
    assert tw == jw, tw            # the port's words are JAX's
    assert tres.am.device.type == "cpu"
    np.testing.assert_allclose(tres.am.priors, jres.am.priors, rtol=1e-12)


@pytest.fixture(scope="module")
def tdnn3(yesno):
    s = yesno
    jres = jsteps.train_tdnn3(s["jm"], s["train"], train_opts=jtrain
                              .Nnet3TrainOpts(**TDNN_OPTS))
    tres = tsteps.train_tdnn3(s["tm"], s["train"], train_opts=ttrain
                              .Nnet3TrainOpts(**TDNN_OPTS))
    return jres, tres


def test_train_tdnn3_wer_zero_with_jax_words(yesno, tdnn3):
    jres, tres = tdnn3
    assert tres.history[-1][3] > 0.5, tres.history[-2:]
    assert [h[:2] for h in tres.history] == [h[:2] for h in jres.history]
    assert tres.am.model.config_text == jres.am.model.config_text
    _both(yesno, jres, tres)


def test_train_lstm3_wer_zero_with_jax_words(yesno):
    s = yesno
    jres = jsteps.train_lstm3(s["jm"], s["train"], train_opts=jtrain
                              .Nnet3TrainOpts(**LSTM_OPTS), **LSTM)
    tres = tsteps.train_lstm3(s["tm"], s["train"], train_opts=ttrain
                              .Nnet3TrainOpts(**LSTM_OPTS), **LSTM)
    assert tres.am.model.is_recurrent
    assert tres.history[-1][3] > 0.5, tres.history[-2:]
    _both(s, jres, tres)


@pytest.fixture(scope="module")
def smbr(yesno, tdnn3):
    """JAX's TDNN in both packages, lattices and numerator alignments."""
    s = yesno
    jam = tdnn3[0].am
    tam = am_nnet3_from_jax(jam, device="cpu")
    lc, rc = tam.model.left_context, tam.model.right_context
    utts = s["train"][:8]
    feats, nf = cs.pad_batch([f for _u, f, _w in utts])
    lats = decode_to_lattices(s["tdec"], tam.loglikes_np(feats), nf,
                              lattice_beam=8.0)
    tm = s["tm"]
    batch, gf, gnf = compile_and_pad(tm.lang, tm.trans_model, tm.ctx_dep,
                                     utts)
    ali = viterbi_align(batch, tm.am.loglikes(gf), gnf, 0.1, device="cpu")
    egs = [(np.pad(f, ((lc, rc), (0, 0)), mode="edge"), np.asarray(a[0]),
            lat) for (_u, f, _w), lat, a in zip(utts, lats, ali)
           if lat is not None and a is not None]
    assert len(egs) >= 5
    return dict(jam=jam, tam=tam, egs=egs, lc=lc,
                sil={s["tlang"].phones["SIL"]})


def test_one_smbr_step_equals_jax(yesno, smbr, monkeypatch):
    """The params after one SGD step of the surrogate loss, from the same
    params, features and posteriors, within 1e-5 of each leaf's terms
    (its largest |p| plus its largest step)."""
    f, ali, lat = smbr["egs"][0]
    tam = smbr["tam"]
    ll = tam.loglikes_np(f[None])[0][smbr["lc"]:smbr["lc"] + len(ali)]
    post, objf = tdisc.compute_discriminative_post(
        tam, copy.deepcopy(lat), ali, yesno["tm"].trans_model,
        tdisc.NnetDiscriminativeOpts(), ll, smbr["sil"])
    assert np.abs(post).max() > 0
    for m in (jdisc, tdisc):
        monkeypatch.setattr(m, "compute_discriminative_post",
                            lambda *a, **k: (post, objf))
    opts = dict(criterion="smbr", learning_rate=3e-2, num_epochs=1)
    jp, _ = jdisc.train_nnet_discriminative(
        smbr["jam"], yesno["jm"].trans_model, [(f, ali, lattice_to_jax(lat))],
        jdisc.NnetDiscriminativeOpts(**opts), smbr["sil"])
    tp, _ = tdisc.train_nnet_discriminative(
        tam, yesno["tm"].trans_model, [(f, ali, copy.deepcopy(lat))],
        tdisc.NnetDiscriminativeOpts(**opts), smbr["sil"])
    want = nnet3_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    before = tam.model.params()
    moved = False
    for k, g in tp.items():
        w, b = want[k].numpy(), before[k].numpy()
        terms = np.abs(b).max() + np.abs(w - b).max()
        assert np.abs(g.numpy() - w).max() <= 1e-5 * terms, k
        moved |= not np.array_equal(g.numpy(), b)
    assert moved


def test_smbr_epochs_equal_jax_and_accuracy_does_not_fall(yesno, smbr):
    opts = dict(criterion="smbr", learning_rate=3e-4, num_epochs=2)
    _jp, jh = jdisc.train_nnet_discriminative(
        smbr["jam"], yesno["jm"].trans_model,
        [(f, a, lattice_to_jax(lat)) for f, a, lat in smbr["egs"]],
        jdisc.NnetDiscriminativeOpts(**opts), smbr["sil"])
    tp, th = tdisc.train_nnet_discriminative(
        smbr["tam"], yesno["tm"].trans_model,
        [(f, a, copy.deepcopy(lat)) for f, a, lat in smbr["egs"]],
        tdisc.NnetDiscriminativeOpts(**opts), smbr["sil"])
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-4)
    assert np.isfinite(th).all()
    assert th[-1] >= th[0] - 1e-3, th
    assert all(v.device.type == "cpu" for v in tp.values())
    # the round trip of a lattice through JAX's class is exact
    lat = smbr["egs"][0][2]
    back = lattice_from_jax(lattice_to_jax(lat))
    assert back.finals == lat.finals and len(back.arcs) == len(lat.arcs)
