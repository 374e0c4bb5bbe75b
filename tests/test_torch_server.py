"""Port parity: network serving (kaldi_tpu_torch/online/server.py,
threaded.py, compress.py, gmm_decoding.py) against kaldi_tpu/online/ on
the CPU.

The GMM side is a yesno monophone trained by the port (`train_mono`,
MFCC + deltas) and carried to JAX through the model files
(`io/model_io.py`); the fused side is tests/test_torch_fused_online.py's
CSR setup (a seeded relu TDNN over a 40-word synthetic HCLG).

- `DecodeSession` (the online GMM decoder) and `FusedDecodeSession` fed
  the same bytes in fixed and odd-length chunks, which exercise the odd
  byte kept back between reads: every partial hypothesis (after each
  chunk) and the final one equal JAX's. Over a socket the reads' sizes
  depend on the kernel's buffering, so there only FINAL is compared: a
  real localhost `AudioServer` per package, the port's serving three
  connections at once, each on its own decoders
  (`fused_session_factory`).
- `ThreadedSingleUtteranceDecoder` equals the synchronous decoder (words,
  tids, cost; PARITY.md:89), and a worker's error is raised on `wait()`.
- µ-law and IMA ADPCM codes, decoded samples and the carried ADPCM state
  are bit-exact with JAX's however the audio is chunked.
- `SingleUtteranceGmmDecoder` with mid-utterance fMLLR gives JAX's words
  and alignment and re-estimates at the same chunks; each re-estimation,
  replayed on the port's own features and partial path, has JAX's fMLLR
  statistics within the bound that the two packages' gaussian posteriors'
  difference sets (near-tied gaussians turn the f32 loglikes' rounding
  into posterior shifts, ROADMAP.md §3 traps; chip_smoke.py phase 19
  holds the card to the CPU the same way), and JAX's f64 solve of the
  port's statistics gives the port's transform exactly. The transform
  itself is not held at a fixed tolerance: the solve over a few hundred
  frames amplifies the statistics' last digits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder as JBeam,
                                           BeamSearchOpts as JBeamOpts)
from kaldi_tpu.decoder.biggraph import (BigGraphConfig as JBigGraphConfig,
                                        make_big_hclg as jmake_big_hclg)
from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder as JCsr,
                                        CsrBeamOpts as JCsrOpts)
from kaldi_tpu.fst.fst import SymbolTable as JSymbolTable
from kaldi_tpu.io import model_io as jmio
from kaldi_tpu.nnet.am_nnet import AmNnet as JAmNnet
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu.online import compress as jcomp
from kaldi_tpu.online import gmm_decoding as jgmmdec
from kaldi_tpu.online import server as jserver
from kaldi_tpu.online.decoder import OnlineDecoder as JOnlineDecoder
from kaldi_tpu.online.features import (
    OnlineFeaturePipeline as JPipeline,
    OnlineProcessedFeature as JProcessed)
from kaldi_tpu.online.fused import FusedOnlineDecoder as JFused
from kaldi_tpu.online.nnet2_decoding import (
    OnlineNnet2FeaturePipeline as JNnet2Pipeline,
    SingleUtteranceNnet2Decoder as JSud)
from kaldi_tpu.online.threaded import \
    ThreadedSingleUtteranceDecoder as JThreaded
from kaldi_tpu.ops import FbankOpts as JFbankOpts, FrameOpts as JFrameOpts, \
    MelOpts as JMelOpts, MfccOpts as JMfccOpts
from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
from kaldi_tpu_torch.fst.fst import SymbolTable
from kaldi_tpu_torch.io import model_io as tmio
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.online import compress as tcomp
from kaldi_tpu_torch.online import gmm_decoding as tgmmdec
from kaldi_tpu_torch.online import server as tserver
from kaldi_tpu_torch.online.decoder import OnlineDecoder
from kaldi_tpu_torch.online.features import (OnlineFeaturePipeline,
                                             OnlineProcessedFeature)
from kaldi_tpu_torch.online.nnet2_decoding import (
    OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
from kaldi_tpu_torch.online.threaded import ThreadedSingleUtteranceDecoder
from kaldi_tpu_torch.ops.features import FbankOpts, MfccOpts
from kaldi_tpu_torch.ops.mel import MelOpts
from kaldi_tpu_torch.ops.window import FrameOpts
from kaldi_tpu_torch.params import random_tdnn_params

torch.set_num_threads(2)

SR = cs.GMM_SR
BEAM = dict(beam=16.0, max_active=64, acoustic_scale=0.1)
FUSED_TDNN = dict(feat_dim=24, num_pdfs=16, hidden_dim=64,
                  pnorm_output_dim=32, nonlinearity="relu",
                  splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
FUSED_GRAPH = dict(vocab=40, avg_bigram_succ=6, num_pdfs=16, seed=3)
CSR = dict(beam=11.0, max_active=128, acoustic_scale=0.1,
           expand_budget=2048, eps_budget=512, hub_threshold=64)
@pytest.fixture(scope="module")
def gmm(tmp_path_factory):
    """The port's yesno monophone and HCLG (`chip_smoke.yesno_gmm_system`),
    saved, and both packages' loads of the same files."""
    ys = cs.yesno_gmm_system()
    d = tmp_path_factory.mktemp("gmm")
    mdl, hclg = str(d / "final.mdl"), str(d / "HCLG")
    tmio.save_gmm_system(mdl, ys["model"])
    tmio.save_hclg(hclg, ys["packed"])
    return dict(t=tmio.load_gmm_system(mdl, device="cpu"),
                j=jmio.load_gmm_system(mdl), tg=tmio.load_hclg(hclg),
                jg=jmio.load_hclg(hclg), waves=ys["waves"], mdl=mdl,
                hclg=hclg)


def _mfcc_opts(side):
    if side == "t":
        return MfccOpts(frame_opts=FrameOpts(samp_freq=SR, dither=0.0))
    return JMfccOpts(frame_opts=JFrameOpts(samp_freq=SR, dither=0.0))


def _gmm_session(g, side):
    if side == "t":
        base = BeamSearchDecoder(g["tg"], BeamSearchOpts(**BEAM),
                                 device="cpu")
        return tserver.DecodeSession(
            lambda: OnlineFeaturePipeline(_mfcc_opts("t"), delta_order=2,
                                          device="cpu"),
            lambda: OnlineDecoder(base, chunk_frames=16),
            am=g["t"].am, words=g["t"].lang.words)
    base = JBeam(g["jg"], JBeamOpts(**BEAM))
    return jserver.DecodeSession(
        lambda: JPipeline(_mfcc_opts("j"), delta_order=2),
        lambda: JOnlineDecoder(base, chunk_frames=16),
        am=g["j"].am, words=g["j"].lang.words)


@pytest.mark.parametrize("chunking", list(cs.SERVE_CHUNKINGS))
def test_decode_session_partials_and_final_equal_jax(gmm, chunking):
    chunks = cs.pcm_chunks(gmm["waves"][1], cs.SERVE_CHUNKINGS[chunking])
    got = cs.drive_session(_gmm_session(gmm, "t"), chunks)
    want = cs.drive_session(_gmm_session(gmm, "j"), chunks)
    assert got == want
    assert got[-1] == "NO NO YES NO"
    assert len(set(got)) > 2            # the partials moved


@pytest.fixture(scope="module")
def fused():
    params = random_tdnn_params(TdnnConfig(**FUSED_TDNN),
                                np.random.default_rng(0))
    priors = np.random.default_rng(1).dirichlet(np.ones(16))
    am = AmNnet(Tdnn(TdnnConfig(**FUSED_TDNN)).load_jax_params(params),
                priors=priors)
    jam = JAmNnet(JTdnn(JTdnnConfig(**FUSED_TDNN)),
                  jax.tree.map(jnp.asarray, params), priors=priors)
    graph, _ = make_big_hclg(BigGraphConfig(**FUSED_GRAPH))
    jgraph, _ = jmake_big_hclg(JBigGraphConfig(**FUSED_GRAPH))
    fb = FbankOpts(frame_opts=FrameOpts(dither=0.0),
                   mel_opts=MelOpts(num_bins=24))
    jfb = JFbankOpts(frame_opts=JFrameOpts(dither=0.0),
                     mel_opts=JMelOpts(num_bins=24))
    words, jwords = SymbolTable(), JSymbolTable()
    for k in range(1, 41):
        words.add(f"W{k}")
        jwords.add(f"W{k}")
    rng = np.random.default_rng(44)
    waves = [(rng.standard_normal(n) * 4000).astype(np.float32)
             for n in (20000, 13333, 26001)]
    return dict(am=am, jam=jam, graph=graph, jgraph=jgraph, fb=fb, jfb=jfb,
                words=words, jwords=jwords, waves=waves)


def _fused_session(f, side):
    if side == "t":
        return tserver.fused_session_factory(
            f["am"], f["graph"], CsrBeamOpts(**CSR), f["fb"], f["words"],
            device="cpu", chunk_samples=2560, t_max=256)()
    jdec = JCsr(f["jgraph"], JCsrOpts(**CSR))
    return jserver.FusedDecodeSession(
        JFused(f["jam"], jdec, f["jfb"], chunk_samples=2560, t_max=256),
        f["jwords"])


@pytest.mark.parametrize("chunking", list(cs.SERVE_CHUNKINGS))
def test_fused_session_partials_and_final_equal_jax(fused, chunking):
    chunks = cs.pcm_chunks(fused["waves"][0],
                           cs.SERVE_CHUNKINGS[chunking])
    got = cs.drive_session(_fused_session(fused, "t"), chunks)
    want = cs.drive_session(_fused_session(fused, "j"), chunks)
    assert got == want
    assert got[-1] and len(set(got)) > 2


def _serve(server, waves, chunk_samples=4000):
    """Stream every wave on its own connection, all at once -> lines."""
    return [lines for lines, _tm
            in cs._serve_concurrently(server, waves, chunk_samples)]


def _jax_final(session, wave) -> str:
    return cs.drive_session(session, cs.pcm_chunks(wave, [len(wave) * 2]))[-1]


def test_fused_server_finals_equal_jax_on_concurrent_connections(fused):
    server = tserver.AudioServer("127.0.0.1", 0, tserver.fused_session_factory(
        fused["am"], fused["graph"], CsrBeamOpts(**CSR), fused["fb"],
        fused["words"], device="cpu", chunk_samples=2560, t_max=256))
    lines = _serve(server, fused["waves"], chunk_samples=2560)
    for wave, got in zip(fused["waves"], lines):
        assert got and got[-1].startswith("FINAL ")
        assert got[-1] == "FINAL " + _jax_final(_fused_session(fused, "j"),
                                                wave)
    # the JAX server gives the same FINAL line for the first wave
    jsrv = jserver.AudioServer("127.0.0.1", 0,
                               lambda: _fused_session(fused, "j"))
    assert _serve(jsrv, fused["waves"][:1], 2560)[0][-1] == lines[0][-1]


def test_gmm_server_final_equals_jax(gmm):
    server = tserver.AudioServer("127.0.0.1", 0,
                                 lambda: _gmm_session(gmm, "t"))
    lines = _serve(server, gmm["waves"][:2])
    for wave, got in zip(gmm["waves"], lines):
        assert got[-1] == "FINAL " + _jax_final(_gmm_session(gmm, "j"), wave)
        assert any(ln.startswith("PARTIAL ") for ln in got)


# ------------------------------------------------------ threaded decoder

def _nnet2(g, side):
    """A seeded relu TDNN over the monophone's 39-dim features and pdfs,
    and a single-utterance nnet2 decoder factory of one package."""
    cfg = dict(feat_dim=39, num_pdfs=g["t"].am.num_pdfs, hidden_dim=32,
               nonlinearity="relu", splice_indexes=((-1, 0, 1), (0,)))
    params = random_tdnn_params(TdnnConfig(**cfg), np.random.default_rng(7))
    priors = np.random.default_rng(8).dirichlet(np.ones(cfg["num_pdfs"]))
    if side == "t":
        am = AmNnet(Tdnn(TdnnConfig(**cfg)).load_jax_params(params), priors)
        dec = BeamSearchDecoder(g["tg"], BeamSearchOpts(**BEAM),
                                device="cpu")
        return lambda: SingleUtteranceNnet2Decoder(
            am, g["t"].trans_model, dec, OnlineNnet2FeaturePipeline(
                OnlineProcessedFeature(OnlineFeaturePipeline(
                    _mfcc_opts("t"), delta_order=2, device="cpu"))),
            chunk_frames=16)
    am = JAmNnet(JTdnn(JTdnnConfig(**cfg)),
                 jax.tree.map(jnp.asarray, params), priors)
    dec = JBeam(g["jg"], JBeamOpts(**BEAM))
    return lambda: JSud(am, g["j"].trans_model, dec, JNnet2Pipeline(
        JProcessed(JPipeline(_mfcc_opts("j"), delta_order=2))),
        chunk_frames=16)


def _sync(sud, wave, step):
    for lo in range(0, len(wave), step):
        sud.pipeline.accept_waveform(wave[lo: lo + step])
        sud.advance_decoding()
    sud.finalize_decoding()
    return sud.best_path()


def _threaded(cls, sud, wave, step):
    t = cls(sud)
    for lo in range(0, len(wave), step):
        t.accept_waveform(wave[lo: lo + step])
    t.input_finished()
    assert t.wait(timeout=120.0)
    assert t.num_frames_decoded() > 0
    return t.best_path()


@pytest.mark.parametrize("step", [1600, 999])
def test_threaded_equals_synchronous_and_jax(gmm, step):
    wave = gmm["waves"][2]
    make = _nnet2(gmm, "t")
    ref = _sync(make(), wave, step)
    got = _threaded(ThreadedSingleUtteranceDecoder, make(), wave, step)
    assert ref is not None and len(ref[0]) >= 1
    assert list(got[0]) == list(ref[0]) and list(got[1]) == list(ref[1])
    assert got[2] == pytest.approx(ref[2], rel=1e-6, abs=1e-4)
    jref = _threaded(JThreaded, _nnet2(gmm, "j")(), wave, step)
    assert list(got[0]) == list(jref[0]) and list(got[1]) == list(jref[1])


def test_threaded_worker_error_is_raised_on_wait(gmm):
    sud = _nnet2(gmm, "t")()

    def boom():
        raise RuntimeError("worker failed")
    sud.advance_decoding = boom
    t = ThreadedSingleUtteranceDecoder(sud)
    t.accept_waveform(gmm["waves"][0][:2000])
    t.input_finished()
    with pytest.raises(RuntimeError, match="worker failed"):
        t.wait(timeout=30.0)


# ---------------------------------------------------------------- codecs

def _tone(n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    return (9000 * np.sin(2 * np.pi * 440 * t) + rng.randn(n) * 3000
            ).astype(np.float32)


def test_mulaw_codes_equal_jax():
    x = np.concatenate([_tone(3000, 0), [40000.0, -40000.0, 0.0, -1.0]])
    codes = tcomp.mulaw_encode(x)
    np.testing.assert_array_equal(codes, jcomp.mulaw_encode(x))
    np.testing.assert_array_equal(tcomp.mulaw_decode(codes),
                                  jcomp.mulaw_decode(codes))


@pytest.mark.parametrize("step", [4000, 701, 1])
def test_adpcm_codes_and_state_equal_jax(step):
    x = _tone(4000, 1)
    if step == 1:
        x = x[:400]
    out = {}
    for name, mod in (("t", tcomp), ("j", jcomp)):
        es, ds = mod.AdpcmState(), mod.AdpcmState()
        codes, dec, states = [], [], []
        for lo in range(0, len(x), step):
            c, es = mod.adpcm_encode(x[lo:lo + step], es)
            d, ds = mod.adpcm_decode(c, ds)
            codes.append(c)
            dec.append(d)
            states.append((es.predictor, es.index, ds.predictor, ds.index))
        out[name] = (np.concatenate(codes), np.concatenate(dec), states)
    np.testing.assert_array_equal(out["t"][0], out["j"][0])
    np.testing.assert_array_equal(out["t"][1], out["j"][1])
    assert out["t"][2] == out["j"][2]
    one, _ = tcomp.adpcm_encode(x)
    np.testing.assert_array_equal(out["t"][0], one)


# ----------------------------------------------------- online GMM decoder

def _gmm_decoder(g, side, policy_kw):
    kw = dict(policy_kw)
    if side == "t":
        base = BeamSearchDecoder(g["tg"], BeamSearchOpts(**BEAM),
                                 device="cpu")
        return tgmmdec.SingleUtteranceGmmDecoder(
            g["t"].am, g["t"].trans_model, base,
            OnlineFeaturePipeline(_mfcc_opts("t"), delta_order=2,
                                  device="cpu"),
            policy=tgmmdec.AdaptationPolicy(**kw), fmllr_min_count=20.0)
    base = JBeam(g["jg"], JBeamOpts(**BEAM))
    return jgmmdec.SingleUtteranceGmmDecoder(
        g["j"].am, g["j"].trans_model, base,
        JPipeline(_mfcc_opts("j"), delta_order=2),
        policy=jgmmdec.AdaptationPolicy(**kw), fmllr_min_count=20.0)


def _run_gmm(sud, wave, step=int(0.25 * SR)):
    """Stream the wave in 250 ms steps -> (best path, the transform after
    each step, each re-estimation's inputs and result)."""
    transforms, calls = [], []
    estimate = sud.estimate_fmllr

    def recorded(raw):
        init = sud.state.transform
        res = sud.decoder.best_path(use_final_probs=False)
        estimate(raw)
        calls.append((np.array(raw), res, init, sud.state.transform))
    sud.estimate_fmllr = recorded
    for lo in range(0, len(wave), step):
        sud.pipeline.accept_waveform(wave[lo: lo + step])
        sud.advance_decoding()
        transforms.append(None if sud.state.transform is None
                          else np.array(sud.state.transform))
    sud.finalize_decoding()
    return sud.best_path(), transforms, calls


def _replay(g, raw, res, init):
    """One re-estimation of kaldi_tpu/online/gmm_decoding.py
    `estimate_fmllr` on the same features, partial path and start, in
    both packages -> (port stats, JAX stats, term scale, the bound that
    the packages' gaussian posteriors' difference sets on the statistics,
    JAX's transform from the port's statistics)."""
    from kaldi_tpu.gmm.estimation import _aligned_posteriors
    from kaldi_tpu.transform import fmllr as jfmllr
    from kaldi_tpu_torch.transform import fmllr as tfmllr
    tids = res[1]
    T = min(len(tids), raw.shape[0])
    x = raw[:T]
    pdfs = np.array([g["j"].trans_model.transition_id_to_pdf(t)
                     for t in tids[:T]])
    ts, js = tfmllr.FmllrStats(raw.shape[1]), jfmllr.FmllrStats(raw.shape[1])
    ts.accumulate_from_alignment(g["t"].am, x, pdfs)
    js.accumulate_from_alignment(g["j"].am, x, pdfs)
    packed, seg = g["j"].am.pack()
    jpost = np.asarray(_aligned_posteriors(
        jnp.asarray(x, jnp.float32), jnp.asarray(pdfs),
        jnp.ones(T, jnp.float32), jnp.asarray(packed), jnp.asarray(seg))[0],
        np.float64)
    tpost = tfmllr._posteriors_np(g["t"].am, x.astype(np.float32), pdfs,
                                  np.ones(T, np.float32))
    bound = cs.fmllr_term_scale(g["t"].am, x, pdfs,
                                post=np.abs(tpost - jpost))
    on_port = jfmllr.FmllrStats(raw.shape[1])
    on_port.beta, on_port.K, on_port.G = ts.beta, ts.K.copy(), ts.G.copy()
    W, _impr, count = jfmllr.estimate_fmllr(on_port, min_count=20.0,
                                            init=init)
    return (ts, js, cs.fmllr_term_scale(g["t"].am, x, pdfs), bound,
            W if count >= 20.0 else init)


def _rel_to(got, want, scale) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))
                        / np.maximum(scale, 1e-30)))


@pytest.mark.parametrize("policy", ["default", "early"])
def test_online_gmm_decoder_words_and_transform_equal_jax(gmm, policy):
    kw = {} if policy == "default" else dict(
        adaptation_first_utt_delay=0.5, adaptation_first_utt_ratio=1.5)
    wave = gmm["waves"][2]
    (tw, tt, _tc), ttr, calls = _run_gmm(_gmm_decoder(gmm, "t", kw), wave)
    (jw, jt, _jc), jtr, jcalls = _run_gmm(_gmm_decoder(gmm, "j", kw), wave)
    assert list(tw) == list(jw) and list(tt) == list(jt)
    assert [x is None for x in ttr] == [x is None for x in jtr]
    assert len(calls) == len(jcalls) > 0 and any(x is not None for x in ttr)
    # each re-estimation, replayed on the port's own inputs: the fMLLR
    # statistics within the bound that the packages' gaussian posteriors'
    # difference sets (plus 1e-9 of the terms for the f64 sums), that
    # bound small, and JAX's solve of the port's statistics is the port's
    # transform
    for raw, res, init, W in calls:
        ts, js, scale, bound, want = _replay(gmm, raw, res, init)
        assert ts.beta == pytest.approx(js.beta, rel=1e-6)
        for k in ("K", "G"):
            got, ref = getattr(ts, k), getattr(js, k)
            b, sc = getattr(bound, k), getattr(scale, k)
            assert np.all(np.abs(got - ref) <= b + 1e-9 * sc), k
            assert _rel_to(b, 0.0, sc) <= 1e-3, k
        np.testing.assert_array_equal(W, want)
    words = [gmm["t"].lang.words.sym(w) for w in tw]
    assert words == ["YES", "NO"] * 4


def test_adaptation_policy_schedule_equals_jax():
    for kw in ({}, dict(adaptation_first_utt_delay=0.5,
                        adaptation_first_utt_ratio=1.5)):
        t, j = tgmmdec.AdaptationPolicy(**kw), jgmmdec.AdaptationPolicy(**kw)
        for first in (True, False):
            for a in np.arange(0.0, 30.0, 0.16):
                assert t.do_adapt(a, a + 0.16, first) == \
                    j.do_adapt(a, a + 0.16, first)
