"""Port parity: kaldi_tpu_torch's FusedOnlineDecoder, both search engines
(padded and degree-tiered CSR), on the CPU.

tests/test_fused_streaming.py's contract restated for the port: however
the audio is chunked, the streamed hypothesis equals the offline decode
of the same wave (fbank -> AmNnet.loglikes -> the engine's decoder),
words and tids exact and the cost within 1e-2; and it equals JAX's
FusedOnlineDecoder over the same AM (carried across by
`params.tdnn_params_from_jax`) and graph.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder as JBeam,
                                           BeamSearchOpts as JBeamOpts)
from kaldi_tpu.decoder.biggraph import (BigGraphConfig as JBigGraphConfig,
                                        make_big_hclg as j_make_big_hclg)
from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder as JCsr,
                                        CsrBeamOpts as JCsrOpts)
from kaldi_tpu.nnet.am_nnet import AmNnet as JAmNnet
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu.online.fused import FusedOnlineDecoder as JFused
from kaldi_tpu.ops import FbankOpts as JFbankOpts, FrameOpts as JFrameOpts, \
    MelOpts as JMelOpts
from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
from kaldi_tpu_torch.lat.generate import decode_to_lattices
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.online.endpoint import EndpointConfig, EndpointRule
from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
from kaldi_tpu_torch.ops.features import FbankOpts, fbank
from kaldi_tpu_torch.ops.mel import MelOpts
from kaldi_tpu_torch.ops.window import FrameOpts
from kaldi_tpu_torch.params import random_tdnn_params

torch.set_num_threads(2)

TDNN = dict(feat_dim=24, num_pdfs=16, hidden_dim=64, pnorm_output_dim=32,
            nonlinearity="relu",
            splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
GRAPH = dict(vocab=40, avg_bigram_succ=6, num_pdfs=16, seed=3)
BEAM = dict(beam=11.0, max_active=128, acoustic_scale=0.1)
CSR = dict(BEAM, expand_budget=2048, eps_budget=512, hub_threshold=64)


@pytest.fixture(scope="module", params=["padded", "csr"])
def setup(request):
    fb = FbankOpts(frame_opts=FrameOpts(dither=0.0),
                   mel_opts=MelOpts(num_bins=24))
    jfb = JFbankOpts(frame_opts=JFrameOpts(dither=0.0),
                     mel_opts=JMelOpts(num_bins=24))
    params = random_tdnn_params(TdnnConfig(**TDNN), np.random.default_rng(0))
    priors = np.random.default_rng(1).dirichlet(np.ones(16))
    am = AmNnet(Tdnn(TdnnConfig(**TDNN)).load_jax_params(params),
                priors=priors)
    jam = JAmNnet(JTdnn(JTdnnConfig(**TDNN)),
                  jax.tree.map(jnp.asarray, params), priors=priors)
    graph, _ = make_big_hclg(BigGraphConfig(**GRAPH))
    jgraph, _ = j_make_big_hclg(JBigGraphConfig(**GRAPH))
    if request.param == "padded":
        dec = BeamSearchDecoder(graph, BeamSearchOpts(**BEAM), device="cpu")
        jdec = JBeam(jgraph, JBeamOpts(**BEAM))
    else:
        dec = CsrBeamDecoder(graph, CsrBeamOpts(**CSR), device="cpu")
        jdec = JCsr(jgraph, JCsrOpts(**CSR))
    fused = FusedOnlineDecoder(am, dec, fb, chunk_samples=2560, t_max=256,
                               keep_loglikes=True)
    jfused = JFused(jam, jdec, jfb, chunk_samples=2560, t_max=256,
                    keep_loglikes=True)
    return dict(fb=fb, am=am, dec=dec, fused=fused, jfused=jfused)


def _offline(s, wave):
    feats = fbank(torch.from_numpy(wave), s["fb"])
    ll = s["am"].loglikes(feats[None])
    return s["dec"].decode(ll, np.array([feats.shape[0]], np.int32))[0]


def _stream(fused, wave, chunk):
    fused.reset()
    pos = 0
    while pos < len(wave):
        fused.accept_waveform(wave[pos: pos + chunk])
        pos += chunk
    fused.input_finished()
    return fused.best_path()


def _same(got, want):
    assert got is not None and want is not None
    assert list(got[0]) == list(want[0])
    assert list(got[1]) == list(want[1])
    assert got[2] == pytest.approx(want[2], rel=1e-4, abs=1e-2)


def _wave(seed, n):
    return np.random.default_rng(seed).standard_normal(n) \
        .astype(np.float32) * 4000


@pytest.mark.parametrize("chunk", [2560, 1000, 7000])
def test_fused_equals_offline_and_jax(setup, chunk):
    rng = np.random.default_rng(11)
    for trial in range(3):
        wave = (rng.standard_normal(rng.integers(9000, 30000))
                .astype(np.float32) * 4000)
        got = _stream(setup["fused"], wave, chunk)
        _same(got, _offline(setup, wave))
        if trial == 0:
            _same(got, _stream(setup["jfused"], wave, chunk))
        assert setup["fused"].num_frames_decoded == \
            setup["jfused"].num_frames_decoded or trial > 0


def test_fused_short_utterance(setup):
    """Shorter than one dispatch chunk (ramp-up == flush)."""
    wave = _wave(5, 1700)
    got = _stream(setup["fused"], wave, 2560)
    _same(got, _offline(setup, wave))
    _same(got, _stream(setup["jfused"], wave, 2560))


def test_fused_partial_best_path(setup):
    """Mid-stream partial results equal JAX's, then the final one equals
    the offline decode."""
    fused, jfused = setup["fused"], setup["jfused"]
    wave = _wave(7, 16000)
    for f in (fused, jfused):
        f.reset()
        f.accept_waveform(wave[:8000])
    partial = fused.best_path(use_final_probs=False)
    _same(partial, jfused.best_path(use_final_probs=False))
    assert np.isfinite(partial[2])
    assert fused.final_relative_cost() == pytest.approx(
        jfused.final_relative_cost(), abs=1e-3)
    assert np.isfinite(fused.final_relative_cost())
    _same(fused.best_path(), jfused.best_path())
    fused.accept_waveform(wave[8000:])
    fused.input_finished()
    _same(fused.best_path(), _offline(setup, wave))


def test_fused_subframe_feeds(setup):
    """Many accept_waveform calls smaller than one frame."""
    wave = _wave(9, 12000)
    _same(_stream(setup["fused"], wave, 130), _offline(setup, wave))


def _same_paths(a, b):
    """The same (words, tids) paths, costs within 1e-2 as the decoder's
    costs: the kept log-likelihoods come from a windowed TDNN and take the
    prior's log in f64 (as JAX's fused decoder does), AmNnet.loglikes from
    the whole utterance with the log in f32, so each frame's score may
    differ by ulps, summed along the path."""
    pa = {(w, t): c for (w, t, c) in a.paths(max_paths=100000)}
    pb = {(w, t): c for (w, t, c) in b.paths(max_paths=100000)}
    assert pa.keys() == pb.keys()
    assert max(abs(pa[k] - pb[k]) for k in pa) < 1e-2


def test_fused_get_lattice_equals_offline_and_jax(setup):
    """Online latgen (ref: online2/online-nnet2-decoding.h:96 GetLattice):
    the finalize-time lattice has the path set of offline latgen on the
    same audio, and of JAX's fused decoder."""
    fused, jfused = setup["fused"], setup["jfused"]
    wave = _wave(13, 14000)
    feats = fbank(torch.from_numpy(wave), setup["fb"])
    ll = setup["am"].loglikes(feats[None]).numpy()
    off = decode_to_lattices(setup["dec"], ll,
                             np.array([feats.shape[0]], np.int32), 6.0)[0]
    _stream(fused, wave, 2560)
    _stream(jfused, wave, 2560)
    lat, jlat = fused.get_lattice(6.0), jfused.get_lattice(6.0)
    assert lat is not None and off is not None and jlat is not None
    _same_paths(lat, off)
    _same_paths(lat, jlat)


def test_fused_get_lattice_needs_keep_loglikes(setup):
    plain = FusedOnlineDecoder(setup["am"], setup["dec"], setup["fb"],
                               chunk_samples=2560, t_max=64)
    with pytest.raises(ValueError, match="keep_loglikes"):
        plain.get_lattice()


class _AllSilence:
    @staticmethod
    def transition_id_to_phone(tid):
        return 0


def test_fused_endpointing(setup):
    """With every phone silence, trailing silence grows with the stream
    and rule1 fires; rules that cannot hold do not."""
    fused = setup["fused"]
    wave = _wave(17, 16000)
    cfg_fire = EndpointConfig(rule1=EndpointRule(False, 0.05, math.inf, 0.0))
    cfg_hold = EndpointConfig(
        rule1=EndpointRule(False, 1e9, math.inf, 0.0),
        rule2=EndpointRule(True, 1e9, -1e9, 0.0),
        rule3=EndpointRule(True, 1e9, -1e9, 0.0),
        rule4=EndpointRule(True, 1e9, math.inf, 0.0),
        rule5=EndpointRule(False, 0.0, math.inf, 1e9))
    fused.reset()
    fused.accept_waveform(wave)
    assert fused.trailing_silence_frames({0}, _AllSilence) == \
        fused.num_frames_decoded > 0
    assert fused.endpoint_detected(cfg_fire, {0}, _AllSilence)
    assert not fused.endpoint_detected(cfg_hold, {0}, _AllSilence)
    fused.input_finished()


def test_fused_near_capacity_utterance(setup):
    """An utterance whose final dispatch lands within ndmax frames of
    t_max (the arena exactly full) still equals offline."""
    wave = _wave(31, 40000)
    total = fbank(torch.from_numpy(wave), setup["fb"]).shape[0]
    tight = FusedOnlineDecoder(setup["am"], setup["dec"], setup["fb"],
                               chunk_samples=2560, t_max=total)
    _same(_stream(tight, wave, 2560), _offline(setup, wave))
    short = FusedOnlineDecoder(setup["am"], setup["dec"], setup["fb"],
                               chunk_samples=2560, t_max=total - 1)
    with pytest.raises(RuntimeError, match="t_max"):
        _stream(short, wave, 2560)


def test_fused_refusals(setup):
    am, dec, fb = setup["am"], setup["dec"], setup["fb"]
    fo = fb.frame_opts
    for bad, match in (
            (dict(feat_opts=dataclasses.replace(fb, frame_opts=dataclasses
                  .replace(fo, snip_edges=False))), "snip-edges"),
            (dict(feat_opts=dataclasses.replace(fb, frame_opts=dataclasses
                  .replace(fo, dither=1.0))), "dither"),
            (dict(chunk_samples=2500), "multiple of the frame shift")):
        kw = dict(feat_opts=fb, chunk_samples=2560)
        kw.update(bad)
        with pytest.raises(ValueError, match=match):
            FusedOnlineDecoder(am, dec, **kw)
    mixed = AmNnet(am.model, group_ids=np.repeat(np.arange(8), 2))
    with pytest.raises(ValueError, match="mixed-up"):
        FusedOnlineDecoder(mixed, dec, fb)
    with pytest.raises(TypeError):
        FusedOnlineDecoder(am, object(), fb)
