"""Port parity: the generic online path of kaldi_tpu_torch against
kaldi_tpu's, on the CPU: `OnlineDecoder` over several chunkings,
`SingleUtteranceNnet2Decoder` over `OnlineNnet2FeaturePipeline` with and
without an `OnlineIvectorFeature` (a small extractor over a hand-built
DiagGmm, carried across from JAX by `params.ivector_extractor_from_jax`),
with a mixed-up AM too, and the copied GMM and i-vector host code.

Decoders: words and tids exact, cost within 1e-2. The GMM and i-vector
code is the same numpy in both packages: equal arrays, to 1e-9 where the
two read f32 features that fbank computed within rtol 2e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder as JBeam,
                                           BeamSearchOpts as JBeamOpts)
from kaldi_tpu.decoder.biggraph import (BigGraphConfig as JBigGraphConfig,
                                        make_big_hclg as j_make_big_hclg)
from kaldi_tpu.gmm import diag_gmm as jdiag
from kaldi_tpu.gmm import full_gmm as jfull
from kaldi_tpu.ivector import extractor as jext
from kaldi_tpu.nnet.am_nnet import AmNnet as JAmNnet
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu.online import ivector as jivec
from kaldi_tpu.online.decoder import OnlineDecoder as JOnlineDecoder
from kaldi_tpu.online.features import OnlineMfcc as JOnlineMfcc
from kaldi_tpu.online.nnet2_decoding import (
    OnlineNnet2FeaturePipeline as JPipeline,
    SingleUtteranceNnet2Decoder as JSingle)
from kaldi_tpu.ops import FbankOpts as JFbankOpts, FrameOpts as JFrameOpts, \
    MelOpts as JMelOpts, fbank as jfbank
from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.gmm import diag_gmm as tdiag
from kaldi_tpu_torch.gmm import full_gmm as tfull
from kaldi_tpu_torch.ivector import extractor as text
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.online import ivector as tivec
from kaldi_tpu_torch.online.decoder import OnlineDecoder
from kaldi_tpu_torch.online.features import OnlineMfcc
from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
from kaldi_tpu_torch.online.nnet2_decoding import (
    OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
from kaldi_tpu_torch.ops.features import FbankOpts, fbank
from kaldi_tpu_torch.ops.mel import MelOpts
from kaldi_tpu_torch.ops.window import FrameOpts
from kaldi_tpu_torch.params import (diag_gmm_from_jax, full_gmm_from_jax,
                                    ivector_extractor_from_jax,
                                    random_tdnn_params)

torch.set_num_threads(2)

GRAPH = dict(vocab=40, avg_bigram_succ=6, num_pdfs=16, seed=3)
BEAM = dict(beam=11.0, max_active=96, acoustic_scale=0.1)
FB = FbankOpts(frame_opts=FrameOpts(dither=0.0), mel_opts=MelOpts(num_bins=24))
JFB = JFbankOpts(frame_opts=JFrameOpts(dither=0.0),
                 mel_opts=JMelOpts(num_bins=24))
IVEC_DIM = 4


def _same(got, want):
    assert got is not None and want is not None
    assert list(got[0]) == list(want[0])
    assert list(got[1]) == list(want[1])
    assert got[2] == pytest.approx(want[2], rel=1e-4, abs=1e-2)


def _wave(seed, n=20000):
    return np.random.default_rng(seed).standard_normal(n) \
        .astype(np.float32) * 4000


class _Tm:
    """A transition model stand-in: phone = tid % 3 (phone 0 is silence)."""

    @staticmethod
    def transition_id_to_phone(tid):
        return int(tid) % 3


def _ubm(seed=0, n=6):
    """A DiagGmm over 24-dim fbank frames of a seeded wave."""
    feats = np.asarray(jfbank(jnp.asarray(_wave(seed + 100)), JFB))
    rng = np.random.default_rng(seed)
    means = feats[rng.choice(len(feats), n, replace=False)]
    var = np.tile(feats.var(axis=0) + 0.5, (n, 1))
    return jdiag.DiagGmm(rng.dirichlet(np.ones(n)), means, var)


@pytest.fixture(scope="module")
def su():
    graph, _ = make_big_hclg(BigGraphConfig(**GRAPH))
    jgraph, _ = j_make_big_hclg(JBigGraphConfig(**GRAPH))
    dec = BeamSearchDecoder(graph, BeamSearchOpts(**BEAM), device="cpu")
    jdec = JBeam(jgraph, JBeamOpts(**BEAM))
    jx = jext.IvectorExtractor(_ubm(), IVEC_DIM, prior_offset=100.0, seed=1)
    jx.M *= 5.0                    # i-vectors that move with the stats
    return dict(dec=dec, jdec=jdec, jx=jx,
                tx=ivector_extractor_from_jax(jx))


def _ams(feat_dim, seed=0, group_ids=None):
    P = 16 if group_ids is None else len(group_ids)
    kw = dict(feat_dim=feat_dim, num_pdfs=P, hidden_dim=48,
              nonlinearity="relu", splice_indexes=((-2, 0, 2), (-1, 1), (0,)))
    params = random_tdnn_params(TdnnConfig(**kw), np.random.default_rng(seed))
    priors = np.random.default_rng(seed + 1).dirichlet(np.ones(16))
    am = AmNnet(Tdnn(TdnnConfig(**kw)).load_jax_params(params),
                priors=priors, group_ids=group_ids)
    jam = JAmNnet(JTdnn(JTdnnConfig(**kw)), jax.tree.map(jnp.asarray, params),
                  priors=priors, group_ids=group_ids)
    return am, jam


@pytest.mark.parametrize("chunk_frames,pieces", [(32, [40, 7, 100]),
                                                 (7, [13, 1, 30]),
                                                 (16, [500])])
def test_online_decoder_matches_jax_and_offline(su, chunk_frames, pieces):
    ll = np.random.default_rng(3).standard_normal((90, 16)) \
        .astype(np.float32) * 3
    t = OnlineDecoder(su["dec"], chunk_frames)
    j = JOnlineDecoder(su["jdec"], chunk_frames)
    assert t.best_path() == j.best_path() is None or \
        t.best_path()[0] == list(j.best_path()[0])
    pos, i = 0, 0
    while pos < len(ll):
        n = pieces[i % len(pieces)]
        for d in (t, j):
            d.advance_decoding(ll[pos:pos + n])
        pos, i = pos + n, i + 1
        _same(t.best_path(use_final_probs=False),
              j.best_path(use_final_probs=False))
        assert t.num_frames_decoded == j.num_frames_decoded == min(pos, 90)
        assert t.final_relative_cost() == pytest.approx(
            j.final_relative_cost(), abs=1e-3)
        assert t.trailing_silence_frames({0}, _Tm) == \
            j.trailing_silence_frames({0}, _Tm)
    _same(t.best_path(), j.best_path())
    _same(t.best_path(), su["dec"].decode(ll[None], np.array([90]))[0])
    t.init_decoding()
    t.advance_decoding(ll[:10])
    assert t.num_frames_decoded == 10


def _single(cls, pipe_cls, mfcc_cls, am, dec, fb, ivec=None, **kw):
    pipe = pipe_cls(mfcc_cls(fb), ivec) if ivec is not None \
        else pipe_cls(mfcc_cls(fb))
    return cls(am, _Tm, dec, pipe, silence_phones={0}, **kw)


def _run_single(d, wave, chunk):
    pos = 0
    while pos < len(wave):
        d.pipeline.accept_waveform(wave[pos:pos + chunk])
        d.advance_decoding()
        pos += chunk
    d.finalize_decoding()
    return d.best_path()


@pytest.mark.parametrize("chunk", [2560, 999])
def test_single_utterance_without_ivectors_matches_jax_and_offline(su,
                                                                   chunk):
    am, jam = _ams(24)
    wave = _wave(5)
    t = _single(SingleUtteranceNnet2Decoder, OnlineNnet2FeaturePipeline,
                lambda fb: OnlineMfcc(fb, computer=fbank, device="cpu"),
                am, su["dec"], FB, chunk_frames=16)
    j = _single(JSingle, JPipeline,
                lambda fb: JOnlineMfcc(fb, computer=jfbank),
                jam, su["jdec"], JFB, chunk_frames=16)
    got = _run_single(t, wave, chunk)
    _same(got, _run_single(j, wave, chunk))
    feats = fbank(torch.from_numpy(wave), FB)
    _same(got, su["dec"].decode(am.loglikes(feats[None]),
                                np.array([feats.shape[0]]))[0])


@pytest.mark.parametrize("cfg", [
    dict(num_gselect=3, use_most_recent_ivector=True, silence_weight=0.1),
    dict(num_gselect=5, use_most_recent_ivector=False, ivector_period=10,
         max_count=50.0),
])
def test_single_utterance_with_ivectors_matches_jax(su, cfg):
    am, jam = _ams(24 + IVEC_DIM, seed=4)
    wave = _wave(6)
    tiv = tivec.OnlineIvectorFeature(su["tx"], tivec.OnlineIvectorConfig(**cfg))
    jiv = jivec.OnlineIvectorFeature(su["jx"], jivec.OnlineIvectorConfig(**cfg))
    t = _single(SingleUtteranceNnet2Decoder, OnlineNnet2FeaturePipeline,
                lambda fb: OnlineMfcc(fb, computer=fbank, device="cpu"),
                am, su["dec"], FB, ivec=tiv, chunk_frames=16)
    j = _single(JSingle, JPipeline,
                lambda fb: JOnlineMfcc(fb, computer=jfbank),
                jam, su["jdec"], JFB, ivec=jiv, chunk_frames=16)
    assert t.pipeline.dim == j.pipeline.dim == 24 + IVEC_DIM
    _same(_run_single(t, wave, 1600), _run_single(j, wave, 1600))
    n = t.pipeline.num_frames_ready()
    np.testing.assert_allclose(t.pipeline.get_frames(0, n),
                               j.pipeline.get_frames(0, n),
                               rtol=2e-4, atol=2e-3)
    assert tiv._frame_w == pytest.approx(jiv._frame_w)
    # the stats sum UBM posteriors of frames that agree within rtol 2e-4;
    # the exp of their log-likelihoods spreads that to a few 1e-4
    ts, js = tiv.get_adaptation_state(), jiv.get_adaptation_state()
    np.testing.assert_allclose(ts.gamma, js.gamma, rtol=2e-3, atol=1e-4)


def test_mixed_up_am_is_served_by_the_generic_path_only(su):
    """A mixed-up AM (group_ids) decodes through SingleUtteranceNnet2Decoder
    as in JAX; FusedOnlineDecoder refuses it."""
    gid = np.repeat(np.arange(16), 2)
    am, jam = _ams(24, seed=8, group_ids=gid)
    wave = _wave(9, 12000)
    t = _single(SingleUtteranceNnet2Decoder, OnlineNnet2FeaturePipeline,
                lambda fb: OnlineMfcc(fb, computer=fbank, device="cpu"),
                am, su["dec"], FB)
    j = _single(JSingle, JPipeline,
                lambda fb: JOnlineMfcc(fb, computer=jfbank),
                jam, su["jdec"], JFB)
    _same(_run_single(t, wave, 2560), _run_single(j, wave, 2560))
    with pytest.raises(ValueError, match="mixed-up"):
        FusedOnlineDecoder(am, su["dec"], FB)


def test_endpointing_matches_jax(su):
    from kaldi_tpu.online.endpoint import EndpointConfig as JEndpointConfig
    from kaldi_tpu_torch.online.endpoint import EndpointConfig
    am, jam = _ams(24)
    wave = _wave(10, 16000)
    t = _single(SingleUtteranceNnet2Decoder, OnlineNnet2FeaturePipeline,
                lambda fb: OnlineMfcc(fb, computer=fbank, device="cpu"),
                am, su["dec"], FB, endpoint_config=EndpointConfig())
    j = _single(JSingle, JPipeline,
                lambda fb: JOnlineMfcc(fb, computer=jfbank),
                jam, su["jdec"], JFB, endpoint_config=JEndpointConfig())
    for pos in range(0, len(wave), 3200):
        for d in (t, j):
            d.pipeline.accept_waveform(wave[pos:pos + 3200])
            d.advance_decoding()
        assert t.endpoint_detected() == j.endpoint_detected()


# --------------------------------------------------- host copies vs JAX

def _frames(seed=11, T=60):
    return np.asarray(jfbank(jnp.asarray(_wave(seed, 16000)), JFB))[:T]


def test_diag_and_full_gmm_copies_equal_jax():
    jg = _ubm(2)
    tg = diag_gmm_from_jax(jg)
    x = _frames()
    for f in ("gconsts", "means_invvars", "inv_vars", "packed"):
        np.testing.assert_array_equal(getattr(tg, f)(), getattr(jg, f)())
    for f in ("loglikes", "loglike", "posteriors"):
        np.testing.assert_array_equal(getattr(tg, f)(x), getattr(jg, f)(x))
    for a, b in ((tg.split(9, rng=np.random.RandomState(1)),
                  jg.split(9, rng=np.random.RandomState(1))),
                 (tg.merge(4), jg.merge(4))):
        for f in ("weights", "means", "vars"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    jf = jfull.FullGmm.from_diag(jg.weights, jg.means, jg.vars)
    tf = full_gmm_from_jax(jf)
    for f in ("loglikes", "loglike", "posteriors"):
        np.testing.assert_array_equal(getattr(tf, f)(x), getattr(jf, f)(x))
    np.testing.assert_array_equal(tf.to_diag().vars, jf.to_diag().vars)
    ta, ja = tfull.AccumFullGmm(6, 24), jfull.AccumFullGmm(6, 24)
    ta.accumulate(tf, x)
    ja.accumulate(jf, x)
    up_t = tfull.mle_full_gmm_update(tf, ta, min_gaussian_occupancy=1.0,
                                     device="cpu")
    up_j = jfull.mle_full_gmm_update(jf, ja, min_gaussian_occupancy=1.0)
    np.testing.assert_allclose(up_t.covars, up_j.covars, rtol=1e-9)
    assert isinstance(tdiag.DiagGmm.from_stats(x.mean(0), x.var(0)),
                      tdiag.DiagGmm)


def test_ivector_extractor_copy_equals_jax(su):
    tx, jx = su["tx"], su["jx"]
    for f in ("means", "inv_covars", "weights", "M"):
        np.testing.assert_array_equal(getattr(tx, f), getattr(jx, f))
    assert tx.prior_offset == jx.prior_offset and \
        tx.ivector_dim == jx.ivector_dim
    x = _frames()
    post = tx.frame_posteriors(x, 3, 0.05)
    np.testing.assert_array_equal(post, jx.frame_posteriors(x, 3, 0.05))
    g, X = tx.utterance_stats(x, post)
    np.testing.assert_array_equal(g, jx.utterance_stats(x, post)[0])
    for a, b in zip(tx.extract(g, X), jx.extract(g, X)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    ts, js = text.IvectorStats(tx, "cpu"), jext.IvectorStats(jx)
    ts.accumulate(tx, g, X)
    js.accumulate(jx, g, X)
    np.testing.assert_allclose(ts.B, js.B, rtol=1e-12)
    utts = [_frames(s, 40) for s in (20, 21, 22)]
    tubm = tdiag.DiagGmm(jx.weights, jx.means,
                         1.0 / np.einsum("idd->id", jx.inv_covars))
    # the host's gselect posteriors, as JAX's loop takes them (the batch
    # path's own come from f32 GEMM loglikes: tests/test_torch_ivector.py)
    host = text.IvectorExtractor(tubm, 3, seed=2)
    tt = text.train_ivector_extractor(
        tubm, utts, 3, num_iters=2, seed=2, num_gselect=4, device="cpu",
        posts=[host.frame_posteriors(f, 4) for f in utts])
    jt = jext.train_ivector_extractor(jdiag.DiagGmm(jx.weights, jx.means,
                                                    1.0 / np.einsum(
                                                        "idd->id",
                                                        jx.inv_covars)),
                                      utts, 3, num_iters=2, seed=2,
                                      num_gselect=4)
    np.testing.assert_allclose(tt.M, jt.M, rtol=1e-9, atol=1e-12)


def test_online_ivector_feature_copy_equals_jax(su):
    x = _frames(T=45)
    cfg = dict(num_gselect=4, posterior_scale=0.2, max_count=20.0,
               use_most_recent_ivector=False, ivector_period=5)
    t = tivec.OnlineIvectorFeature(su["tx"], tivec.OnlineIvectorConfig(**cfg))
    j = jivec.OnlineIvectorFeature(su["jx"], jivec.OnlineIvectorConfig(**cfg))
    for lo, hi in ((0, 12), (12, 13), (13, 45)):
        t.accept_features(x[lo:hi])
        j.accept_features(x[lo:hi])
    w = np.where(np.arange(30) % 4 == 0, 0.0, 1.0)
    t.update_frame_weights(w)
    j.update_frame_weights(w)
    np.testing.assert_array_equal(t.gamma, j.gamma)
    for f in (0, 7, 44):
        np.testing.assert_array_equal(t.get_frame(f), j.get_frame(f))
    ts, js = t.get_adaptation_state(), j.get_adaptation_state()
    np.testing.assert_array_equal(ts.X, js.X)
    sw_t = tivec.OnlineSilenceWeighting(_Tm, {0}, 0.25)
    sw_j = jivec.OnlineSilenceWeighting(_Tm, {0}, 0.25)
    tids = list(range(1, 20))
    np.testing.assert_array_equal(sw_t.weights_from_alignment(tids),
                                  sw_j.weights_from_alignment(tids))
