"""Port parity: MFCC, PLP, spectrogram, deltas, splicing, shifted deltas,
sliding CMVN, CMVN stats and the online feature classes of
kaldi_tpu_torch against kaldi_tpu, on the CPU, on the same seeded numpy
waves.

Tolerance rtol 2e-4 / atol 2e-3 (tests/test_torch_features.py's bar): the
two frameworks sum the DC mean, the FFT and the mel, DCT and IDFT
products in different orders. Deltas, splicing and CMVN of equal inputs
are held to 1e-6: the same f32 taps in the same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.ops import delta as jdelta
from kaldi_tpu.ops import dct as jdct
from kaldi_tpu.ops import features as jfeat
from kaldi_tpu.ops.mel import MelOpts as JMelOpts
from kaldi_tpu.ops.window import FrameOpts as JFrameOpts
from kaldi_tpu.online import features as jonline
from kaldi_tpu.transform import cmvn as jcmvn
from kaldi_tpu_torch.ops import dct as tdct
from kaldi_tpu_torch.ops import delta as tdelta
from kaldi_tpu_torch.ops import features as tfeat
from kaldi_tpu_torch.ops.mel import MelOpts
from kaldi_tpu_torch.ops.window import FrameOpts
from kaldi_tpu_torch.online import features as tonline
from kaldi_tpu_torch.transform import cmvn as tcmvn

torch.set_num_threads(2)

FEAT_TOL = dict(rtol=2e-4, atol=2e-3)
EXACT_TOL = dict(rtol=1e-6, atol=1e-6)


def _waves(seed=0, n=2, S=9000):
    rng = np.random.default_rng(seed)
    t = np.arange(S) / 16000.0
    w = 3000 * np.sin(2 * np.pi * rng.uniform(200, 3000, (n, 1)) * t)
    return (w + 300 * rng.standard_normal((n, S))).astype(np.float32)


def _jopts(opts):
    """The JAX options dataclass with the same fields as a port one."""
    cls = {tfeat.MfccOpts: jfeat.MfccOpts, tfeat.PlpOpts: jfeat.PlpOpts,
           tfeat.FbankOpts: jfeat.FbankOpts,
           tfeat.SpectrogramOpts: jfeat.SpectrogramOpts}[type(opts)]
    kw = {}
    for f in dataclasses.fields(opts):
        v = getattr(opts, f.name)
        if isinstance(v, FrameOpts):
            v = JFrameOpts(**dataclasses.asdict(v))
        elif isinstance(v, MelOpts):
            v = JMelOpts(**dataclasses.asdict(v))
        kw[f.name] = v
    return cls(**kw)


FO = FrameOpts(dither=0.0)
FEATURES = {
    "mfcc": (tfeat.mfcc, jfeat.mfcc, tfeat.MfccOpts(frame_opts=FO)),
    "mfcc_no_energy_htk": (tfeat.mfcc, jfeat.mfcc, tfeat.MfccOpts(
        frame_opts=FO, use_energy=False, htk_compat=True)),
    "mfcc_energy_htk_floor": (tfeat.mfcc, jfeat.mfcc, tfeat.MfccOpts(
        frame_opts=dataclasses.replace(FO, window_type="hamming"),
        mel_opts=MelOpts(num_bins=26, low_freq=0.0, htk_mode=True),
        htk_compat=True, raw_energy=False, energy_floor=1.0)),
    "plp": (tfeat.plp, jfeat.plp, tfeat.PlpOpts(frame_opts=FO)),
    "plp_htk_scaled": (tfeat.plp, jfeat.plp, tfeat.PlpOpts(
        frame_opts=FO, htk_compat=True, use_energy=False,
        cepstral_scale=1.5, num_ceps=10)),
    "spectrogram": (tfeat.spectrogram, jfeat.spectrogram,
                    tfeat.SpectrogramOpts(frame_opts=FO)),
    "spectrogram_post_window": (tfeat.spectrogram, jfeat.spectrogram,
                                tfeat.SpectrogramOpts(frame_opts=FO,
                                                      raw_energy=False,
                                                      energy_floor=2.0)),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_features_match_jax(name):
    tfn, jfn, opts = FEATURES[name]
    waves = _waves()
    got = tfn(torch.from_numpy(waves), opts).numpy()
    want = np.asarray(jfn(jnp.asarray(waves), _jopts(opts)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FEAT_TOL)
    if hasattr(opts, "dim"):
        assert tfeat.feature_dim(opts) == got.shape[-1]
    assert tfeat.compute_num_frames(waves.shape[1], opts) == got.shape[1] \
        == jfeat.compute_num_frames(waves.shape[1], _jopts(opts))


def test_dct_lifter_and_idft_constants_equal():
    np.testing.assert_array_equal(tdct.dct_matrix(13, 23).numpy(),
                                  np.asarray(jdct.dct_matrix(13, 23)))
    np.testing.assert_array_equal(tdct.lifter_coeffs(22.0, 13).numpy(),
                                  np.asarray(jdct.lifter_coeffs(22.0, 13)))
    np.testing.assert_array_equal(tfeat._idft_bases_np(13, 25),
                                  jfeat._idft_bases_np(13, 25))


def test_durbin_and_lpc_to_cepstrum_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 40))
    ac = np.stack([np.correlate(r, r, "full")[39:52] for r in x]) \
        .astype(np.float32)
    lpc, E = tfeat._durbin(torch.from_numpy(ac), 12)
    jlpc, jE = jfeat._durbin(jnp.asarray(ac), 12)
    np.testing.assert_allclose(lpc.numpy(), np.asarray(jlpc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(E.numpy(), np.asarray(jE), rtol=1e-5)
    np.testing.assert_allclose(
        tfeat._lpc_to_cepstrum(lpc, 12).numpy(),
        np.asarray(jfeat._lpc_to_cepstrum(jlpc, 12)), rtol=1e-5, atol=1e-5)
    f = np.random.default_rng(4).standard_normal((5, 13)).astype(np.float32)
    for c0 in (True, False):
        np.testing.assert_allclose(
            tfeat._htk_reorder(torch.from_numpy(f), c0).numpy(),
            np.asarray(jfeat._htk_reorder(jnp.asarray(f), c0)), **EXACT_TOL)


def _feats(seed=5, T=57, D=6):
    return np.random.default_rng(seed).standard_normal((2, T, D)) \
        .astype(np.float32)


@pytest.mark.parametrize("order,window", [(2, 2), (1, 3), (0, 2)])
def test_add_deltas_matches_jax(order, window):
    x = _feats()
    np.testing.assert_allclose(
        tdelta.add_deltas(torch.from_numpy(x), order, window).numpy(),
        np.asarray(jdelta.add_deltas(jnp.asarray(x), order, window)),
        **EXACT_TOL)


@pytest.mark.parametrize("lr", [(3, 2), (0, 4), (5, 0)])
def test_splice_frames_matches_jax(lr):
    x = _feats()
    np.testing.assert_array_equal(
        tdelta.splice_frames(torch.from_numpy(x), *lr).numpy(),
        np.asarray(jdelta.splice_frames(jnp.asarray(x), *lr)))


@pytest.mark.parametrize("kw", [dict(), dict(order=2, window=2,
                                             block_shift=2, num_blocks=4)])
def test_shifted_delta_matches_jax(kw):
    x = _feats()
    np.testing.assert_allclose(
        tdelta.shifted_delta(torch.from_numpy(x), **kw).numpy(),
        np.asarray(jdelta.shifted_delta(jnp.asarray(x), **kw)), **EXACT_TOL)


@pytest.mark.parametrize("kw", [
    dict(cmn_window=20, min_window=5),
    dict(cmn_window=20, min_window=5, normalize_variance=True),
    dict(cmn_window=16, center=True, normalize_variance=True),
    dict(cmn_window=100, min_window=100),      # window past the utterance
])
def test_sliding_cmvn_matches_jax(kw):
    x = _feats(T=57) * 3 + 1
    np.testing.assert_allclose(
        tdelta.sliding_cmvn(torch.from_numpy(x),
                            tdelta.SlidingCmvnOpts(**kw)).numpy(),
        np.asarray(jdelta.sliding_cmvn(jnp.asarray(x),
                                       jdelta.SlidingCmvnOpts(**kw))),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("norm_vars,reverse", [(False, False), (True, False),
                                               (True, True), (False, True)])
def test_cmvn_stats_and_apply_match_jax(norm_vars, reverse):
    x = _feats()[0] * 2 + 3
    w = np.random.default_rng(6).uniform(0, 1, x.shape[0])
    t, j = tcmvn.CmvnStats(x.shape[1]), jcmvn.CmvnStats(x.shape[1])
    for s in (t, j):
        s.accumulate(x)
        s.accumulate(x[:20], weights=w[:20])
    t2 = tcmvn.CmvnStats(x.shape[1])
    t2.accumulate(torch.from_numpy(x[5:9]))
    j2 = jcmvn.CmvnStats(x.shape[1])
    j2.accumulate(x[5:9])
    t.add(t2)
    j.add(j2)
    np.testing.assert_array_equal(t.stats, j.stats)
    assert t.stats.dtype == np.float64 and t.count == j.count
    got = tcmvn.apply_cmvn(torch.from_numpy(x), t, norm_vars, reverse)
    want = np.asarray(jcmvn.apply_cmvn(x, j, norm_vars, reverse))
    np.testing.assert_allclose(got.numpy(), want, **EXACT_TOL)


# ------------------------------------------------------ online classes

ONLINE_OPTS = {
    "mfcc": (tfeat.mfcc, jfeat.mfcc, tfeat.MfccOpts(frame_opts=FO)),
    "plp": (tfeat.plp, jfeat.plp, tfeat.PlpOpts(frame_opts=FO)),
    "fbank": (tfeat.fbank, jfeat.fbank, tfeat.FbankOpts(
        frame_opts=FO, mel_opts=MelOpts(num_bins=20))),
}
CHUNKS = [1000, 37, 2500, 160, 4321, 399, 7000]


def _feed(feat, wave, sizes):
    pos, i = 0, 0
    while pos < len(wave):
        n = sizes[i % len(sizes)]
        feat.accept_waveform(wave[pos:pos + n])
        pos, i = pos + n, i + 1
    feat.input_finished()


@pytest.mark.parametrize("name", sorted(ONLINE_OPTS))
def test_online_mfcc_uneven_chunks_match_jax_and_offline(name):
    tfn, jfn, opts = ONLINE_OPTS[name]
    wave = _waves(seed=7, n=1, S=16000)[0]
    t = tonline.OnlineMfcc(opts, computer=tfn, device="cpu")
    j = jonline.OnlineMfcc(_jopts(opts), computer=jfn)
    _feed(t, wave, CHUNKS)
    _feed(j, wave, CHUNKS)
    assert t.num_frames_ready() == j.num_frames_ready() > 0
    assert t.dim == j.dim
    got = t.get_frames(0, t.num_frames_ready())
    np.testing.assert_allclose(got, j.get_frames(0, j.num_frames_ready()),
                               **FEAT_TOL)
    np.testing.assert_allclose(got, tfn(torch.from_numpy(wave), opts).numpy(),
                               **FEAT_TOL)


def _cmvn_pair(with_priors: bool, **kw):
    if not with_priors:
        return (tonline.OnlineCmvn(tonline.OnlineCmvnOpts(**kw)),
                jonline.OnlineCmvn(jonline.OnlineCmvnOpts(**kw)))
    x = _feats(seed=8, T=80, D=13)[0] * 2 + 1
    spk, gl = (tcmvn.CmvnStats(13), tcmvn.CmvnStats(13))
    jspk, jgl = (jcmvn.CmvnStats(13), jcmvn.CmvnStats(13))
    for a, b in ((spk, jspk), (gl, jgl)):
        a.accumulate(x[:30] if a is spk else x)
        b.accumulate(x[:30] if b is jspk else x)
    return (tonline.OnlineCmvn(tonline.OnlineCmvnOpts(**kw), gl, spk),
            jonline.OnlineCmvn(jonline.OnlineCmvnOpts(**kw), jgl, jspk))


@pytest.mark.parametrize("with_priors,kw", [
    (False, dict(cmn_window=30)),
    (True, dict(cmn_window=40, speaker_frames=20, global_frames=15,
                normalize_variance=True)),
])
def test_online_cmvn_matches_jax(with_priors, kw):
    t, j = _cmvn_pair(with_priors, **kw)
    x = _feats(seed=9, T=70, D=13)[0]
    np.testing.assert_allclose(t.apply(x), j.apply(x), **EXACT_TOL)
    t.update_speaker_stats(x)
    j.update_speaker_stats(x)
    np.testing.assert_array_equal(t.get_state().stats, j.get_state().stats)
    t.freeze(np.ones(13), np.full(13, 4.0))
    j.freeze(np.ones(13), np.full(13, 4.0))
    np.testing.assert_allclose(t.apply(x), j.apply(x), **EXACT_TOL)


PIPELINES = {
    "deltas": dict(delta_order=2),
    "splice": dict(delta_order=0, splice=(-2, -1, 0, 1, 2)),
    "splice_right": dict(delta_order=0, splice=(0, 1, 2)),
    "cmvn_deltas": dict(delta_order=1, cmvn="cmvn"),
    "plain": dict(delta_order=0),
}


def _pipelines(kw):
    kw = dict(kw)
    tc = jc = None
    if kw.pop("cmvn", None):
        tc, jc = _cmvn_pair(False, cmn_window=50)
    opts = ONLINE_OPTS["mfcc"][2]
    return (tonline.OnlineFeaturePipeline(opts, cmvn=tc, device="cpu", **kw),
            jonline.OnlineFeaturePipeline(_jopts(opts), cmvn=jc, **kw))


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_online_pipeline_and_processed_feature_match_jax(name):
    """Fed in uneven chunks, the pipeline's complete frames and the
    processed-feature adapter's frames equal JAX's after every chunk, and
    at the end equal the offline post-processing of the whole utterance."""
    wave = _waves(seed=10, n=1, S=14000)[0]
    t, j = _pipelines(PIPELINES[name])
    tpipe, jpipe = _pipelines(PIPELINES[name])
    tp = tonline.OnlineProcessedFeature(tpipe)
    jp = jonline.OnlineProcessedFeature(jpipe)
    assert t.dim == j.dim == tp.dim and t.right_delay == j.right_delay
    pos, i = 0, 0
    while pos < len(wave):
        piece = wave[pos:pos + CHUNKS[i % len(CHUNKS)]]
        for f in (t, j, tp, jp):
            f.accept_waveform(piece)
        pos, i = pos + len(piece), i + 1
        assert tp.num_frames_ready() == jp.num_frames_ready()
        np.testing.assert_allclose(t.get_features(), j.get_features(),
                                   **FEAT_TOL)
        n = tp.num_frames_ready()
        np.testing.assert_allclose(tp.get_frames(0, n), jp.get_frames(0, n),
                                   **FEAT_TOL)
    for f in (t, j, tp, jp):
        f.input_finished()
    final = t.get_features()
    np.testing.assert_allclose(final, j.get_features(), **FEAT_TOL)
    n = tp.num_frames_ready()
    assert n == final.shape[0]
    np.testing.assert_allclose(tp.get_frames(0, n), final, **FEAT_TOL)
