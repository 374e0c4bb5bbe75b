"""Port parity: kaldi_tpu_torch fbank + CMVN against kaldi_tpu on the CPU.

The same numpy waveforms go through both packages. Tolerance rtol 2e-4 /
atol 2e-3, the bar of test_features.py's numpy MFCC oracle: the two
frameworks sum the DC mean, FFT and mel matmul in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.ops import FbankOpts as JFbankOpts, FrameOpts as JFrameOpts, \
    MelOpts as JMelOpts, fbank as jfbank
from kaldi_tpu.ops.mel import _mel_banks_np as j_mel_banks_np
from kaldi_tpu.ops.window import _frame_index_matrix as j_frame_index
from kaldi_tpu_torch.ops import window as twin
from kaldi_tpu_torch.ops.features import FbankOpts, cmvn, fbank
from kaldi_tpu_torch.ops.mel import MelOpts, mel_banks
from kaldi_tpu_torch.ops.window import FrameOpts

torch.set_num_threads(2)


def _waves(seed=0, n=2, secs=1.0):
    rng = np.random.default_rng(seed)
    S = int(16000 * secs)
    t = np.arange(S) / 16000.0
    w = 3000 * np.sin(2 * np.pi * rng.uniform(200, 3000, (n, 1)) * t)
    return (w + 300 * rng.standard_normal((n, S))).astype(np.float32)


def _opts(snip_edges):
    kw = dict(samp_freq=16000.0, dither=0.0, snip_edges=snip_edges)
    return (FbankOpts(frame_opts=FrameOpts(**kw), mel_opts=MelOpts(num_bins=40)),
            JFbankOpts(frame_opts=JFrameOpts(**kw),
                       mel_opts=JMelOpts(num_bins=40)))


@pytest.mark.parametrize("snip_edges", [True, False])
def test_fbank_cmvn_match_jax(snip_edges):
    waves = _waves()
    topts, jopts = _opts(snip_edges)
    got = fbank(torch.from_numpy(waves), topts)
    want = np.asarray(jfbank(jnp.asarray(waves), jopts))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3)
    # bench.py's per-utterance CMVN: population std over time
    mu = want.mean(axis=1, keepdims=True)
    sd = want.std(axis=1, keepdims=True)
    np.testing.assert_allclose(cmvn(got).numpy(), (want - mu) / (sd + 1e-5),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("snip_edges", [True, False])
def test_frame_index_and_mel_banks_equal(snip_edges):
    fo = FrameOpts(snip_edges=snip_edges)
    jfo = JFrameOpts(snip_edges=snip_edges)
    for n_samp in (400, 1000, 16000):
        F = twin.num_frames(n_samp, fo)
        np.testing.assert_array_equal(twin._frame_index_matrix(n_samp, F, fo),
                                      j_frame_index(n_samp, F, jfo))
    np.testing.assert_array_equal(
        mel_banks(MelOpts(num_bins=40), fo).numpy(),
        j_mel_banks_np(JMelOpts(num_bins=40), jfo, 1.0))


def test_energy_and_htk_options_match_jax():
    waves = _waves(seed=1, n=1)
    kw = dict(dither=0.0, window_type="hamming")
    topts = FbankOpts(frame_opts=FrameOpts(**kw), use_energy=True,
                      htk_compat=True, energy_floor=1.0)
    jopts = JFbankOpts(frame_opts=JFrameOpts(**kw), use_energy=True,
                       htk_compat=True, energy_floor=1.0)
    np.testing.assert_allclose(
        fbank(torch.from_numpy(waves), topts).numpy(),
        np.asarray(jfbank(jnp.asarray(waves), jopts)), rtol=2e-4, atol=2e-3)


def test_dither_only_with_generator():
    waves = torch.from_numpy(_waves(n=1))
    opts = FbankOpts(frame_opts=FrameOpts(dither=1.0))
    plain = fbank(waves, opts)
    assert torch.equal(plain, fbank(waves, opts))
    a = fbank(waves, opts, generator=torch.Generator().manual_seed(0))
    b = fbank(waves, opts, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, plain)
