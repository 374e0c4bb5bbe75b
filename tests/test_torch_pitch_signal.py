"""Port parity: kaldi_tpu_torch.ops.signal, resample, pitch and sinusoid
against kaldi_tpu's, on the CPU.

Both packages return float32 from f64 arithmetic. The port's f64 results
(`fft_convolve`, `LinearResample.resample_tensor`, `_nccf`) are held
within 1e-12 of max |y| of JAX's f64 arithmetic (its formula on its own
filters, or its `_nccf`), and the float32 outputs within 1e-12 of max |y|
of JAX's. The filters are host code and equal JAX's exactly. The pitch
Viterbi runs in f32 as JAX's does (x64 off): on every frame of
tests/test_signal_pitch.py's signals the path, and so the pitch and the
voiced/unvoiced NCCF, equal JAX's; on seeded costs with ties too.
`process_pitch` is within 1e-9 of JAX's, `reverberate` with JAX's
`RandomState` within 1e-6 of max |y| (its output is f32). Then
tests/test_signal_pitch.py's contracts on the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kaldi_tpu.ops import pitch as jp
from kaldi_tpu.ops import resample as jr
from kaldi_tpu.ops import signal as js
from kaldi_tpu.ops import sinusoid as jsin
from kaldi_tpu_torch.ops import pitch as tp
from kaldi_tpu_torch.ops import resample as tr
from kaldi_tpu_torch.ops import signal as ts
from kaldi_tpu_torch.ops import sinusoid as tsin

torch.set_num_threads(2)

SR = 16000.0


def _close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64)))) \
        <= rel * scale


def _signals():
    """tests/test_signal_pitch.py's pitch signals: three tones, noise and
    the 150 Hz tone of its process_pitch test."""
    out = []
    for f0, secs in ((120.0, 0.6), (220.0, 0.6), (330.0, 0.6),
                     (150.0, 0.5)):
        t = np.arange(int(SR * secs)) / SR
        out.append((np.sin(2 * np.pi * f0 * t) * 5000).astype(np.float32))
    out.append((np.random.RandomState(2).randn(8000) * 100)
               .astype(np.float32))
    return out


@pytest.mark.parametrize("n,k", [(500, 32), (4000, 100), (16000, 4800)])
def test_convolution_equals_jax(n, k):
    rng = np.random.RandomState(n)
    x = rng.randn(n).astype(np.float32)
    h = rng.randn(k).astype(np.float32)
    nfft = 1 << (n + k - 2).bit_length()
    want64 = np.fft.irfft(np.fft.rfft(x.astype(np.float64), nfft)
                          * np.fft.rfft(h.astype(np.float64), nfft),
                          nfft)[:n]
    got64 = ts.fft_convolve(torch.from_numpy(x).double(),
                            torch.from_numpy(h).double(), n)
    _close(got64.numpy(), want64, 1e-12)
    _close(ts.convolve_signals(x, h, device="cpu"),
           js.convolve_signals(x, h), 1e-12)
    _close(ts.convolve_signals(x, h, device="cpu"), np.convolve(x, h)[:n],
           1e-5)


@pytest.mark.parametrize("rates", [(16000, 8000), (8000, 16000),
                                   (16000, 4000), (44100, 16000)])
def test_linear_resample_equals_jax(rates):
    rin, rout = rates
    jrs, trs = jr.LinearResample(rin, rout), tr.LinearResample(rin, rout)
    assert np.array_equal(trs.filters, jrs.filters)
    assert np.array_equal(trs.first_index, jrs.first_index)
    rng = np.random.RandomState(rin // 100 + rout // 100)
    for shape in ((4001,), (3, 2399)):
        x = rng.randn(*shape) * 1000
        # JAX's own f64 arithmetic: its per-phase loop on its filters
        xb = np.atleast_2d(x)
        n_out = len(jrs.resample(xb[0]))
        pad = jrs.half_width + jrs.in_step + 1
        padded = np.pad(xb, ((0, 0), (pad, pad)))
        want64 = np.zeros((xb.shape[0], n_out))
        L = jrs.filters.shape[1]
        for phase in range(jrs.out_step):
            ks = np.arange(phase, n_out, jrs.out_step)
            starts = (ks // jrs.out_step) * jrs.in_step + \
                jrs.first_index[phase] + pad
            want64[:, ks] = padded[:, starts[:, None] + np.arange(L)] @ \
                jrs.filters[phase]
        got64 = trs.resample_tensor(torch.from_numpy(xb))
        _close(got64.numpy(), want64, 1e-12)
        got = trs.resample(x, device="cpu")
        want = jrs.resample(x)
        assert got.shape == want.shape and got.dtype == np.float32
        _close(got, want, 1e-12)
    _close(tr.resample_waveform(x, rin, rout, device="cpu"),
           jr.resample_waveform(x, rin, rout), 1e-12)


def test_arbitrary_resample_equals_jax():
    x = np.sin(2 * np.pi * 50.0 * np.arange(1000) / 1000.0)
    pts = np.array([0.1, 0.25, 0.333, 0.5, 0.9995])
    ja = jr.ArbitraryResample(len(x), 1000.0, 400.0, pts)
    ta = tr.ArbitraryResample(len(x), 1000.0, 400.0, pts)
    assert np.array_equal(ta.indices, ja.indices)
    assert np.array_equal(ta.weights, ja.weights)
    _close(ta.resample(x, device="cpu"), ja.resample(x), 1e-12)
    _close(ta.resample(np.stack([x, -x]), device="cpu"),
           ja.resample(np.stack([x, -x])), 1e-12)
    np.testing.assert_allclose(ta.resample(x, device="cpu")[:4],
                               np.sin(2 * np.pi * 50.0 * pts[:4]), atol=0.01)


def test_nccf_equals_jax():
    opts = tp.PitchOpts()
    for wave in _signals():
        x = jr.LinearResample(SR, opts.resample_freq,
                              filter_cutoff=opts.lowpass_cutoff) \
            .resample(wave).astype(np.float64)
        win, max_lag = 100, 80
        lags = np.arange(10, max_lag + 1)
        T = 1 + (len(x) - win - max_lag) // 40
        idx = (np.arange(T) * 40)[:, None] + np.arange(win + max_lag)
        ballast = 7000.0 * float(np.mean(x * x)) * win
        want = jp._nccf(x[idx], lags, win, ballast)
        got = tp._nccf(torch.from_numpy(x[idx]), lags, win, ballast)
        _close(got.numpy(), want, 1e-12)


def test_pitch_equals_jax_on_every_frame():
    """The whole tracker: the same path on every frame (so the same pitch
    and voicing); its float32 NCCF within one f32 rounding (1e-7 of its
    scale), its processed features within 1e-9."""
    for wave in _signals():
        want = jp.compute_kaldi_pitch(wave, jp.PitchOpts(samp_freq=SR))
        got = tp.compute_kaldi_pitch(wave, tp.PitchOpts(samp_freq=SR),
                                     device="cpu")
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.array_equal(got[:, 1], want[:, 1])
        assert np.array_equal(got[:, 0] > 0.5, want[:, 0] > 0.5)
        _close(got[:, 0], want[:, 0], 1e-7)
        _close(tp.process_pitch(got), jp.process_pitch(want), 1e-9)


def test_viterbi_equals_jax_with_ties():
    rng = np.random.RandomState(3)
    for T, L in ((1, 5), (7, 3), (60, 71)):
        # coarse costs give many exact ties; the first minimum must win
        costs = np.round(rng.rand(T, L) * 4) / 4
        trans = np.round(rng.rand(L, L) * 2) / 2
        want = np.asarray(jp._viterbi_lags(jnp.asarray(costs),
                                           jnp.asarray(trans)))
        got = tp._viterbi_lags(torch.from_numpy(costs).float(),
                               torch.from_numpy(trans).float())
        assert np.array_equal(got, want), (T, L)
    costs = np.full((3, 3), 100.0)
    costs[0, 0] = costs[1, 1] = costs[2, 2] = 0.0
    assert tp._viterbi_lags(torch.from_numpy(costs).float(),
                            torch.zeros(3, 3)).tolist() == [0, 1, 2]


def test_reverberate_equals_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(4000).astype(np.float32) * 100
    rir = (np.exp(-np.arange(480) / 80.0)
           * rng.randn(480)).astype(np.float32)
    for snr in (None, 20.0, 15.0):
        want = js.reverberate(x, rir, snr_db=snr,
                              rng=np.random.RandomState(5))
        got = ts.reverberate(x, rir, snr_db=snr,
                             rng=np.random.RandomState(5), device="cpu")
        assert got.shape == x.shape and got.dtype == np.float32
        _close(got, want, 1e-6)


def test_sinusoid_equals_jax():
    t = np.arange(4000) / 8000.0
    x = np.sin(2 * np.pi * 697 * t) + 0.5 * np.sin(2 * np.pi * 1209 * t)
    got = tsin.detect_tones(x, 8000.0)
    want = jsin.detect_tones(x, 8000.0)
    assert [(t0, [(s.freq, s.amplitude, s.phase) for s in ss])
            for t0, ss in got] == [
        (t0, [(s.freq, s.amplitude, s.phase) for s in ss])
        for t0, ss in want]


def test_signal_pitch_contracts():
    """tests/test_signal_pitch.py's oracle checks on the port."""
    t = np.arange(16000) / SR
    x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    y = tr.resample_waveform(x, SR, 8000.0, device="cpu")
    assert abs(len(y) - 8000) <= 1
    want = np.sin(2 * np.pi * 440.0 * np.arange(len(y)) / 8000.0)
    assert np.max(np.abs(y[100:-100] - want[100:-100])) < 0.01
    rs = tr.LinearResample(16000, 8000)
    assert len(rs.resample(np.zeros(239), device="cpu")) == 120
    assert len(rs.resample(np.zeros(240), device="cpu")) == 120
    for f0 in (120.0, 220.0, 330.0):
        tt = np.arange(int(SR * 0.6)) / SR
        out = tp.compute_kaldi_pitch(
            (np.sin(2 * np.pi * f0 * tt) * 5000).astype(np.float32),
            tp.PitchOpts(samp_freq=SR), device="cpu")
        assert out.shape[0] > 30
        assert abs(np.median(out[10:-10, 1]) - f0) / f0 < 0.05
        assert np.median(out[10:-10, 0]) > 0.7
    noise = (np.random.RandomState(2).randn(8000) * 100).astype(np.float32)
    assert np.median(tp.compute_kaldi_pitch(noise, device="cpu")[:, 0]) < 0.5
    feats = tp.process_pitch(np.array([[0.9, 200.0], [-0.9, 200.0]],
                                      np.float32))
    assert abs(feats[0, 0] - 2.0 * ((1.0001 - 0.9) ** 0.15 - 1.0)) < 1e-4
    assert abs(feats[1, 0] - 2.0 * ((1.0001 + 0.9) ** 0.15 - 1.0)) < 1e-4
    rng = np.random.RandomState(0)
    x = rng.randn(500).astype(np.float32)
    h = rng.randn(32).astype(np.float32)
    np.testing.assert_allclose(ts.convolve_signals(x, h, device="cpu"),
                               np.convolve(x, h)[:500], rtol=1e-4, atol=1e-4)


def test_card_bounds_cover_another_summation_order():
    """chip_smoke's bounds of phases 29-30 (`fft_conv_bound`,
    `resample_bound`, `nccf_bound`) cover the port's CPU results against
    JAX's numpy arithmetic (another FFT and summation order), and stay far
    below f32 rounding (under 1e-9 of max |y|)."""
    import chip_smoke as cs
    opts = tp.PitchOpts()
    rir = cs.seeded_rir(1600, 0.1, 29)
    rs8 = tr.LinearResample(SR, 8000.0)
    jrs8 = jr.LinearResample(SR, 8000.0)
    for w in _signals():
        x = w.astype(np.float64)
        nfft = 1 << (len(x) + len(rir) - 2).bit_length()
        want = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(
            rir.astype(np.float64), nfft), nfft)[:len(x)]
        got = ts.fft_convolve(torch.from_numpy(x), torch.from_numpy(
            rir.astype(np.float64)), len(x)).numpy()
        b = cs.fft_conv_bound(x, rir)
        assert np.max(np.abs(got - want)) <= b < 1e-9 * np.abs(want).max()
        b = cs.resample_bound(rs8, x)
        got = rs8.resample_tensor(torch.from_numpy(x)).numpy()
        want = jrs8.resample(x).astype(np.float64)
        # JAX rounds to f32: compare the f64 sums through the same rounding
        assert np.all(np.abs(got.astype(np.float32) - want)
                      <= b + np.abs(want) * 2.0 ** -24)
        assert b.max() < 1e-9 * np.abs(got).max()
        x4 = tr.LinearResample(SR, opts.resample_freq,
                               filter_cutoff=opts.lowpass_cutoff).resample(
            w, device="cpu").astype(np.float64)
        lags = np.arange(10, 81)
        T = 1 + (len(x4) - 180) // 40
        fr = x4[(np.arange(T) * 40)[:, None] + np.arange(180)]
        bal = 7000.0 * float(np.mean(x4 * x4)) * 100
        b = cs.nccf_bound(fr, lags, 100, bal)
        got = tp._nccf(torch.from_numpy(fr), lags, 100, bal).numpy()
        assert np.all(np.abs(got - jp._nccf(fr, lags, 100, bal)) <= b)
        assert b.max() < 1e-9
    f = cs.features_card_vs_cpu(_signals()[:2], card="cpu")
    assert f["viterbi frames"] == f["pitch frames"] == 0 and f["frames"]
