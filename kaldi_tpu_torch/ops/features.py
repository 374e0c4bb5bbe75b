"""MFCC, fbank, PLP and spectrogram features, and per-utterance CMVN, on
tensors.

Counterpart of kaldi_tpu/ops/features.py (ref: feat/feature-mfcc.cc:117-200
Mfcc::ComputeInternal, feat/feature-fbank.cc, feat/feature-plp.cc:160-260
Plp::ComputeInternal, feat/feature-spectrogram.cc): one gather frames the
batch, one batched `torch.fft.rfft` gives the power spectrum, and the mel
bank, the DCT and PLP's IDFT are matmuls. The matmuls run in true f32 (TF32
off, see kaldi_tpu_torch.device): they sit under a log. Every function runs
on the wave's device; its constants are built there.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from kaldi_tpu_torch.ops.dct import dct_matrix, lifter_coeffs
from kaldi_tpu_torch.ops.mel import MelOpts, center_freqs, mel_banks
from kaldi_tpu_torch.ops.window import FrameOpts, extract_windows, num_frames

FLT_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class MfccOpts:
    """(ref: feat/feature-mfcc.h:37-84 MfccOptions)"""

    frame_opts: FrameOpts = FrameOpts()
    mel_opts: MelOpts = MelOpts()
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps


@dataclasses.dataclass(frozen=True)
class FbankOpts:
    """(ref: feat/feature-fbank.h FbankOptions)"""

    frame_opts: FrameOpts = FrameOpts()
    mel_opts: MelOpts = MelOpts()
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    htk_compat: bool = False
    use_log_fbank: bool = True

    @property
    def dim(self) -> int:
        return self.mel_opts.num_bins + (1 if self.use_energy else 0)


@dataclasses.dataclass(frozen=True)
class PlpOpts:
    """(ref: feat/feature-plp.h PlpOptions)"""

    frame_opts: FrameOpts = FrameOpts()
    mel_opts: MelOpts = MelOpts()
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps


@dataclasses.dataclass(frozen=True)
class SpectrogramOpts:
    """(ref: feat/feature-spectrogram.h SpectrogramOptions)"""

    frame_opts: FrameOpts = FrameOpts()
    energy_floor: float = 0.0
    raw_energy: bool = True


def _power_spectrum(windows: torch.Tensor) -> torch.Tensor:
    """[..., F, P] windowed frames -> [..., F, P/2+1] power spectrum."""
    spec = torch.fft.rfft(windows, dim=-1)
    return torch.square(spec.real) + torch.square(spec.imag)


def _window_energy(windows, use_energy, raw_energy, raw_log_energy, win_len):
    """Log energy, either raw (pre-window) or post-window."""
    if not use_energy:
        return None
    if raw_energy:
        return raw_log_energy
    e = torch.clamp(torch.sum(torch.square(windows[..., :win_len]), dim=-1),
                    min=FLT_TINY)
    return torch.log(e)


def _apply_energy_floor(log_energy, energy_floor):
    if energy_floor > 0.0:
        return torch.clamp(log_energy, min=math.log(energy_floor))
    return log_energy


def _htk_reorder(feats: torch.Tensor, scale_c0: bool) -> torch.Tensor:
    """Move element 0 to the end (HTK feature ordering)."""
    first = feats[..., :1]
    if scale_c0:
        first = first * math.sqrt(2.0)
    return torch.cat([feats[..., 1:], first], dim=-1)


def _mel_energies(wave, opts, vtln_warp, generator):
    """-> (mel energies [..., F, num_bins] floored at 1 in htk mode,
    log energy [..., F] or None)."""
    fo = opts.frame_opts
    windows, raw_le = extract_windows(
        wave, fo, generator,
        want_raw_energy=opts.use_energy and opts.raw_energy)
    log_energy = _window_energy(windows, opts.use_energy, opts.raw_energy,
                                raw_le, fo.window_size)
    power = _power_spectrum(windows)[..., : fo.padded_window_size // 2]
    banks = mel_banks(opts.mel_opts, fo, vtln_warp, device=wave.device)
    mel_e = torch.matmul(power, banks.T)
    if opts.mel_opts.htk_mode:
        mel_e = torch.clamp(mel_e, min=1.0)   # (ref: mel-computations.cc:231)
    return mel_e, log_energy


def mfcc(wave: torch.Tensor, opts: MfccOpts = MfccOpts(),
         vtln_warp: float = 1.0,
         generator: torch.Generator | None = None) -> torch.Tensor:
    """wave [..., S] f32 -> mfcc [..., F, num_ceps], on the wave's device."""
    mel_e, log_energy = _mel_energies(wave, opts, vtln_warp, generator)
    dev = wave.device
    log_mel = torch.log(torch.clamp(mel_e, min=FLT_TINY))
    dct = dct_matrix(opts.num_ceps, opts.mel_opts.num_bins, device=dev)
    feats = torch.matmul(log_mel, dct.T)
    if opts.cepstral_lifter != 0.0:
        feats = feats * lifter_coeffs(opts.cepstral_lifter, opts.num_ceps,
                                      device=dev)
    if opts.use_energy:
        log_energy = _apply_energy_floor(log_energy, opts.energy_floor)
        feats = torch.cat([log_energy[..., None], feats[..., 1:]], dim=-1)
    if opts.htk_compat:
        feats = _htk_reorder(feats, scale_c0=not opts.use_energy)
    return feats


def fbank(wave: torch.Tensor, opts: FbankOpts = FbankOpts(),
          vtln_warp: float = 1.0,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """wave [..., S] f32 -> (log-)mel filterbank [..., F, num_bins(+1)],
    on the wave's device."""
    mel_e, log_energy = _mel_energies(wave, opts, vtln_warp, generator)
    if opts.use_log_fbank:
        mel_e = torch.log(torch.clamp(mel_e, min=FLT_TINY))
    if opts.use_energy:
        log_energy = _apply_energy_floor(log_energy, opts.energy_floor)
        # energy goes FIRST in kaldi mode, LAST in htk_compat mode
        if opts.htk_compat:
            return torch.cat([mel_e, log_energy[..., None]], dim=-1)
        return torch.cat([log_energy[..., None], mel_e], dim=-1)
    return mel_e


def spectrogram(wave: torch.Tensor,
                opts: SpectrogramOpts = SpectrogramOpts(),
                generator: torch.Generator | None = None) -> torch.Tensor:
    """wave [..., S] -> log power spectrogram [..., F, P/2+1] with the log
    energy at index 0."""
    fo = opts.frame_opts
    windows, raw_le = extract_windows(wave, fo, generator,
                                      want_raw_energy=opts.raw_energy)
    log_energy = _window_energy(windows, True, opts.raw_energy, raw_le,
                                fo.window_size)
    log_energy = _apply_energy_floor(log_energy, opts.energy_floor)
    power = _power_spectrum(windows)
    log_power = torch.log(torch.clamp(power, min=FLT_TINY))
    return torch.cat([log_energy[..., None], log_power[..., 1:]], dim=-1)


@functools.lru_cache(maxsize=None)
def _idft_bases_np(n_bases: int, dimension: int) -> np.ndarray:
    """IDFT bases for PLP autocorrelation (ref: feature-functions.cc:360-373)."""
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases, dtype=np.float64)[:, None]
    j = np.arange(dimension, dtype=np.float64)[None, :]
    m = 2.0 * scale * np.cos(angle * i * j)
    m[:, 0] = scale
    m[:, -1] = scale * np.cos(angle * i[:, 0] * (dimension - 1))
    return m.astype(np.float32)


def _durbin(autocorr: torch.Tensor, order: int):
    """Levinson-Durbin over leading dims: autocorr [..., order+1] -> (lpc
    [..., order], final prediction error [...]) (ref:
    mel-computations.cc:262-292 Durbin). The coefficients are a list of
    [...] tensors while the recursion runs."""
    E = autocorr[..., 0]
    lpc: list[torch.Tensor] = []
    for i in range(order):
        ki = autocorr[..., i + 1]
        for j in range(i):
            ki = ki + lpc[j] * autocorr[..., i - j]
        ki = ki / E
        E = E * torch.clamp(1.0 - ki * ki, min=1.0e-5)
        lpc = [lpc[j] - ki * lpc[i - j - 1] for j in range(i)] + [-ki]
    return torch.stack(lpc, dim=-1), E


def _lpc_to_cepstrum(lpc: torch.Tensor, order: int) -> torch.Tensor:
    """LPC -> cepstrum recursion (ref: mel-computations.cc:295-304 Lpc2Cepstrum)."""
    ceps = []
    for i in range(order):
        s = torch.zeros(lpc.shape[:-1], dtype=lpc.dtype, device=lpc.device)
        for j in range(i):
            s = s + (i - j) * lpc[..., j] * ceps[i - j - 1]
        ceps.append(-lpc[..., i] - s / (i + 1))
    return torch.stack(ceps, dim=-1)


def plp(wave: torch.Tensor, opts: PlpOpts = PlpOpts(),
        vtln_warp: float = 1.0,
        generator: torch.Generator | None = None) -> torch.Tensor:
    """wave [..., S] -> PLP cepstra [..., F, num_ceps].

    (ref: feat/feature-plp.cc:160-260 Plp::ComputeInternal)
    """
    if opts.num_ceps > opts.lpc_order + 1:
        raise ValueError(f"num_ceps {opts.num_ceps} > lpc_order + 1")
    dev = wave.device
    mel_e, log_energy = _mel_energies(wave, opts, vtln_warp, generator)
    # equal loudness (ref: feature-functions.cc:345-356)
    f0 = center_freqs(opts.mel_opts, opts.frame_opts, vtln_warp)
    fsq = f0 * f0
    fsub = fsq / (fsq + 1.6e5)
    eql = (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(np.float32)
    mel_e = mel_e * torch.as_tensor(eql, device=dev)
    mel_e = torch.pow(torch.clamp(mel_e, min=FLT_TINY), opts.compress_factor)
    # duplicate first/last, IDFT -> autocorrelation
    dup = torch.cat([mel_e[..., :1], mel_e, mel_e[..., -1:]], dim=-1)
    idft = torch.as_tensor(_idft_bases_np(opts.lpc_order + 1,
                                          opts.mel_opts.num_bins + 2),
                           device=dev)
    autocorr = torch.matmul(dup, idft.T)
    lpc, E = _durbin(autocorr, opts.lpc_order)
    lpc_energy = -torch.log(1.0 / torch.clamp(E, min=FLT_TINY))
    raw_ceps = _lpc_to_cepstrum(lpc, opts.lpc_order)
    feats = torch.cat([lpc_energy[..., None],
                       raw_ceps[..., : opts.num_ceps - 1]], dim=-1)
    if opts.cepstral_lifter != 0.0:
        feats = feats * lifter_coeffs(opts.cepstral_lifter, opts.num_ceps,
                                      device=dev)
    if opts.cepstral_scale != 1.0:
        feats = feats * opts.cepstral_scale
    if opts.use_energy:
        log_energy = _apply_energy_floor(log_energy, opts.energy_floor)
        feats = torch.cat([log_energy[..., None], feats[..., 1:]], dim=-1)
    if opts.htk_compat:
        feats = _htk_reorder(feats, scale_c0=False)
    return feats


def feature_dim(opts) -> int:
    return opts.dim


def compute_num_frames(num_samples: int, opts) -> int:
    return num_frames(num_samples, opts.frame_opts)


def cmvn(feats: torch.Tensor) -> torch.Tensor:
    """Per-utterance mean and variance normalisation over time:
    feats [..., T, D] -> (feats - mean) / (std + 1e-5), population std
    (jnp.std is ddof 0), as the serving pipeline applies it after fbank."""
    mu = torch.mean(feats, dim=-2, keepdim=True)
    sd = torch.std(feats, dim=-2, keepdim=True, correction=0)
    return (feats - mu) / (sd + 1e-5)
