"""Log-mel filterbank features and per-utterance CMVN on tensors.

Counterpart of kaldi_tpu/ops/features.py `fbank` (ref:
feat/feature-fbank.cc): one gather frames the batch, one batched
`torch.fft.rfft` gives the power spectrum, one matmul applies the mel bank.
The mel matmul runs in true f32 (TF32 off, see kaldi_tpu_torch.device): it
sits under a log. MFCC, PLP and deltas are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from kaldi_tpu_torch.ops.mel import MelOpts, mel_banks
from kaldi_tpu_torch.ops.window import FrameOpts, extract_windows

FLT_TINY = float(np.finfo(np.float32).tiny)


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


def fbank(wave: torch.Tensor, opts: FbankOpts = FbankOpts(),
          vtln_warp: float = 1.0,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """wave [..., S] f32 -> (log-)mel filterbank [..., F, num_bins(+1)],
    on the wave's device."""
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
        mel_e = torch.clamp(mel_e, min=1.0)
    if opts.use_log_fbank:
        mel_e = torch.log(torch.clamp(mel_e, min=FLT_TINY))
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_energy = torch.clamp(log_energy, min=math.log(opts.energy_floor))
        # energy goes FIRST in kaldi mode, LAST in htk_compat mode
        if opts.htk_compat:
            return torch.cat([mel_e, log_energy[..., None]], dim=-1)
        return torch.cat([log_energy[..., None], mel_e], dim=-1)
    return mel_e


def cmvn(feats: torch.Tensor) -> torch.Tensor:
    """Per-utterance mean and variance normalisation over time:
    feats [..., T, D] -> (feats - mean) / (std + 1e-5), population std
    (jnp.std is ddof 0), as the serving pipeline applies it after fbank."""
    mu = torch.mean(feats, dim=-2, keepdim=True)
    sd = torch.std(feats, dim=-2, keepdim=True, correction=0)
    return (feats - mu) / (sd + 1e-5)
