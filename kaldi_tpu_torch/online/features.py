"""Streaming feature extraction with exact offline parity.

Counterpart of kaldi_tpu/online/features.py (ref: feat/online-feature.h:46-516
— OnlineGenericBaseFeature<Mfcc>, OnlineCmvn :145-262 with speaker/global
prior stats and freezing, OnlineSpliceFrames, OnlineDeltaFeature;
itf/online-feature-itf.h:49).

Because a frame depends only on its own window, buffering the waveform
remainder reproduces the offline features exactly (snip-edges semantics).
The feature computer, deltas and splicing run on the class's device (the
card unless the caller asks for "cpu"); the frames are kept as host numpy
rows, and OnlineCmvn is host numpy, as in the JAX classes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.ops.delta import add_deltas, splice_frames
from kaldi_tpu_torch.ops.features import MfccOpts, mfcc
from kaldi_tpu_torch.ops.window import num_frames
from kaldi_tpu_torch.transform.cmvn import CmvnStats


class OnlineMfcc:
    """AcceptWaveform/InputFinished/NumFramesReady/GetFrames streaming API.

    Works for fbank/plp too via the `computer` argument."""

    def __init__(self, opts: MfccOpts = MfccOpts(), computer=mfcc,
                 device="cuda"):
        self.opts = opts
        self.computer = computer
        self.device = resolve_device(device)
        self._buffer = np.zeros(0, np.float32)
        self._frames: list[np.ndarray] = []
        self._finished = False

    @property
    def dim(self):
        return self.opts.dim

    def accept_waveform(self, wave: np.ndarray):
        if self._finished:
            raise ValueError("input already finished")
        self._buffer = np.concatenate([self._buffer,
                                       np.asarray(wave, np.float32)])
        self._compute_ready()

    def input_finished(self):
        self._finished = True
        self._compute_ready()

    def _compute_ready(self):
        fo = self.opts.frame_opts
        n = num_frames(len(self._buffer), fo)
        if n == 0:
            return
        # the same power-of-two zero-padded buffer as the JAX class (which
        # pads to bound its jit shapes): frames past n are cut off, and a
        # frame reads only its own window
        L = len(self._buffer)
        bucket = 1 << max(10, int(np.ceil(np.log2(L))))
        wave = np.zeros(bucket, np.float32)
        wave[:L] = self._buffer
        feats = self.computer(torch.as_tensor(wave, device=self.device),
                              self.opts)[:n].cpu().numpy()
        self._frames.extend(feats)
        # keep the remainder from frame n's first sample: the next call's
        # frame 0 is frame n (the overlap past the shift is kept because
        # only n shifts are consumed)
        self._buffer = self._buffer[n * fo.window_shift:]

    def num_frames_ready(self) -> int:
        return len(self._frames)

    def get_frames(self, start: int, end: int) -> np.ndarray:
        return np.stack(self._frames[start:end])


@dataclasses.dataclass
class OnlineCmvnOpts:
    """(ref: feat/online-feature.h OnlineCmvnOptions)"""

    cmn_window: int = 600
    speaker_frames: int = 600
    global_frames: int = 200
    normalize_mean: bool = True
    normalize_variance: bool = False


class OnlineCmvn:
    """Causal CMVN with speaker/global prior smoothing and freezing (host
    numpy, f64).

    (ref: online-feature.h:145-262 — stats from up-to-cmn_window recent
    frames, backed off to speaker stats then global stats when the
    utterance is young; Freeze() pins the current transform.)
    """

    def __init__(self, opts: OnlineCmvnOpts = OnlineCmvnOpts(),
                 global_stats=None, speaker_stats=None):
        self.opts = opts
        self.global_stats = global_stats    # CmvnStats or None
        self.speaker_stats = speaker_stats
        self._frozen = None  # (mean, var)

    def freeze(self, mean, var):
        self._frozen = (np.asarray(mean), np.asarray(var))

    def get_state(self):
        return self.speaker_stats

    def apply(self, feats: np.ndarray) -> np.ndarray:
        """Whole-utterance-so-far causal application: frame t normalized
        with stats of frames max(0, t-window)..t (+ priors)."""
        x = np.asarray(feats, np.float64)
        T, D = x.shape
        out = np.empty_like(x)
        csum = np.concatenate([np.zeros((1, D)), np.cumsum(x, axis=0)])
        csumsq = np.concatenate([np.zeros((1, D)),
                                 np.cumsum(x * x, axis=0)])
        o = self.opts
        for t in range(T):
            if self._frozen is not None:
                mean, var = self._frozen
            else:
                lo = max(0, t + 1 - o.cmn_window)
                n = t + 1 - lo
                s = csum[t + 1] - csum[lo]
                ss = csumsq[t + 1] - csumsq[lo]
                # back off with speaker then global priors
                if self.speaker_stats is not None and n < o.cmn_window:
                    want = min(o.speaker_frames, o.cmn_window) - n
                    if want > 0 and self.speaker_stats.count > 0:
                        sm, sv = self.speaker_stats.mean_var()
                        w = min(want, self.speaker_stats.count)
                        s = s + w * sm
                        ss = ss + w * (sv + sm * sm)
                        n += w
                if self.global_stats is not None and n < o.cmn_window:
                    want = min(o.global_frames, o.cmn_window) - n
                    if want > 0 and self.global_stats.count > 0:
                        gm, gv = self.global_stats.mean_var()
                        w = min(want, self.global_stats.count)
                        s = s + w * gm
                        ss = ss + w * (gv + gm * gm)
                        n += w
                mean = s / n
                var = np.maximum(ss / n - mean * mean, 1e-10)
            out[t] = x[t] - mean if o.normalize_mean else x[t]
            if o.normalize_variance:
                out[t] /= np.sqrt(var)
        return out.astype(np.float32)

    def update_speaker_stats(self, feats: np.ndarray):
        if self.speaker_stats is None:
            self.speaker_stats = CmvnStats(feats.shape[1])
        self.speaker_stats.accumulate(feats)


class OnlineFeaturePipeline:
    """base features -> online CMVN -> deltas or splice; the base features,
    deltas and splicing run on `device`.

    (ref: online2/online-feature-pipeline.h:157 OnlineFeaturePipeline)
    """

    def __init__(self, mfcc_opts: MfccOpts = MfccOpts(),
                 cmvn: OnlineCmvn | None = None,
                 delta_order: int = 2, splice: tuple | None = None,
                 computer=mfcc, device="cuda"):
        self.base = OnlineMfcc(mfcc_opts, computer, device=device)
        self.device = self.base.device
        self.cmvn = cmvn
        self.delta_order = delta_order
        self.splice = splice

    def accept_waveform(self, wave):
        self.base.accept_waveform(wave)

    def input_finished(self):
        self.base.input_finished()

    @property
    def right_delay(self) -> int:
        """Frames of future context the post-processing needs: emitting a
        frame before its context exists would bake in edge-clamped deltas
        that differ from the offline computation (the parity contract)."""
        if self.splice is not None:
            return max(0, max(self.splice))
        if self.delta_order > 0:
            return self.delta_order * 2   # order * window (default window 2)
        return 0

    @property
    def dim(self) -> int:
        if self.splice is not None:
            lo = -min(self.splice)
            hi = max(self.splice)
            return self.base.dim * (lo + hi + 1)
        return self.base.dim * (self.delta_order + 1)

    def _post(self, feats: np.ndarray, lo: int, hi: int) -> np.ndarray:
        """Splice (context lo, hi) or deltas of host frames, on the device."""
        x = torch.as_tensor(np.asarray(feats, np.float32), device=self.device)
        if self.splice is not None:
            x = splice_frames(x, lo, hi)
        elif self.delta_order > 0:
            x = add_deltas(x, order=self.delta_order)
        return x.cpu().numpy()

    def get_features(self) -> np.ndarray:
        """Post-processed frames whose context is COMPLETE: all frames
        when input is finished, otherwise all but the last `right_delay`
        (they would change once more audio arrives)."""
        n = self.base.num_frames_ready()
        if not self.base._finished:
            n = max(0, n - self.right_delay)
        if n == 0:
            return np.zeros((0, self.dim), np.float32)
        feats = self.base.get_frames(0, self.base.num_frames_ready())
        if self.cmvn is not None:
            feats = self.cmvn.apply(feats)
        lo = -min(self.splice) if self.splice is not None else 0
        hi = max(self.splice) if self.splice is not None else 0
        return self._post(feats, lo, hi)[:n]


class OnlineProcessedFeature:
    """Adapter exposing an OnlineFeaturePipeline (CMVN/deltas/splice)
    through the base-feature interface (dim / num_frames_ready /
    get_frames) so post-processed features can feed
    OnlineNnet2FeaturePipeline — the online2 feature-pipeline stacking
    (ref: online2/online-feature-pipeline.h:157). It runs on its
    pipeline's device.

    Completed frames are cached and only the newly-complete suffix is
    computed per chunk (their context exists, so their values are final).
    Pipelines with online CMVN (whose sliding stats are stateful) recompute
    fully, cached per ready-count."""

    def __init__(self, pipeline: OnlineFeaturePipeline):
        self.p = pipeline
        self._cache = np.zeros((0, self.p.dim), np.float32)

    @property
    def dim(self) -> int:
        return self.p.dim

    def accept_waveform(self, wave: np.ndarray):
        self.p.accept_waveform(wave)

    def input_finished(self):
        self.p.input_finished()

    def num_frames_ready(self) -> int:
        n = self.p.base.num_frames_ready()
        if not self.p.base._finished:
            n = max(0, n - self.p.right_delay)
        return n

    def _extend_cache(self):
        n_done = self._cache.shape[0]
        n_complete = self.num_frames_ready()
        if n_complete <= n_done:
            return
        if self.p.cmvn is not None:
            self._cache = np.asarray(self.p.get_features()[:n_complete],
                                     np.float32)
            return
        # context radius of the post-processing (clamped at 0: splice
        # tuples with only positive/negative offsets still index forward)
        if self.p.splice is not None:
            lo = max(0, -min(self.p.splice))
            hi = max(0, max(self.p.splice))
        else:
            lo = hi = self.p.right_delay
        w0 = max(0, n_done - lo)
        w1 = min(self.p.base.num_frames_ready(), n_complete + hi)
        win = self.p.base.get_frames(w0, w1)
        proc = (self.p._post(win, lo, hi)
                if self.p.splice is not None or self.p.delta_order > 0
                else np.asarray(win))
        # frames [n_done, n_complete) sit at window offset n_done - w0;
        # when w0 > 0 their context is fully real, matching offline
        # (edge clamping only ever applies at the true stream edges)
        new = proc[n_done - w0: n_complete - w0]
        self._cache = np.concatenate([self._cache, new.astype(np.float32)])

    def get_frames(self, start: int, end: int) -> np.ndarray:
        self._extend_cache()
        return self._cache[start:end]
