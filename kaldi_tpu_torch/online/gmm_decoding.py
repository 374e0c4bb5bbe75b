"""Online GMM decoding with mid-utterance fMLLR adaptation.

(ref: online2/online-gmm-decoding.h — OnlineGmmDecodingAdaptationPolicyConfig
 :56 (re-estimation schedule), OnlineGmmAdaptationState :199 (CMVN state +
 fMLLR transform carried across utterances), SingleUtteranceGmmDecoder
 :216 (pipeline + decoder + EstimateFmllr from the current best path).)

Counterpart of kaldi_tpu/online/gmm_decoding.py, over the port's
`OnlineDecoder` and `transform/fmllr.py`: the loglikes and the features'
transform run on the AM's device, the fMLLR statistics' solve on the host
in f64, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_tpu_torch.online.decoder import OnlineDecoder
from kaldi_tpu_torch.transform.fmllr import (FmllrStats,
                                             apply_affine_transform,
                                             estimate_fmllr)


@dataclasses.dataclass
class AdaptationPolicy:
    """When (in utterance seconds) to (re-)estimate fMLLR
    (ref: online-gmm-decoding.h:56; the reference's schedule: first
    estimate early in the first utterance, then at geometric intervals)."""
    adaptation_first_utt_delay: float = 2.0
    adaptation_first_utt_ratio: float = 1.5
    adaptation_delay: float = 5.0
    adaptation_ratio: float = 2.0

    def do_adapt(self, chunk_begin_secs: float, chunk_end_secs: float,
                 is_first_utt: bool) -> bool:
        delay = (self.adaptation_first_utt_delay if is_first_utt
                 else self.adaptation_delay)
        ratio = (self.adaptation_first_utt_ratio if is_first_utt
                 else self.adaptation_ratio)
        t = delay
        while t < chunk_begin_secs:
            t *= ratio
        return chunk_begin_secs <= t < chunk_end_secs


class OnlineGmmAdaptationState:
    """(ref: online-gmm-decoding.h:199)"""

    def __init__(self):
        self.cmvn_state = None
        self.transform: np.ndarray | None = None


class SingleUtteranceGmmDecoder:
    """Streaming GMM decoding; fMLLR re-estimated mid-utterance from the
    partial best path (ref: online-gmm-decoding.h:216)."""

    def __init__(self, am, trans_model, beam_decoder, feature_pipeline,
                 adaptation_state: OnlineGmmAdaptationState | None = None,
                 policy: AdaptationPolicy = AdaptationPolicy(),
                 is_first_utt: bool = True,
                 frame_shift: float = 0.01,
                 chunk_frames: int = 32,
                 fmllr_min_count: float = 100.0):
        self.am = am
        self.tm = trans_model
        self.pipeline = feature_pipeline
        self.decoder = OnlineDecoder(beam_decoder, chunk_frames)
        self.state = adaptation_state or OnlineGmmAdaptationState()
        self.policy = policy
        self.is_first_utt = is_first_utt
        self.frame_shift = frame_shift
        self.fmllr_min_count = fmllr_min_count
        self._frames_consumed = 0
        self._all_feats: list = []

    def _transformed(self, feats: np.ndarray):
        if self.state.transform is None:
            return feats
        return apply_affine_transform(feats, self.state.transform,
                                      device=self.am.device)

    def advance_decoding(self):
        feats_all = self.pipeline.get_features()
        ready = feats_all.shape[0]
        if ready <= self._frames_consumed:
            return
        t0 = self._frames_consumed * self.frame_shift
        t1 = ready * self.frame_shift
        new = self._transformed(feats_all[self._frames_consumed: ready])
        ll = self.am.loglikes_np(new[None])[0]
        self.decoder.advance_decoding(ll)
        self._frames_consumed = ready
        if self.policy.do_adapt(t0, t1, self.is_first_utt):
            self.estimate_fmllr(feats_all[:ready])

    def estimate_fmllr(self, raw_feats: np.ndarray):
        """fMLLR from the current partial traceback's alignment
        (ref: online-gmm-decoding.cc EstimateFmllr — uses lattice
        posteriors; the best-path alignment is its dominant term)."""
        res = self.decoder.best_path(use_final_probs=False)
        if res is None:
            return
        _w, tids, _c = res
        T = min(len(tids), raw_feats.shape[0])
        if T < 10:
            return
        pdf_ids = np.array([self.tm.transition_id_to_pdf(t)
                            for t in tids[:T]])
        stats = FmllrStats(raw_feats.shape[1])
        stats.accumulate_from_alignment(self.am, raw_feats[:T], pdf_ids)
        W, _impr, count = estimate_fmllr(stats, min_count=self.fmllr_min_count,
                                         init=self.state.transform)
        if count >= self.fmllr_min_count:
            self.state.transform = W

    def finalize_decoding(self):
        self.pipeline.input_finished()
        self.advance_decoding()

    def have_transform(self) -> bool:
        return self.state.transform is not None

    def get_adaptation_state(self) -> OnlineGmmAdaptationState:
        return self.state

    def best_path(self):
        return self.decoder.best_path()
