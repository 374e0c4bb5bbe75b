"""Online nnet2 decoding: feature pipeline with i-vectors + chunked decode.

Counterpart of kaldi_tpu/online/nnet2_decoding.py (ref:
online2/online-nnet2-feature-pipeline.h:61 OnlineNnet2FeaturePipeline —
base features (MFCC/PLP/fbank) ⊕ online i-vector, concatenated per frame;
online2/online-nnet2-decoding.h:67 SingleUtteranceNnet2Decoder — pipeline
+ DecodableNnet2Online + LatticeFasterOnlineDecoder;
online2bin/online2-wav-nnet2-latgen-faster.cc is the driving binary).

The pipeline runs where its base feature runs; the i-vectors are host
numpy. The decoder runs on its BeamSearchDecoder's device and moves the
AM's model there; it scores through `AmNnet.loglikes_np`, so a mixed-up
AM (group_ids) is accepted.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.online.decoder import OnlineDecoder
from kaldi_tpu_torch.online.endpoint import EndpointConfig, endpoint_detected
from kaldi_tpu_torch.online.ivector import (OnlineIvectorFeature,
                                            OnlineSilenceWeighting)


class OnlineNnet2FeaturePipeline:
    """Base acoustic features ⊕ per-frame i-vector (both streaming)."""

    def __init__(self, base_feature, ivector_feature: OnlineIvectorFeature
                 | None = None):
        self.base = base_feature
        self.ivector = ivector_feature
        self._silence_weights: np.ndarray | None = None
        self.finished = False

    @property
    def dim(self) -> int:
        d = self.base.dim
        if self.ivector is not None:
            d += self.ivector.dim
        return d

    def accept_waveform(self, wave: np.ndarray):
        n_before = self.base.num_frames_ready()
        self.base.accept_waveform(wave)
        self._feed_ivector(n_before)

    def input_finished(self):
        n_before = self.base.num_frames_ready()
        self.base.input_finished()
        self._feed_ivector(n_before)
        self.finished = True

    def _feed_ivector(self, n_before: int):
        if self.ivector is None:
            return
        n_now = self.base.num_frames_ready()
        if n_now > n_before:
            self.ivector.accept_features(
                self.base.get_frames(n_before, n_now))

    def set_silence_weights(self, weights: np.ndarray):
        """Per-frame weights from OnlineSilenceWeighting (decoder partial
        traceback). They cover already-decoded (hence already accumulated)
        frames, so the i-vector stats are re-weighted in place (ref:
        OnlineIvectorFeature::UpdateFrameWeights)."""
        if self.ivector is not None:
            self.ivector.update_frame_weights(weights)

    def num_frames_ready(self) -> int:
        return self.base.num_frames_ready()

    def get_frames(self, start: int, end: int) -> np.ndarray:
        base = self.base.get_frames(start, end)
        if self.ivector is None:
            return base
        ivecs = np.stack([self.ivector.get_frame(t)
                          for t in range(start, end)])
        return np.concatenate([base, ivecs], axis=1).astype(np.float32)


class SingleUtteranceNnet2Decoder:
    """One utterance of streaming hybrid decoding
    (ref: online2/online-nnet2-decoding.h:67)."""

    def __init__(self, am_nnet, trans_model, beam_decoder,
                 feature_pipeline: OnlineNnet2FeaturePipeline,
                 chunk_frames: int = 32,
                 endpoint_config: EndpointConfig | None = None,
                 silence_phones: set = frozenset(),
                 frame_shift: float = 0.01):
        self.am_nnet = am_nnet
        am_nnet.model.to(beam_decoder.device)
        self.tm = trans_model
        self.pipeline = feature_pipeline
        self.decoder = OnlineDecoder(beam_decoder, chunk_frames)
        self.endpoint_config = endpoint_config
        self.silence_phones = set(silence_phones)
        self.frame_shift = frame_shift
        self._frames_consumed = 0
        self._sil_weighting = OnlineSilenceWeighting(
            trans_model, self.silence_phones)

    def advance_decoding(self):
        """Score and decode the feature frames not yet consumed, carrying
        the AM's temporal context across chunks: each window is scored
        with `left_context` frames of true history, and frames within
        `right_context` of the stream head wait until their future context
        exists (consumed at input_finished). Decoded scores are therefore
        the same however the audio was chunked (the offline-parity
        contract; ref: online-nnet2-decoding.h AdvanceDecoding)."""
        ready = self.pipeline.num_frames_ready()
        cfg = self.am_nnet.model.config
        lc, rc = cfg.left_context, cfg.right_context
        finished = getattr(self.pipeline, "finished", False)
        consumable = ready if finished else max(self._frames_consumed,
                                                ready - rc)
        if consumable <= self._frames_consumed:
            return
        start = max(0, self._frames_consumed - lc)
        feats = self.pipeline.get_frames(start, ready)
        ll_full = self.am_nnet.loglikes_np(feats[None])[0]
        ll = ll_full[self._frames_consumed - start: consumable - start]
        self.decoder.advance_decoding(ll)
        self._frames_consumed = consumable
        # decoder feedback: downweight silence frames in the i-vector stats
        if self.pipeline.ivector is not None:
            res = self.decoder.best_path(use_final_probs=False)
            if res is not None:
                _w, tids, _c = res
                self.pipeline.set_silence_weights(
                    self._sil_weighting.weights_from_alignment(tids))

    def endpoint_detected(self) -> bool:
        if self.endpoint_config is None:
            return False
        trailing = self.decoder.trailing_silence_frames(
            self.silence_phones, self.tm)
        return endpoint_detected(
            self.endpoint_config, self.frame_shift,
            self.decoder.num_frames_decoded, trailing,
            self.decoder.final_relative_cost())

    def finalize_decoding(self):
        self.pipeline.input_finished()
        self.advance_decoding()

    def best_path(self):
        return self.decoder.best_path()
