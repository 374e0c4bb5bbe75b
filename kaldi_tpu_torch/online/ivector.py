"""Online i-vector estimation for speaker-adapted online decoding.

(ref: online2/online-ivector-feature.h — OnlineIvectorExtractionConfig
 :54-130 (ivector_period, posterior_scale, max_count, max_remembered_frames),
 OnlineIvectorExtractorAdaptationState :199 (stats carried across a
 speaker's utterances), OnlineIvectorFeature :244 (cumulative UBM stats,
 i-vector re-extracted every ivector_period frames, silence-weighted
 posteriors from decoder feedback).)

The port's copy of kaldi_tpu/online/ivector.py (host numpy).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_tpu_torch.ivector.extractor import IvectorExtractor


@dataclasses.dataclass
class OnlineIvectorConfig:
    ivector_period: int = 10
    num_gselect: int = 5
    min_post: float = 0.025
    posterior_scale: float = 0.1
    max_count: float = 0.0            # soft cap on stats count (0 = off)
    max_remembered_frames: float = 1000.0
    use_most_recent_ivector: bool = True
    silence_weight: float = 0.0       # weight for frames flagged silence


class OnlineIvectorAdaptationState:
    """Speaker-carried cumulative stats
    (ref: online-ivector-feature.h:199)."""

    def __init__(self, extractor: IvectorExtractor):
        I, D = extractor.means.shape
        self.gamma = np.zeros(I)
        self.X = np.zeros((I, D))

    def limit_frames(self, max_frames: float, posterior_scale: float):
        """Scale down remembered stats to at most max_frames worth
        (ref: OnlineIvectorExtractorAdaptationState::LimitFrames)."""
        count = self.gamma.sum() / max(posterior_scale, 1e-20)
        if max_frames > 0 and count > max_frames:
            s = max_frames / count
            self.gamma *= s
            self.X *= s


class OnlineIvectorFeature:
    """Streaming i-vector 'feature': Dim() = ivector_dim; every frame's
    value is the i-vector estimated from all (weighted) stats up to the
    most recent ivector_period boundary (ref: online-ivector-feature.h:244)."""

    def __init__(self, extractor: IvectorExtractor,
                 config: OnlineIvectorConfig = OnlineIvectorConfig(),
                 adaptation_state: OnlineIvectorAdaptationState | None = None):
        self.extractor = extractor
        self.config = config
        state = adaptation_state or OnlineIvectorAdaptationState(extractor)
        self.gamma = state.gamma.copy()
        self.X = state.X.copy()
        self._frames_seen = 0
        self._cached_ivector = None
        self._cached_at = -1
        self._ivectors_history: list = []
        # per-frame (scaled posterior, feats, applied weight) cache so
        # decoder feedback can RE-weight already-accumulated frames
        # (ref: OnlineIvectorFeature::UpdateFrameWeights)
        self._frame_post: list = []
        self._frame_feat: list = []
        self._frame_w: list = []

    @property
    def dim(self) -> int:
        return self.extractor.ivector_dim

    def accept_features(self, feats: np.ndarray, frame_weights=None):
        """Add base-feature frames [T, D] with optional per-frame weights
        (silence weighting from decoder feedback; ref:
        online-ivector-feature.h OnlineSilenceWeighting's output)."""
        cfg = self.config
        if feats.shape[0] == 0:
            return
        post = self.extractor.frame_posteriors(
            feats, cfg.num_gselect, cfg.min_post) * cfg.posterior_scale
        w = (np.asarray(frame_weights, np.float64)
             if frame_weights is not None else np.ones(feats.shape[0]))
        weighted = post * w[:, None]
        self.gamma += weighted.sum(axis=0)
        self.X += weighted.T @ feats
        for t in range(feats.shape[0]):
            self._frame_post.append(post[t])
            self._frame_feat.append(np.asarray(feats[t], np.float64))
            self._frame_w.append(float(w[t]))
        if cfg.max_count > 0:
            # soft cap in REAL frames (gamma carries posterior_scale)
            count = self.gamma.sum() / max(cfg.posterior_scale, 1e-20)
            if count > cfg.max_count:
                s = cfg.max_count / count
                self.gamma *= s
                self.X *= s
        self._frames_seen += feats.shape[0]
        self._cached_at = -1

    def update_frame_weights(self, weights):
        """Re-weight ALREADY-ACCUMULATED frames (decoder silence feedback):
        weights: array over frames [0, len(weights)) — stats are adjusted
        by (new − old) × the frame's cached posterior contribution
        (ref: online-ivector-feature.h UpdateFrameWeights)."""
        n = min(len(weights), len(self._frame_w))
        changed = False
        for t in range(n):
            delta = float(weights[t]) - self._frame_w[t]
            if abs(delta) < 1e-9:
                continue
            self.gamma += delta * self._frame_post[t]
            self.X += delta * np.outer(self._frame_post[t],
                                       self._frame_feat[t])
            self._frame_w[t] = float(weights[t])
            changed = True
        if changed:
            self._cached_at = -1

    def _extract(self):
        w, _L = self.extractor.extract(self.gamma, self.X)
        return w

    def get_frame(self, t: int) -> np.ndarray:
        """i-vector for frame t. With use_most_recent_ivector (the online
        decoding default) every frame uses the newest estimate; otherwise
        the estimate at the preceding ivector_period boundary."""
        cfg = self.config
        if cfg.use_most_recent_ivector:
            if self._cached_at != self._frames_seen:
                self._cached_ivector = self._extract()
                self._cached_at = self._frames_seen
            return self._cached_ivector
        period_idx = t // cfg.ivector_period
        while len(self._ivectors_history) <= period_idx:
            self._ivectors_history.append(self._extract())
        return self._ivectors_history[period_idx]

    def get_adaptation_state(self) -> OnlineIvectorAdaptationState:
        st = OnlineIvectorAdaptationState(self.extractor)
        st.gamma = self.gamma.copy()
        st.X = self.X.copy()
        st.limit_frames(self.config.max_remembered_frames,
                        self.config.posterior_scale)
        return st


class OnlineSilenceWeighting:
    """Frame weights from decoder partial traceback: silence frames get
    config.silence_weight (ref: online2/online-ivector-feature.h:54
    OnlineSilenceWeighting — we consume the online decoder's partial
    alignment instead of its token-level API)."""

    def __init__(self, trans_model, silence_phones: set,
                 silence_weight: float = 0.0):
        self.tm = trans_model
        self.silence_phones = set(silence_phones)
        self.silence_weight = silence_weight

    def weights_from_alignment(self, tids) -> np.ndarray:
        w = np.ones(len(tids))
        for i, tid in enumerate(tids):
            if tid and self.tm.transition_id_to_phone(int(tid)) \
                    in self.silence_phones:
                w[i] = self.silence_weight
        return w
