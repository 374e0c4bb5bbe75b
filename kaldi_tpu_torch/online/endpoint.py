"""Endpoint detection: OR of configurable rules.

(ref: online2/online-endpoint.h:87-126 — each rule fires based on
 (must_contain_nonsilence, min_trailing_silence, max_relative_cost,
 min_utterance_length); the 5 default rules.)

The port's copy of kaldi_tpu/online/endpoint.py (host code).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class EndpointRule:
    must_contain_nonsilence: bool = True
    min_trailing_silence: float = 1.0    # seconds
    max_relative_cost: float = math.inf
    min_utterance_length: float = 0.0    # seconds

    def active(self, utterance_length: float, trailing_silence: float,
               relative_cost: float, contains_nonsilence: bool) -> bool:
        if self.must_contain_nonsilence and not contains_nonsilence:
            return False
        return (trailing_silence >= self.min_trailing_silence
                and relative_cost <= self.max_relative_cost
                and utterance_length >= self.min_utterance_length)


@dataclasses.dataclass(frozen=True)
class EndpointConfig:
    """(ref: online-endpoint.h OnlineEndpointConfig — the 5 default rules)"""

    rule1: EndpointRule = EndpointRule(False, 5.0, math.inf, 0.0)
    rule2: EndpointRule = EndpointRule(True, 0.5, 2.0, 0.0)
    rule3: EndpointRule = EndpointRule(True, 1.0, 8.0, 0.0)
    rule4: EndpointRule = EndpointRule(True, 2.0, math.inf, 0.0)
    rule5: EndpointRule = EndpointRule(False, 0.0, math.inf, 20.0)

    @property
    def rules(self):
        return (self.rule1, self.rule2, self.rule3, self.rule4, self.rule5)


def endpoint_detected(config: EndpointConfig, frame_shift: float,
                      num_frames_decoded: int, trailing_silence_frames: int,
                      relative_cost: float) -> bool:
    """(ref: online2/online-endpoint.cc EndpointDetected)"""
    utterance_length = num_frames_decoded * frame_shift
    trailing = trailing_silence_frames * frame_shift
    nonsil = trailing_silence_frames < num_frames_decoded
    return any(r.active(utterance_length, trailing, relative_cost, nonsil)
               for r in config.rules)
