"""Real-time-factor accounting for online decoding.

(ref: online2/online-timing.h:41-83 OnlineTimer/OnlineTimingStats —
 simulates real-time audio arrival and reports latency + RTF.)

The port's copy of kaldi_tpu/online/timing.py (host code).
"""

from __future__ import annotations

import time


class OnlineTimingStats:
    def __init__(self):
        self.num_utts = 0
        self.total_audio = 0.0
        self.total_compute = 0.0
        self.max_delay = 0.0

    def add(self, audio_seconds: float, compute_seconds: float,
            max_delay: float = 0.0):
        self.num_utts += 1
        self.total_audio += audio_seconds
        self.total_compute += compute_seconds
        self.max_delay = max(self.max_delay, max_delay)

    @property
    def real_time_factor(self) -> float:
        return self.total_compute / max(self.total_audio, 1e-10)

    def __str__(self):
        return (f"RTF {self.real_time_factor:.4f} over "
                f"{self.total_audio:.1f}s audio ({self.num_utts} utts), "
                f"max delay {self.max_delay:.3f}s")


class OnlineTimer:
    """Tracks wall-clock against the audio clock for one utterance."""

    def __init__(self, utt: str = ""):
        self.utt = utt
        self._start = time.perf_counter()
        self.audio_seconds = 0.0
        self.max_delay = 0.0

    def wait_until(self, audio_time: float):
        """Record that we have CONSUMED audio up to audio_time; if compute
        is ahead of real time this is where a live system would sleep."""
        self.audio_seconds = audio_time
        elapsed = time.perf_counter() - self._start
        self.max_delay = max(self.max_delay, elapsed - audio_time)

    def finish(self, stats: OnlineTimingStats):
        elapsed = time.perf_counter() - self._start
        stats.add(self.audio_seconds, elapsed, self.max_delay)
        return elapsed
