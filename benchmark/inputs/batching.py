"""Frozen copy of the length buckets of `kaldi_tpu_torch/decoder/
batching.py` (`bucket_boundaries`): the reference pads each utterance's
features with zeros to its bucket's bound, as the offline entry does
before the acoustic model."""

from __future__ import annotations

import numpy as np


def bucket_boundaries(lengths, max_buckets: int = 6, growth: float = 1.4,
                      min_len: int = 64) -> list[int]:
    """Geometric length buckets covering the data."""
    lo = max(min_len, int(min(lengths)))
    hi = int(max(lengths))
    bounds = [lo]
    while bounds[-1] < hi and len(bounds) < max_buckets:
        bounds.append(int(np.ceil(bounds[-1] * growth)))
    bounds[-1] = max(bounds[-1], hi)
    return bounds


def padded_length(n: int, bounds: list[int]) -> int:
    """The bound of the first bucket that holds a length-n utterance."""
    return next(b for b in bounds if n <= b)
