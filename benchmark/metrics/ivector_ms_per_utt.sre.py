"""Milliseconds of `IvectorExtractor.extract_batch` (the i-vector
posterior, `posterior_batch`, in batches of 64) per side: host spans
ending in a device synchronize."""

from common import span_s


def read(run):
    c = run["counters"]
    if not c.get("utts"):
        return None
    return 1e3 * span_s(run, "ivector") / c["utts"]
