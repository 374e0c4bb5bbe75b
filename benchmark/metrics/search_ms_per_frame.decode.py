"""Milliseconds of the port's search per frame of its frame loop: host
spans from each batch's decode call to its finisher's return, over the
batches' padded frame counts."""

from common import span_s


def read(run):
    c = run["counters"]
    if not c.get("loop_frames"):
        return None
    return 1e3 * span_s(run, "search") / c["loop_frames"]
