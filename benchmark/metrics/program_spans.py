"""The program's own spans, for the readers of the metrics that read them:
`kaldi_tpu_torch.utils.profiling`'s recorder (a ring of finished spans on
`time.perf_counter()`'s clock, the clock of the runners' window bounds,
with a count of the spans it dropped when it wrapped). The runner has
loaded the program by the time a reader runs; a program without the
recorder gives None, as does a recorder that dropped spans from the
interval asked for."""

from __future__ import annotations

import math


def program_spans(run: dict, name: str, lo=None, hi=None):
    """The program's spans called `name` that start at or after `lo` and
    end at or before `hi` (by default the window: the counters'
    `window_start` and `window_end`), oldest first. None where the
    program records no spans or where the ring had dropped spans that
    may have lain in [lo, hi]: a span it dropped ended before its oldest
    kept span did, so the interval is whole if that one ended by `lo`."""
    try:
        from kaldi_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "spans", None)
    dropped = getattr(profiling, "dropped", None)
    if snapshot is None or dropped is None:
        return None
    c = run["counters"]
    lo = c.get("window_start", -math.inf) if lo is None else lo
    hi = c.get("window_end", math.inf) if hi is None else hi
    got = snapshot()
    if dropped() and (not got or got[0].end > lo):
        return None
    return [s for s in got if s.name == name and s.start >= lo
            and s.end <= hi]


def seconds(spans) -> float:
    return sum(s.end - s.start for s in spans)


def total(spans, count: str) -> int:
    return sum(s.counts.get(count, 0) for s in spans)
