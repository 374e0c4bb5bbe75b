"""Device operations per loop frame in the profiled segment after the
window: every kernel, copy and memset of the segment (`trace["kernels"]`)
over the `frames` of the program's `csr_beam.frame_loop` spans that start
after the window's end (the segment's batch). The search's own ops are
the frame loop's, the traceback's and the fetch's; the segment's
features and AM add well under 1% of the count."""

import math

from program_spans import program_spans, total


def read(run):
    tr, c = run["trace"], run["counters"]
    if not tr or "window_end" not in c:
        return None
    loops = program_spans(run, "csr_beam.frame_loop", lo=c["window_end"],
                          hi=math.inf)
    frames = total(loops or [], "frames")
    if not frames:
        return None
    return len(tr["kernels"]) / frames
