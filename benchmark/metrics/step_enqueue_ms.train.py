"""Milliseconds per step that the host spends in the train step: the
program's `train.step` spans in the window (forward, backward and update
enqueued, no synchronize; a wait for room in the launch queue counts)
over the window's steps."""

from program_spans import program_spans, seconds


def read(run):
    c = run["counters"]
    steps = program_spans(run, "train.step")
    if not steps or not c.get("steps"):
        return None
    return 1e3 * seconds(steps) / c["steps"]
