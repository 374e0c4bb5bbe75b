"""Milliseconds per step that the host spends in the step's update: the
program's `train.update` spans in the window (the optimizer chain and
`apply_updates`, inside `train.step`) over the window's steps."""

from program_spans import program_spans, seconds


def read(run):
    c = run["counters"]
    updates = program_spans(run, "train.update")
    if not updates or not c.get("steps"):
        return None
    return 1e3 * seconds(updates) / c["steps"]
