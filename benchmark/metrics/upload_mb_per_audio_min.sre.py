"""Megabytes (1e6 B) the extractor copies to the card per minute of audio
completed: the `bytes` counted by the program's `ivector.upload` spans in
the window (the voiced frames in f64, and the posteriors where the caller
gives them)."""

from program_spans import program_spans, total


def read(run):
    c = run["counters"]
    ups = program_spans(run, "ivector.upload")
    if not ups or not c.get("audio_s"):
        return None
    return total(ups, "bytes") / 1e6 / (c["audio_s"] / 60.0)
