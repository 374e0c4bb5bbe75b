"""Milliseconds of the speaker path's voiced-frame selection per minute of
audio completed: the program's `sre.vad` spans in the window
(`SreSystem.stats`' energy VAD, numpy on the host)."""

from program_spans import program_spans, seconds


def read(run):
    c = run["counters"]
    vads = program_spans(run, "sre.vad")
    if not vads or not c.get("audio_s"):
        return None
    return 1e3 * seconds(vads) / (c["audio_s"] / 60.0)
