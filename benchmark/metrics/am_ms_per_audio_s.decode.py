"""Milliseconds of the port's fbank + CMVN and AM calls per second of
audio completed: host spans around each call, each ending in a device
synchronize (traced run)."""

from common import span_s


def read(run):
    c = run["counters"]
    if not c.get("audio_s"):
        return None
    return 1e3 * (span_s(run, "features") + span_s(run, "am")) / c["audio_s"]
