"""Milliseconds of the port's MFCC + deltas per side and the copy of the
features to the host, per minute of audio completed: host spans ending
in a device synchronize (traced run)."""

from common import span_s


def read(run):
    c = run["counters"]
    if not c.get("audio_s"):
        return None
    return 1e3 * span_s(run, "features") / (c["audio_s"] / 60.0)
