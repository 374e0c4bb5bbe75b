"""Milliseconds of `SreSystem.stats` (energy VAD on the host, then
`IvectorExtractor.batch_stats`: the f64 concatenation and upload, gselect
and the statistics on the device) per minute of audio completed: host
spans ending in a device synchronize."""

from common import span_s


def read(run):
    c = run["counters"]
    if not c.get("audio_s"):
        return None
    return 1e3 * span_s(run, "stats") / (c["audio_s"] / 60.0)
