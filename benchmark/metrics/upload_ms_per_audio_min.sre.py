"""Milliseconds of the extractor's upload per minute of audio completed:
the program's `ivector.upload` spans in the window
(`IvectorExtractor.batch_stats`: each chunk's f64 concatenation on the
host and its pageable copy to the card, which waits for the card's
earlier work on the stream)."""

from program_spans import program_spans, seconds


def read(run):
    c = run["counters"]
    ups = program_spans(run, "ivector.upload")
    if not ups or not c.get("audio_s"):
        return None
    return 1e3 * seconds(ups) / (c["audio_s"] / 60.0)
