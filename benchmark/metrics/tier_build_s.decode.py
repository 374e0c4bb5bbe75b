"""Seconds of set-up in the decoder's tier-table build: the program's
`csr_beam.build_tier_tables` spans that end before the window starts
(numpy packing on the host and the tables' copy to the card)."""

import math

from program_spans import program_spans, seconds


def read(run):
    c = run["counters"]
    if "window_start" not in c:
        return None
    builds = program_spans(run, "csr_beam.build_tier_tables", lo=-math.inf,
                           hi=c["window_start"])
    if not builds:
        return None
    return seconds(builds)
