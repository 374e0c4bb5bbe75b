"""Share of the traced segment in which no device operation ran
(torch.profiler). Reads every `idle_pct.<cell kind>` metric: the traced
segment is the cell's own (runners' `trace_segment`)."""

from common import idle_pct


def read(run):
    return idle_pct(run)
