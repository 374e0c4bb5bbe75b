"""Helpers the per-layer metric readers share. A reader is
`metrics/<metric name>.py` with `read(run) -> float | None`; `run` holds
the run's host spans (`spans`, a harness.Spans), the runner's counters
(`counters`), the reduced device trace (`trace`, None when the run was
not traced), the configuration, the traffic mix and `window_s`. A reader
that finds nothing to read returns None."""

from __future__ import annotations


def span_s(run: dict, name: str) -> float:
    """Seconds of the spans called `name` that ended inside the window."""
    c = run["counters"]
    lo, hi = c.get("window_start", float("-inf")), c.get("window_end",
                                                         float("inf"))
    return sum(b - a for n, a, b in run["spans"].records
               if n == name and a >= lo and b <= hi)


def idle_pct(run: dict):
    """Share of the traced window in which no device operation ran."""
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_s(run: dict, needle: str) -> tuple[float, int]:
    """Total seconds and launches of the traced kernels whose name holds
    `needle`."""
    tr = run["trace"] or {}
    ks = [d for n, d in tr.get("kernels", []) if needle in n]
    return sum(ks), len(ks)
