"""Tracing/profiling: wall-clock timers, cumulative per-op profile,
program spans, NaN/Inf guards, xprof trace capture.

(ref: SURVEY.md §5 — base/timer.h:31 Timer; the CUDA layer's
 CuDevice::AccuProfile/PrintProfile cumulative per-op seconds
 (cudamatrix/cu-device.cc:376-400); decode binaries log per-utterance
 likelihood-per-frame and RTF. TPU equivalents: the same host-side
 counters + jax.profiler traces for device-side timelines.)

Counterpart of kaldi_tpu/utils/profiling.py: `Timer` as it is;
`AccuProfiler` synchronises the card before it reads the clock, so a span
around card work measures the work and not its enqueue; `device_trace` is
a `torch.profiler` trace written as Chrome JSON; `check_finite` walks dicts,
lists, tuples, dataclasses and tensors and names bad leaves as
`jax.tree_util.keystr` does.

The port's own spans (no JAX counterpart): `span(name, **counts)` times a
stretch of host work at batch, loop or step granularity and never
synchronises the card, so a span holds the host's enqueue plus whatever
the host waits for inside it. Each finished span (name, start and end on
`time.perf_counter()`'s clock, its id, its parent's and its request's:
the outermost span open in the same thread or task, kept in a
`contextvars` chain) goes into `RECORDER`, a ring of 2^16 spans that
overwrites its oldest and counts those as dropped (`spans()`,
`dropped()`), and its seconds, calls and counts into `PROFILER`'s totals
(`PROFILER.report()`). While a `torch.profiler` records, each span is
also a `record_function` annotation of the same name, so it lies on the
trace's timeline with the kernels it launched; otherwise that costs one
flag read. Spans are always on: there is no switch.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


class Timer:
    """(ref: base/timer.h:31)"""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


class AccuProfiler:
    """Cumulative per-key seconds + counts (ref: CuDevice::AccuProfile);
    where a card is present it is synchronised before each clock read, as
    CuDevice does, so a span times the card's work and not its enqueue."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)
        # key -> count name -> summed count
        self.sums = defaultdict(lambda: defaultdict(int))

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def track(self, key: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[key] += time.perf_counter() - t0
            self.counts[key] += 1

    def accu(self, key: str, seconds: float, counts: dict | None = None):
        """Add one call of `seconds` to `key`, and its `counts` (name ->
        int) to the key's sums."""
        self.seconds[key] += seconds
        self.counts[key] += 1
        for name, v in (counts or {}).items():
            self.sums[key][name] += v

    def report(self, top: int = 20) -> str:
        """(ref: CuDevice::PrintProfile — top-N by cumulative time), each
        key's summed counts after its calls."""
        rows = sorted(self.seconds.items(), key=lambda kv: -kv[1])[:top]
        total = sum(self.seconds.values())
        lines = [f"----- profile: total {total:.3f}s -----"]
        for k, s in rows:
            sums = "".join(f"  {n}={v}"
                           for n, v in self.sums.get(k, {}).items())
            lines.append(f"{k:<40s} {s:9.3f}s  x{self.counts[k]}{sums}")
        return "\n".join(lines)


PROFILER = AccuProfiler()


class SpanRecord(NamedTuple):
    """A finished span: its name, start and end (seconds on
    `time.perf_counter()`'s clock), its id, the id of the span it ran in
    (None for the outermost) and of the outermost one (its request), and
    its counts."""

    name: str
    start: float
    end: float
    id: int
    parent: int | None
    request: int
    counts: dict


# (id, request id) of the innermost open span of this thread or task
_CHAIN: contextvars.ContextVar = contextvars.ContextVar(
    "kaldi_tpu_torch_span", default=None)
_IDS = itertools.count(1)


class _Span:
    """One use of `SpanRecorder.span`; `counts` may be set before exit."""

    __slots__ = ("_recorder", "name", "counts", "start", "id", "parent",
                 "request", "_token", "_annotation")

    def __init__(self, recorder: "SpanRecorder", name: str, counts: dict):
        self._recorder = recorder
        self.name = name
        self.counts = counts

    def __enter__(self):
        outer = _CHAIN.get()
        self.id = next(_IDS)
        self.parent, self.request = outer or (None, self.id)
        self._token = _CHAIN.set((self.id, self.request))
        self._annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _CHAIN.reset(self._token)
        self._recorder.record(SpanRecord(self.name, self.start, end, self.id,
                                         self.parent, self.request,
                                         self.counts))
        return False


class SpanRecorder:
    """Finished spans in a ring of `capacity`: once it is full each new
    span overwrites the oldest, which counts as dropped. Each span's
    seconds and counts also go into `profiler`'s per-name totals."""

    def __init__(self, capacity: int = 1 << 16,
                 profiler: AccuProfiler | None = None):
        self.capacity = capacity
        self.profiler = AccuProfiler() if profiler is None else profiler
        self._ring: list = [None] * capacity
        self._n = 0
        self._lock = threading.Lock()

    def span(self, name: str, **counts) -> _Span:
        """Context manager timing the host work inside it; integer counts
        given here or set on its `counts` before exit."""
        return _Span(self, name, counts)

    def record(self, rec: SpanRecord):
        with self._lock:
            self._ring[self._n % self.capacity] = rec
            self._n += 1
            self.profiler.accu(rec.name, rec.end - rec.start, rec.counts)

    def spans(self) -> list[SpanRecord]:
        """The ring's spans, oldest finished first."""
        with self._lock:
            if self._n < self.capacity:
                return self._ring[:self._n]
            i = self._n % self.capacity
            return self._ring[i:] + self._ring[:i]

    def dropped(self) -> int:
        """Spans overwritten since the recorder started."""
        return max(0, self._n - self.capacity)


# the process's recorder, which the port's modules record into
RECORDER = SpanRecorder(profiler=PROFILER)
span = RECORDER.span
spans = RECORDER.spans
dropped = RECORDER.dropped


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace (host ops, and the card's kernels
    when one is present) into `log_dir`/trace.json, viewable in
    chrome://tracing or Perfetto; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _leaves_with_path(node, path: str = ""):
    """(keystr path, leaf) pairs in jax.tree_util's order: dict keys
    sorted, sequences and dataclass fields in order; None is no leaf."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves_with_path(node[k], f"{path}[{k!r}]")
    elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
        for i, v in enumerate(node):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif hasattr(node, "_fields"):
        for f in node._fields:
            yield from _leaves_with_path(getattr(node, f), f"{path}.{f}")
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            yield from _leaves_with_path(getattr(node, f.name),
                                         f"{path}.{f.name}")
    else:
        yield path, node


def check_finite(tree, name: str = "tree"):
    """NaN/Inf guard for nested containers of tensors and arrays (ref:
    SURVEY.md §5 race-detection row); bad leaves are named by their path
    as jax.tree_util.keystr names them, e.g. ['layer0']['w'] or [1]."""
    bad = []
    for path, leaf in _leaves_with_path(tree):
        a = (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
             else np.asarray(leaf))
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            bad.append(path)
    if bad:
        raise FloatingPointError(f"{name}: non-finite values at {bad}")
    return tree
