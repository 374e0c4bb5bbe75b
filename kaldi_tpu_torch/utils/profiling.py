"""Tracing/profiling: wall-clock timers, cumulative per-op profile,
NaN/Inf guards, xprof trace capture.

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
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict

import numpy as np
import torch


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

    def accu(self, key: str, seconds: float):
        self.seconds[key] += seconds
        self.counts[key] += 1

    def report(self, top: int = 20) -> str:
        """(ref: CuDevice::PrintProfile — top-N by cumulative time)."""
        rows = sorted(self.seconds.items(), key=lambda kv: -kv[1])[:top]
        total = sum(self.seconds.values())
        lines = [f"----- profile: total {total:.3f}s -----"]
        for k, s in rows:
            lines.append(f"{k:<40s} {s:9.3f}s  x{self.counts[k]}")
        return "\n".join(lines)


PROFILER = AccuProfiler()


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
