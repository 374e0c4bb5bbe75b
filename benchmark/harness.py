"""What every cell's run shares: the manifest and its files, the check that
neither JAX nor the JAX package is loaded, host spans around the calls
into the program, the device trace of the traced run and its reduction,
the device record and the result line.

Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "kaldi_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names (the part before the first dot, compared whole) of
    loaded modules that a run may not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file at `path` as module `name` (file names may hold
    dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its configuration, its traffic
    mix and the metrics it reports."""

    name: str
    entry: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def resolve_cell(manifest: dict, root: str, workload: str) -> Cell:
    """The cell named `workload`: its configuration file (by the config's
    name), its traffic file (`benchmark/traffic/<traffic>.json`) and the
    metrics that list it or list no cells."""
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    mix = load_json(os.path.join(BENCH, "traffic", entry["traffic"] + ".json"))

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return Cell(workload, entry, config, mix, mine(manifest["end_to_end"]),
                mine(manifest["per_layer"]))


def runner_of(cell: Cell):
    """The runner module the traffic mix names (`benchmark/runners/`)."""
    name = cell.mix["runner"]
    return load_module(os.path.join(BENCH, "runners", name + ".py"),
                       f"bench_runner_{name}")


def metric_reader(name: str):
    """The reader of a per-layer metric: `benchmark/metrics/<name>.py`,
    or, where there is no such file, the reader of the name without its
    last `.<part>` (`idle_pct.train` -> `idle_pct.py`), so that one
    reader serves a quantity split by the metric it moves. Its helpers,
    `metrics/common.py`, import as `common`."""
    mdir = os.path.join(BENCH, "metrics")
    if mdir not in sys.path:
        sys.path.append(mdir)
    base = name
    while not os.path.exists(os.path.join(mdir, base + ".py")) \
            and "." in base:
        base = base.rsplit(".", 1)[0]
    return load_module(os.path.join(mdir, base + ".py"),
                       "bench_metric_" + base.replace(".", "_"))


class Spans:
    """Host spans around the calls into the program's layers: (name,
    start, end) on the host clock. In a traced run each span is also a
    profiler annotation ("bench.<name>") and ends in a device synchronize,
    so that its length covers the device work it enqueued (unless the
    span is opened with sync=False)."""

    def __init__(self, trace: bool, sync=None):
        self.trace = trace
        self.sync = sync
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = True):
        rf = None
        if self.trace:
            import torch
            rf = torch.profiler.record_function("bench." + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and self.trace and self.sync is not None:
                self.sync()
            self.records.append((name, t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)


class DeviceTrace:
    """torch.profiler over a segment of the traced run, run after its
    window (so the window's timings carry no profiler), reduced to the
    device's busy time, the segment's length, the device operations that
    took most time, the longest idle gaps by the span open on the host,
    and each kernel launch's name and duration."""

    def __init__(self, enabled: bool, tmpdir: str):
        self.enabled = enabled
        self.tmpdir = tmpdir
        self.summary: dict | None = None
        self._prof = None
        self._rf = None

    def start(self):
        if not self.enabled or self._prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._rf = torch.profiler.record_function("bench.window")
        self._rf.__enter__()

    def stop(self):
        """End the segment and reduce its trace."""
        if self._prof is None or self.summary is not None:
            return
        import torch
        torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        path = os.path.join(self.tmpdir, f"bench_trace_{os.getpid()}.json")
        try:
            self._prof.export_chrome_trace(path)
            self.summary = reduce_trace(load_json(path)["traceEvents"])
        finally:
            if os.path.exists(path):
                os.remove(path)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_trace(events: list) -> dict:
    """Chrome-trace events -> dict(busy_s, window_s, device_ops [[name,
    s]] (10 longest by total), idle_gaps [[span, s]] (10 largest sums),
    kernels [(name, s)] in launch order)."""
    win = next(e for e in events if e.get("name") == "bench.window"
               and e.get("cat") == "user_annotation")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e["name"]) for e in events
                 if e.get("cat") in DEVICE_CATS and "ts" in e)
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    busy, merged = 0.0, []
    for a, b, _n in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    by_name: dict[str, float] = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][len("bench."):]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("bench.")
                   and e["name"] != "bench.window")
    gaps: dict[str, float] = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    cuts = sorted({x for s in spans for x in s[:2]})
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        # split the gap at span boundaries; each piece goes to the
        # innermost span open at its start
        pts = [a] + [x for x in cuts if a < x < b] + [b]
        for p, q in zip(pts, pts[1:]):
            inner = [s for s in spans if s[0] <= p < s[1]]
            name = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
                else "outside any span"
            gaps[name] = gaps.get(name, 0.0) + (q - p)

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return dict(busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6,
                device_ops=top(by_name), idle_gaps=top(gaps),
                kernels=[(n, (b - a) / 1e6) for a, b, n in dev])


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the cards, or why not."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not readable: {e}"


def device_record(count: int, trace: DeviceTrace | None) -> dict:
    import torch
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count,
           "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                    for d in range(count))}
    if trace is not None and trace.summary is not None:
        rec["busy_s"] = trace.summary["busy_s"]
        rec["window_s"] = trace.summary["window_s"]
    return rec
