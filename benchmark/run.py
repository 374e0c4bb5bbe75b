"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this folder and
the program (`kaldi_tpu_torch/`). The run makes its inputs and weights
from the configuration's seed and `--seed`, sets up and warms up the
cell's traffic (counted as `setup_s`, from process start), measures for
`--seconds`, then checks what the timed path produced against the plain
reference under `benchmark/reference/`. With `--trace 0` the result holds
the cell's end-to-end metrics. With `--trace 1` the window's host spans
end in a device synchronize, a short segment of the same traffic runs
under torch.profiler after the window, and the result holds the cell's
per-layer metrics, the device's busy time over that segment and a
breakdown.

The last lines on standard error are the numbers compared, each beside
its limit; the last line on standard output is one JSON object. Without
a CUDA card (or with fewer than the cell asks for), or if JAX or the JAX
package is loaded, the run exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
# build and kernel caches at fixed paths inside the checkout, so that only
# a cell's first run there builds
CACHE = os.path.join(ROOT, "build", "bench_cache")


class Context:
    """What a runner gets: the cell, the run's options, the spans and the
    device trace, and where the program runs."""

    def __init__(self, cell, seed, seconds, trace, spans, dtrace, device):
        self.config = cell.config
        self.mix = cell.mix
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.spans = spans
        self.dtrace = dtrace
        self.device = device


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 1


def finite_or_none(x):
    return x if x is not None and math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    # one process with few threads: the host loop that paces the card
    # shares the machine's cores with nothing of its own
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [BENCH, ROOT]
    import harness

    bad = harness.forbidden_modules()
    if bad:
        return fail(f"loaded at start, not allowed: {bad}")
    manifest = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.resolve_cell(manifest, ROOT, args.workload)
    chips = int(cell.entry["chips"])
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        return fail("no CUDA card: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        return fail(f"{torch.cuda.device_count()} CUDA cards, the cell "
                    f"asks for {chips}")
    runner = harness.runner_of(cell)
    trace = bool(args.trace)
    spans = harness.Spans(trace, torch.cuda.synchronize)
    dtrace = harness.DeviceTrace(trace, tempfile.gettempdir())
    ctx = Context(cell, args.seed, args.seconds, trace, spans, dtrace,
                  "cuda")
    print(f"benchmark: {cell.name} seed {args.seed} card "
          f"{harness.card_line()}", file=sys.stderr)

    state = runner.setup(ctx)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    out = runner.run_window(state, ctx)
    if trace:
        out["counters"].update(runner.trace_segment(state, ctx))
    device = harness.device_record(chips, dtrace if trace else None)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"loaded by the end of the window, not allowed: {bad}")

    metrics = {}
    if not trace:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        run = dict(spans=spans, counters=out["counters"],
                   trace=dtrace.summary, config=cell.config, mix=cell.mix,
                   window_s=out["window_s"])
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t_check = time.perf_counter()
    checks = runner.check(state, ctx) + [
        dict(name="unanswered", value=out["failed"], limit=0)]
    correct = all(c["value"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if trace and dtrace.summary is not None:
        result["breakdown"] = {k: dtrace.summary[k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = {c["name"]: {"value": finite_or_none(c["value"]),
                                    "limit": c["limit"]} for c in checks}
    print(f"benchmark: setup_s {setup_s} window_s {out['window_s']} "
          f"check_s {time.perf_counter() - t_check} completions "
          f"{[round(t, 4) for t in out.get('completions', [])]}",
          file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
