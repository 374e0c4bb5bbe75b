"""Run a cell's control: the plain reference put in the program's place
at one precision below the configuration's, at the cell's own sizes, on
the inputs of each seed given, with the numbers the run's check compares
printed beside their limits. The control has to fail a limit. With
`--fault <name>`, the reference runs at full precision with that fault
planted in it instead (the runner's FAULTS).

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 \
        [--fault <name> ...]

Runs on the card; imports nothing of the program.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", nargs="+", default=[None],
                    help="plant each of these faults in the reference, in "
                         "turn, instead of lowering its precision (the "
                         "runner's FAULTS)")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH]
    import harness
    from run import Context
    cell = harness.resolve_cell(harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")), ROOT, args.workload)
    runner = harness.runner_of(cell)
    shared: dict = {}
    limits = cell.mix["limits"]
    for seed in args.seeds:
        for fault in args.fault:
            t = time.perf_counter()
            ctx = Context(cell, seed, 0.0, False, harness.Spans(False),
                          harness.DeviceTrace(False, ""), "cuda")
            nums = (runner.control_numbers(ctx, shared) if fault is None
                    else runner.fault_numbers(ctx, shared, fault))
            failed = [n for n in limits if not nums[n] <= limits[n]]
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "fault": fault, "control": nums,
                              "limits": limits, "fails": failed,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
            if harness.forbidden_modules() \
                    or "kaldi_tpu_torch" in sys.modules:
                print("control: loaded the program or JAX", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
