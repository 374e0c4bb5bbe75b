"""Share of its roofline that `csrc/table_gather.cu` reaches in the traced
part of the window: the least time of its launches by bytes
(`inputs/bounds.gather_bound_ms` at each launch's shape, recorded at the
call) over the profiler's time of the `table_gather_kernel` launches,
per launch."""

from common import kernel_s
from inputs.bounds import gather_bound_ms


def read(run):
    shapes = run["counters"].get("gather_shapes") or []
    secs, n = kernel_s(run, "table_gather_kernel")
    if not shapes or not n or secs <= 0:
        return None
    bound_s = sum(gather_bound_ms(*s) for s in shapes) / 1e3 / len(shapes)
    return 100.0 * bound_s / (secs / n)
