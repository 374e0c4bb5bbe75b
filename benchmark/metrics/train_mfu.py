"""The train step's share of the card's peak: 6 FLOPs per GEMM weight per
output frame (`inputs/bounds.train_flops_per_step`) over the window's
steps and the window, against the dense bf16 tensor-core peak (989
TFLOP/s)."""

from inputs.bounds import BF16_FLOP_PER_S, train_flops_per_step


def read(run):
    c = run["counters"]
    if not c.get("frames") or run["window_s"] <= 0:
        return None
    flops = train_flops_per_step(c["gemm_weights"], c["frames"])
    return 100.0 * flops / run["window_s"] / BF16_FLOP_PER_S
