"""The offline step's share of the card's peak: the TDNN's forward FLOPs
(2 x GEMM weights x real frames) over the window, against the dense bf16
tensor-core peak (`inputs/bounds.BF16_FLOP_PER_S`, 989 TFLOP/s)."""

from inputs.bounds import BF16_FLOP_PER_S


def read(run):
    c = run["counters"]
    if not c.get("real_frames") or run["window_s"] <= 0:
        return None
    flops = 2.0 * c["gemm_weights"] * c["real_frames"]
    return 100.0 * flops / run["window_s"] / BF16_FLOP_PER_S
