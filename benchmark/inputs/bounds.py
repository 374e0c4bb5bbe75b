"""Published peaks of one NVIDIA H100 SXM and the least-time and FLOP
arithmetic the per-layer metrics divide by.

Frozen copies of `chip_smoke.py`'s `HBM_BYTES_PER_S`, `BF16_FLOP_PER_S`,
`gather_bound_ms`, `qaffine_bound_ms` and `train_flops_per_step` (the
last counts the TDNN's GEMM weights from its widths instead of building
the port's module). Peaks are NVIDIA's data sheet for the SXM part,
dense, at its 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12          # dense tensor cores
FP32_FLOP_PER_S = 67e12           # CUDA cores, no tensor cores
FP64_FLOP_PER_S = 67e12           # FP64 tensor cores


def gather_bound_ms(B: int, P: int, N: int) -> float:
    """Least time for one table gather out[b, j] = tab[b, idx[b, j]]
    (tab [B, P] f32, idx [B, N] int32): the index read and the output
    write (4 B each per element) and the table read once, over the HBM
    rate. It does no arithmetic, so bytes bound it."""
    return (8 * B * N + 4 * B * P) / HBM_BYTES_PER_S * 1e3


def qaffine_bound_ms(M: int, K: int, N: int,
                     passes: int = 1) -> tuple[float, str]:
    """Least time for one int8 weight-only affine [M, K] x [K, N]: the
    larger of its 2MNK FLOPs over the dense bf16 tensor-core rate and its
    bytes (x, int8 weights, scale and bias read once, y written once) over
    the HBM rate. passes=3 gives the ceiling of a design that multiplies
    three bf16 planes of x."""
    t_ops = passes * 2 * M * K * N / BF16_FLOP_PER_S * 1e3
    t_bytes = (4 * M * K + N * K + 8 * N + 4 * M * N) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tdnn_gemm_weights(feat_dim: int, hidden_dim: int, num_pdfs: int,
                      splice_indexes) -> int:
    """GEMM weights of a relu TDNN: each hidden layer's spliced input times
    its width, then the final affine."""
    w, in_dim = 0, feat_dim
    for ctx in splice_indexes:
        w += in_dim * len(ctx) * hidden_dim
        in_dim = hidden_dim
    return w + in_dim * num_pdfs


def train_flops_per_step(gemm_weights: int, frames: int) -> float:
    """6 FLOPs (forward 2, backward 4) per GEMM weight per output frame."""
    return 6.0 * gemm_weights * frames
