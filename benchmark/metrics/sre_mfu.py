"""The speaker step's share of the card's peak over the window, each
precision's FLOPs against its own published peak (inputs/bounds.py):
f32 at FP32_FLOP_PER_S, 67 TFLOP/s, for gselect's loglikes (2 T (2D+1) I
over the voiced frames T); f64 at FP64_FLOP_PER_S, the FP64 tensor-core
67 TFLOP/s, for the statistics (2 T I D: X over dense posteriors), the
i-vector system (2 N I K^2 for L, 2 N I D K for b), the Cholesky (N K^3 /
3) and the solve (2 N K^2) over the N sides. Features and the VAD are
left out."""

from inputs.bounds import FP32_FLOP_PER_S, FP64_FLOP_PER_S


def read(run):
    c = run["counters"]
    if not c.get("voiced_frames") or run["window_s"] <= 0:
        return None
    T, N = c["voiced_frames"], c["utts"]
    I, D, K = c["num_gauss"], c["feat_dim"], c["ivector_dim"]
    f32 = 2.0 * T * (2 * D + 1) * I
    f64 = 2.0 * T * I * D + N * (2.0 * I * K * K + 2.0 * I * D * K
                                 + K ** 3 / 3.0 + 2.0 * K * K)
    busy = f32 / FP32_FLOP_PER_S + f64 / FP64_FLOP_PER_S
    return 100.0 * busy / run["window_s"]
