#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths once on one CUDA card
and check them.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and the script exits non-zero):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile every kernel in kaldi_tpu_torch/csrc (one nvcc each,
     all at once) and print ptxas' registers / spills;
  3. table-gather kernel vs plain: bit-exact against torch.gather at the
     decoder's shapes and at the edges, with CUDA-graph timings beside an
     empty kernel at the same grid (the launch floor);
  4. qaffine kernel vs plain (`qaffine_ref`) at the int8 TDNN's shapes and
     at the edges; both against an f64 product, and the kernel at small K
     held to a limit that a kernel without the lo pass of x fails; timings
     of the kernel, the plain version and torch.addmm over pre-dequantized
     weights; its bound is 2MNK on the bf16 tensor cores or its bytes,
     printed beside the design's three-pass ceiling and the FP32-FMA bound;
  5. decoder on the card vs the same port on the CPU, on small graphs:
     identical words, tids and counters, cost within 1e-2;
  6. int8 decode on the card vs on the CPU (small QuantizedTdnn behind
     `Recognizer`): identical words and tids, cost within 1e-2;
  7. full-width slice: the 60k-word / 1.05M-state HCLG and the 2048-pdf
     relu TDNN (random weights from a seed) behind `Recognizer`, answering
     three requests of 8 x 10 s utterances in bf16 at beam 13,
     max_active 7000, expand_budget 16384, then one request split by
     layer; --profile adds one decode under torch.profiler (device busy
     share and the kernels that take the device time);
  8. full-width int8 slice: the same graph and corpus behind
     `Recognizer(QuantizedTdnn)`, three requests, 6 qaffine launches each,
     then bf16 and int8 requests in turns;
  9. streaming, small: `FusedStreamingServer` on the card vs on the CPU,
     and each stream vs the offline decode on the card;
 10. streaming, full width: 16 streams of 10 s fed 160 ms per step into
     the server over the 60k-word HCLG and the 2048-pdf f32 TDNN behind
     `AmNnet`; every stream equals its offline decode on the card;
     --profile adds six steady steps under torch.profiler;
 11. lattice path, small: `decode_raw` on the small graphs in dense, f16
     and flat modes (and with init rounds) on the card equals the CPU;
     native lattices equal numpy ones; chunked equals one-shot and
     adaptive equals full on the card; a keep-loglikes server's
     `get_lattice` equals the offline lattice on the card;
 12. training, small, at the CPU tests' shapes: 8 f32 and 8 bf16 steps
     of `make_train_step` over `make_optimizer` with clip, l2 and
     momentum on, 12 `ng_sgd` steps across a refresh, `train_progressive`
     through its three stages, each on the card against the same on the
     CPU (limits in TRAIN_LIMITS), and a checkpoint of card params read
     back equal;
 13. training, full width: the bench's AM (the relu TDNN above) trained
     on the bench's corpus (16 x 10 s, full batch, bf16) with the port's
     `make_optimizer` and `make_train_step` for 400 steps, as bench.py
     trains it, then 10 steps between CUDA events: ms/step, frames/s,
     TFLOP/s and train_mfu by the bench's count (6 x GEMM weights x output
     frames), peak memory, final loss and frame accuracy; 20 `ng_sgd`
     steps (two refreshes) and one f32 step at the same width; --profile
     adds three train steps under torch.profiler;
 14. lattice path, full width, at the bench's latgen point (max_active
     7000, beam 13, expand_budget 16384, eps_budget 2048, rec_cap 3072,
     rec_beam = lattice_beam = 8, rec_f16, rec_flat, rec_flat_cap 512),
     on the bench's 8 test utterances with phase 13's AM:
     `decode_to_lattices_stream` over 3 batches of 8 x 10 s on 8
     extraction threads, twice, then one batch split into record decode,
     copy and extraction; the rec_trunc share of shipped slots must stay
     under 5%; untruncated records, whose excess over rec_cap must be
     rec_trunc exactly; records with nothing masked, whose lattice best
     paths equal the bf16 `Recognizer`'s words; one adaptive decode
     (small_max_active 1024) against one full decode;
 15. online path, small: mfcc, plp and deltas, the padded
     `BeamSearchDecoder`, both `FusedOnlineDecoder` engines (each stream
     also against the offline decode on the card) and
     `SingleUtteranceNnet2Decoder` with online i-vectors, each on the card
     against the CPU; the mixed-up AM's group sum: two card runs
     bit-equal, the card within 1e-6 relative of the CPU;
 16. online path, full width, at scripts/bench_streaming.py's
     configuration (the 300-word HCLG, a relu TDNN of width 512 over 64
     pdfs trained 300 bf16 steps on the card, 160 ms chunks): the fused
     path (`FusedOnlineDecoder` on the CSR engine, with `get_lattice`)
     over 6 utterances and the generic path (`SingleUtteranceNnet2Decoder`
     over the padded engine) over 3: online RTF, chunk latency p50 / p95,
     finalize and get_lattice ms, max delay, and hypothesis mismatches
     against the offline decode on the card, which must be 0; then the
     gather kernel timed at the fused path's B = 1 shapes.

The line before the last is a JSON object with each kernel's launches on
its path, error against its plain version, times and bound; the last line
is {"ok": true, "device": {...}}. There is no CPU fallback: without CUDA
the script fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

GATHER_SHAPES = [(8, 2048, 30384),   # fused acoustic lookup, per frame
                 (8, 7000, 4096)]    # frontier-score lookup, per frame
# published H100 SXM peaks (NVIDIA data sheet), at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12             # dense tensor cores

# (M, K, N) of the int8 TDNN's qaffine calls at B = 8, T = 998 (M = 7984),
# with how many of the 6 calls of one request have that shape
QAFFINE_SHAPES = [((7984, 200, 1024), 1), ((7984, 2048, 1024), 3),
                  ((7984, 1024, 1024), 1), ((7984, 1024, 2048), 1)]
QAFFINE_EDGES = [(40, 128, 128),      # tests/test_quantized.py's shape
                 (1, 200, 1024),      # M = 1
                 (37, 72, 48),        # M, K, N all ragged
                 (300, 72, 1024),     # K = 72
                 (130, 1024, 48),     # N = 48
                 (200, 33, 1000),     # K % 4 != 0 (scalar loads), N ragged
                 (129, 256, 130)]     # one row and two columns past a tile
GATHER_EDGES = [(3, 200, 1000),      # P not a multiple of 128
                (2, 4096, 5000),     # widest staged row
                (2, 4097, 3001),     # narrowest direct row, N % 4 != 0
                (2, 16384, 5000),    # wide direct rows
                (2, 20000, 3000),
                (4, 7000, 1),        # N = 1
                (3, 2048, 1001),     # staged, N % 4 != 0
                (1, 2048, 30384)]    # B = 1


def log(*a):
    print(*a, flush=True)


def wer(refs: list[list], hyps: list[list]) -> float:
    """Corpus word error rate in percent (Levenshtein over words)."""
    errs = total = 0
    for r, h in zip(refs, hyps):
        d = list(range(len(h) + 1))
        for i, rw in enumerate(r, 1):
            prev, d[0] = d[0], i
            for j, hw in enumerate(h, 1):
                prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1,
                                       prev + (rw != hw))
        errs += d[-1]
        total += len(r)
    return 100.0 * errs / max(total, 1)


def star_hub_graph(n_words=300):
    """State 0 fans out n_words arcs with distinct pdfs (so the hub's pdf
    groups exceed 128 and the hub gathers through the kernel); every word
    state loops back to 0."""
    from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
    deg = np.r_[n_words, np.ones(n_words, np.int64)]
    arc_start = np.r_[0, np.cumsum(deg)].astype(np.int32)
    n_arcs = int(arc_start[-1])
    rng = np.random.RandomState(0)
    il = np.r_[np.arange(1, n_words + 1),
               np.full(n_words, n_words + 1)].astype(np.int32)
    ol = np.r_[np.arange(1, n_words + 1), np.zeros(n_words)].astype(np.int32)
    cost = np.r_[rng.rand(n_words), np.full(n_words, 0.25)].astype(np.float32)
    nxt = np.r_[np.arange(1, n_words + 1), np.zeros(n_words)].astype(np.int32)
    pdf = np.r_[np.arange(n_words), np.full(n_words, n_words)].astype(np.int32)
    final = np.full(n_words + 1, np.inf, np.float32)
    final[0] = 0.0
    assert len(il) == n_arcs
    return PackedGraph(start=0, arc_start=arc_start, ilabel=il, olabel=ol,
                       cost=cost, nextstate=nxt, pdf=pdf, final=final)


def cuda_ms(fn, reps: int = 20, per: int = 100) -> float:
    """Device time of one call in ms: `per` calls captured in one CUDA
    graph, replayed `reps` times between CUDA events; the median replay
    over `per`. The graph takes the host's launch cost out of the
    number, which back-to-back eager calls from Python would measure
    instead. Inputs stay L2-resident between calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / per)
    return float(np.median(ts))


def gather_bound_ms(B: int, P: int, N: int) -> float:
    """Least time for one gather: the index read and the output write (4 B
    each per element) and the table read once, over the HBM rate. It does
    no arithmetic, so bytes bound it."""
    return (8 * B * N + 4 * B * P) / HBM_BYTES_PER_S * 1e3


def qaffine_bound_ms(M: int, K: int, N: int,
                     passes: int = 1) -> tuple[float, str]:
    """Least time for one qaffine call: the larger of its 2MNK FLOPs over
    the dense bf16 tensor-core rate and its bytes (x, int8 weights, scale
    and bias read once, y written once) over the HBM rate. passes=3 gives
    the ceiling of the kernel's design, which multiplies three bf16 planes
    of x (3 x 2MNK FLOPs)."""
    t_ops = passes * 2 * M * K * N / BF16_FLOP_PER_S * 1e3
    t_bytes = (4 * M * K + N * K + 8 * N + 4 * M * N) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def qaffine_fp32_bound_ms(M: int, K: int, N: int) -> float:
    """The same call's 2MNK FLOPs over the FP32 rate of the CUDA cores:
    the ceiling of a true-f32 design without tensor cores."""
    return 2 * M * K * N / FP32_FLOP_PER_S * 1e3


def gather_floor_fn():
    """An empty kernel launched with the gather's grid and block for a
    shape: the per-launch floor under the gather's device time."""
    import ctypes
    import torch
    from kaldi_tpu_torch import cuda_build
    fn = cuda_build.load("table_gather", "kaldi_table_gather_floor",
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def launch(B: int, P: int, N: int):
        rc = fn(B, P, N, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {rc}")
    return launch


def phase_kernel(tg) -> dict:
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    err = 0.0
    for (B, P, N) in GATHER_SHAPES + GATHER_EDGES:
        tab = torch.randn(B, P, device="cuda", generator=g)
        idx = torch.randint(0, P, (B, N), device="cuda", generator=g,
                            dtype=torch.int32)
        # and the same indices one int32 past a 16-byte boundary (scalar
        # loads and stores)
        moved = torch.empty(B * N + 1, dtype=torch.int32,
                            device="cuda")[1:].view(B, N)
        moved.copy_(idx)
        want = torch.gather(tab, 1, idx.long())
        for i in (idx, moved):
            got = tg.gather_cuda(tab, i)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != torch.gather at "
                                     f"{(B, P, N)}, index base "
                                     f"{i.data_ptr() % 16} mod 16")
            err = max(err, float((got - want).abs().max()))
    # out-of-range indices give 0.0, as in the TPU kernel
    tab = torch.randn(2, 100, device="cuda", generator=g)
    idx = torch.tensor([[-1, 0, 99, 100], [5, 1000, -7, 3]],
                       dtype=torch.int32, device="cuda")
    if not torch.equal(tg.gather_cuda(tab, idx),
                       tg.batched_table_gather_ref(tab, idx)):
        raise AssertionError("kernel != plain version on out-of-range indices")
    torch.cuda.synchronize()
    floor = gather_floor_fn()
    times = {}
    for (B, P, N) in GATHER_SHAPES:
        tab = torch.randn(B, P, device="cuda", generator=g)
        idx = torch.randint(0, P, (B, N), device="cuda", generator=g,
                            dtype=torch.int32)
        il = idx.long()
        times[(B, P, N)] = (cuda_ms(lambda: tg.gather_cuda(tab, idx)),
                            cuda_ms(lambda: tg.batched_table_gather_ref(tab,
                                                                        idx)),
                            cuda_ms(lambda: torch.gather(tab, 1, il)),
                            cuda_ms(lambda: floor(B, P, N)))
        k_ms, p_ms, l_ms, f_ms = times[(B, P, N)]
        log(f"  gather tab [{B}, {P}] idx [{B}, {N}]: kernel {k_ms:.6f} ms, "
            f"plain version {p_ms:.6f} ms, torch.gather alone {l_ms:.6f} "
            f"ms, empty kernel at the same grid (launch floor) {f_ms:.6f} "
            f"ms, bound {gather_bound_ms(B, P, N):.6f} ms by bytes (device "
            f"time per call: CUDA graph of 100 calls, median of 20 replays)")
    log(f"  kernel bit-exact at {len(GATHER_SHAPES + GATHER_EDGES)} shapes, "
        f"each with an aligned and a misaligned index base, and on "
        f"out-of-range indices")
    return {"max_abs_err": err, "times": times}


def _qaffine_case(M: int, K: int, N: int, g):
    """x [M, K] and bias [N] from the card's generator; int8 weights
    quantized (numpy) from seeded normal weights of stddev 1/sqrt(K)."""
    import torch
    from kaldi_tpu_torch.nnet.quantized import quantize_weights
    rng = np.random.default_rng(7 * M + 3 * K + N)
    wq, sc = quantize_weights(rng.standard_normal((N, K)).astype(np.float32)
                              / np.sqrt(K))
    x = torch.randn(M, K, device="cuda", generator=g)
    b = torch.randn(N, device="cuda", generator=g)
    return x, torch.from_numpy(wq).cuda(), torch.from_numpy(sc).cuda(), b


def phase_qaffine(q) -> dict:
    import torch
    g = torch.Generator(device="cuda").manual_seed(1)
    worst_abs = worst_rel = 0.0
    for (M, K, N) in [sh for sh, _n in QAFFINE_SHAPES] + QAFFINE_EDGES:
        x, wq, sc, b = _qaffine_case(M, K, N, g)
        got = q.qaffine_cuda(x, wq, sc, b)
        torch.cuda.synchronize()
        want = q.qaffine_ref(x, wq, sc, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        # the tensor cores' f32 sums truncate and run in another order
        # over K <= 2048: 1e-5 of the output's scale; at the JAX test's
        # shape atol 1e-4, as
        # tests/test_quantized.py:53 holds the Pallas kernel
        lim = 1e-4 if (M, K, N) == (40, 128, 128) else 1e-5 * top
        if not err <= lim:
            raise AssertionError(f"qaffine kernel vs plain at {(M, K, N)}: "
                                 f"max abs err {err} > {lim}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / top)
    log(f"  kernel within tolerance at {len(QAFFINE_SHAPES)} path shapes and "
        f"{len(QAFFINE_EDGES)} edges: max abs err {worst_abs:.3e}, max "
        f"err / max|y| {worst_rel:.3e}")
    f64 = qaffine_f64_errors(q, g)
    times = {}
    for (M, K, N), _n in QAFFINE_SHAPES:
        x, wq, sc, b = _qaffine_case(M, K, N, g)
        w_deq_t = (wq.to(torch.float32) * sc[:, None]).T    # [K, N] f32
        times[(M, K, N)] = (
            cuda_ms(lambda: q.qaffine_cuda(x, wq, sc, b), per=10),
            cuda_ms(lambda: q.qaffine_ref(x, wq, sc, b), per=10),
            cuda_ms(lambda: torch.addmm(b, x, w_deq_t), per=10))
        (bound, by), (ceil, _) = (qaffine_bound_ms(M, K, N),
                                  qaffine_bound_ms(M, K, N, passes=3))
        k_ms, p_ms, l_ms = times[(M, K, N)]
        log(f"  qaffine x [{M}, {K}] wq [{N}, {K}]: kernel {k_ms:.6f} ms "
            f"({2 * M * K * N / k_ms / 1e9:.1f} TFLOP/s of products, "
            f"{6 * M * K * N / k_ms / 1e9:.1f} as three bf16 passes), plain "
            f"version {p_ms:.6f} ms, torch.addmm on f32 weights {l_ms:.6f} "
            f"ms, bound {bound:.6f} ms by {by} (three bf16 passes would "
            f"take {ceil:.6f} ms; FP32 FMAs "
            f"{qaffine_fp32_bound_ms(M, K, N):.6f} ms) (device time per "
            f"call: CUDA graph of 10 calls, median of 20 replays)")
    per_req = [sum(n * times[sh][i] for sh, n in QAFFINE_SHAPES)
               for i in range(3)]

    def per_request(passes: int) -> tuple[float, str]:
        """A request's bound, summed over its calls, and the kind that
        holds most of it (the K = 200 call alone is bound by bytes)."""
        parts = [(n * b, kind) for (b, kind), n in
                 ((qaffine_bound_ms(*sh, passes=passes), n)
                  for sh, n in QAFFINE_SHAPES)]
        return (sum(b for b, _k in parts),
                max(("operations", "bytes"),
                    key=lambda kind: sum(b for b, k in parts if k == kind)))
    (bound_req, by), (ceil_req, ceil_by) = per_request(1), per_request(3)
    fp32_req = sum(n * qaffine_fp32_bound_ms(*sh) for sh, n in QAFFINE_SHAPES)
    log(f"  per request (6 calls): kernel {per_req[0]:.6f} ms, plain "
        f"{per_req[1]:.6f} ms, torch.addmm {per_req[2]:.6f} ms (it reads "
        f"f32 weights: 4x the int8 bytes), bound {bound_req:.6f} ms by "
        f"{by} (2MNK at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, or bytes) = "
        f"{100 * bound_req / per_req[0]:.1f}% of the kernel's time; the "
        f"design's ceiling, three bf16 passes, {ceil_req:.6f} ms by "
        f"{ceil_by} = {100 * ceil_req / per_req[0]:.1f}%; the FP32-FMA "
        f"bound of a true-f32 design {fp32_req:.6f} ms")
    if not per_req[0] < per_req[2]:
        raise AssertionError(f"qaffine {per_req[0]:.6f} ms per request is "
                             f"not below torch.addmm's {per_req[2]:.6f} ms")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": per_req[0], "plain_ms": per_req[1],
            "library_ms": per_req[2], "bound_ms": bound_req, "bound_by": by,
            "three_pass_bound_ms": ceil_req, "fp32_bound_ms": fp32_req,
            **f64}


# x with full 24-bit mantissas at small K, where the accumulation adds
# little error: a kernel that drops the lo plane of x (2^-17 of each x)
# lands near 2e-6 of max|y| against the f64 product, a three-pass one
# near 1e-7 (as tests/test_torch_cuda.py holds it)
QAFFINE_ALL_OF_X = [(256, 16, 256), (512, 64, 512)]
QAFFINE_ALL_OF_X_LIM = 1e-6


def qaffine_f64_errors(q, g) -> dict:
    """Kernel and plain version against the product in f64: err / max|y|
    at each path shape, and the kernel at QAFFINE_ALL_OF_X held to
    QAFFINE_ALL_OF_X_LIM."""
    import torch

    def rel(M, K, N):
        x, wq, sc, b = _qaffine_case(M, K, N, g)
        want = ((x.double() @ wq.double().T) * sc.double() + b.double())
        top = float(want.abs().max())
        return [float((f(x, wq, sc, b).double() - want).abs().max()) / top
                for f in (q.qaffine_cuda, q.qaffine_ref)]
    for sh in QAFFINE_ALL_OF_X:
        k_rel, _p = rel(*sh)
        if not k_rel <= QAFFINE_ALL_OF_X_LIM:
            raise AssertionError(f"qaffine vs f64 at {sh}: err / max|y| "
                                 f"{k_rel:.3e} > {QAFFINE_ALL_OF_X_LIM}")
        log(f"  kernel vs f64 at {sh} (full-mantissa x): err / max|y| "
            f"{k_rel:.3e} <= {QAFFINE_ALL_OF_X_LIM}")
    worst = [0.0, 0.0]
    for sh, _n in QAFFINE_SHAPES:
        k_rel, p_rel = rel(*sh)
        torch.cuda.synchronize()
        worst = [max(worst[0], k_rel), max(worst[1], p_rel)]
        log(f"  vs f64 at {sh}: err / max|y| kernel {k_rel:.3e}, plain f32 "
            f"version {p_rel:.3e}")
    return {"max_rel_err_f64": worst[0], "plain_max_rel_err_f64": worst[1]}


def _same_results(name: str, got: list, want: list, what: str):
    """Identical words and tids, cost within 1e-2, per utterance."""
    for b, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None):
            raise AssertionError(f"{name}: utt {b} hypothesis presence")
        if g is None:
            continue
        if list(g[0]) != list(w[0]) or list(g[1]) != list(w[1]) \
                or abs(g[2] - w[2]) > 1e-2:
            raise AssertionError(f"{name}: utt {b} differs: {what} {g} "
                                 f"reference {w}")


def phase_int8_parity():
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.decoder.simulate import make_corpus
    from kaldi_tpu_torch.nnet.quantized import QuantizedTdnn, quantize_tdnn
    from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.recognize import Recognizer
    graph, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                            num_pdfs=64, seed=1))
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64, hidden_dim=64,
                     nonlinearity="relu")
    qtree = quantize_tdnn(random_tdnn_params(cfg, np.random.default_rng(0)))
    waves, _segs, _words = make_corpus(graph, 2, 200,
                                       np.random.default_rng(0), noise=0.25)
    opts = CsrBeamOpts(beam=13.0, max_active=512, acoustic_scale=0.1,
                       expand_budget=4096, eps_budget=1024)
    res = {dev: Recognizer(QuantizedTdnn(cfg).load_jax_qparams(qtree), graph,
                           opts, device=dev, compute_dtype=None
                           ).recognize(waves)
           for dev in ("cuda", "cpu")}
    if any(r is None for r in res["cuda"]):
        raise AssertionError("int8 decode: an utterance has no hypothesis")
    _same_results("int8 decode", res["cuda"], res["cpu"], "cuda")
    log(f"  int8 decode cuda == cpu (words, tids; cost within 1e-2): "
        f"{[len(r[0]) for r in res['cuda']]} words")


def phase_decoder_parity():
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    small, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                            num_pdfs=64, seed=1))
    base = dict(beam=9.0, max_active=256, acoustic_scale=0.1,
                expand_budget=4096, eps_budget=1024)
    cases = [("small fold_eps", small, 64, dict(base, fold_eps=True)),
             ("small eps rounds", small, 64, dict(base, fold_eps=False)),
             ("small hub tier", small, 64, dict(base, hub_threshold=64)),
             ("star hub G>128", star_hub_graph(300), 301,
              dict(base, max_active=128, hub_threshold=32))]
    rng = np.random.RandomState(0)
    for name, graph, P, kw in cases:
        B, T = 3, 40
        ll = (rng.randn(B, T, P) * 3).astype(np.float32)
        nf = np.array([40, 29, 17], np.int32)
        opts = CsrBeamOpts(**kw)
        dg = CsrBeamDecoder(graph, opts, device="cuda")
        dc = CsrBeamDecoder(graph, opts, device="cpu")
        rg, rc = dg.decode(ll, nf), dc.decode(ll, nf)
        for b in range(B):
            if (rg[b] is None) != (rc[b] is None):
                raise AssertionError(f"{name}: utt {b} hypothesis presence")
            if rg[b] is None:
                continue
            if rg[b][0] != rc[b][0] or rg[b][1] != rc[b][1] \
                    or abs(rg[b][2] - rc[b][2]) > 1e-2:
                raise AssertionError(f"{name}: utt {b} differs: cuda {rg[b]} "
                                     f"cpu {rc[b]}")
        for attr in ("last_overflow", "last_saturated", "last_active_sum",
                     "last_active_max"):
            if not np.array_equal(getattr(dg, attr), getattr(dc, attr)):
                raise AssertionError(f"{name}: {attr} differs")
        log(f"  {name}: cuda == cpu (words, tids, counters; cost within "
            f"1e-2), overflow {dg.last_overflow.tolist()}")


def phase_slice(tg, card: str, profile: bool = False) -> dict:
    import torch
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.decoder.simulate import make_corpus
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.recognize import Recognizer

    t0 = time.perf_counter()
    graph, _ = make_big_hclg(BigGraphConfig())
    cfg = TdnnConfig(feat_dim=40, num_pdfs=2048, hidden_dim=1024,
                     pnorm_output_dim=256, nonlinearity="relu")
    tdnn = Tdnn(cfg).load_jax_params(
        random_tdnn_params(cfg, np.random.default_rng(0)))
    waves, _segs, ref_words = make_corpus(graph, 8, 1000,
                                          np.random.default_rng(0),
                                          noise=0.25)
    t1 = time.perf_counter()
    rec = Recognizer(tdnn, graph, CsrBeamOpts(
        beam=13.0, max_active=7000, acoustic_scale=0.1,
        expand_budget=16384, eps_budget=2048), device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"  graph {graph.num_states} states / {graph.num_arcs} arcs, "
        f"{rec.decoder.graph.num_arcs} after eps folding; corpus 8 x 10 s; "
        f"both built in {t1 - t0:.3f} s on the host; "
        f"decoder set-up (fold, pack, upload): {t2 - t1:.3f} s; "
        f"tier-B layout {rec.decoder.tabs.b_apr} arcs/row, "
        f"{len(rec.decoder.tabs.hub_bounds) - 1} hub(s), hub one-hot "
        f"{rec.decoder.tabs.hub_onehot is not None}")

    ll = rec.loglikes(waves)
    torch.cuda.synchronize()
    B, T, P = ll.shape
    if (B, P) != (8, 2048) or not bool(torch.isfinite(ll).all()):
        raise AssertionError(f"loglikes {tuple(ll.shape)} not finite/shaped")

    tg.launches = 0                       # count the main path only
    answers, secs = [], []
    for _ in range(3):
        t = time.perf_counter()
        answers.append(rec.recognize(waves))
        secs.append(time.perf_counter() - t)
    launches = tg.launches
    if launches < 2 * T * 3:
        raise AssertionError(f"{launches} gather launches for 3 x {T} frames")
    if any(a != answers[0] for a in answers[1:]):
        raise AssertionError("repeated requests gave different answers")
    res = answers[0]
    if any(r is None for r in res):
        raise AssertionError("an utterance has no hypothesis")
    dec = rec.decoder
    audio = B * waves.shape[1] / 16000.0
    steady = float(np.median(secs[1:]))
    corpus_wer = wer([list(w) for w in ref_words], [r[0] for r in res])
    log(f"  slice: {audio / steady:.3f} audio-sec/s (median of requests 2-3), "
        f"per-request s {[round(s, 4) for s in secs]}, {T} frames x {B} "
        f"utts, gather launches {launches} ({launches / (3 * T):.1f}/frame), "
        f"overflow sum {int(dec.last_overflow.sum())}, active tokens mean "
        f"{dec.last_active_sum.sum() / (B * T):.1f} peak "
        f"{int(dec.last_active_max.max())}, saturated "
        f"{int(dec.last_saturated.sum())}/{B}, corpus WER "
        f"{corpus_wer:.2f}% (untrained random-weight AM: not a quality "
        f"number) | card: {card}")

    # one more request, split by layer (host clock around synchronize)
    t0 = time.perf_counter()
    ll = rec.loglikes(waves)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    finish = dec.decode_async(ll, np.full(B, T, np.int32))
    t2 = time.perf_counter()
    if finish() != res:
        raise AssertionError("layer-split request gave a different answer")
    t3 = time.perf_counter()
    log(f"  layers: fbank+CMVN+TDNN {t1 - t0:.4f} s; decoder host loop "
        f"(enqueue {T} frames + traceback) {t2 - t1:.4f} s; device drain + "
        f"one copy + parse {t3 - t2:.4f} s")
    if profile:
        profile_decode(dec, ll, 200, (t2 - t1) / T)
    return {"launches": launches, "graph": graph, "waves": waves,
            "ref_words": ref_words, "decoder": dec, "cfg": cfg, "rec": rec}


def phase_int8_slice(q, tg, sl: dict, card: str) -> dict:
    import torch
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.nnet.quantized import QuantizedTdnn, quantize_tdnn
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.recognize import Recognizer

    cfg, waves = sl["cfg"], sl["waves"]
    qmodel = QuantizedTdnn(cfg).load_jax_qparams(
        quantize_tdnn(random_tdnn_params(cfg, np.random.default_rng(0))))
    rec = Recognizer(qmodel, sl["graph"], CsrBeamOpts(
        beam=13.0, max_active=7000, acoustic_scale=0.1,
        expand_budget=16384, eps_budget=2048), device="cuda",
        compute_dtype=None)
    ll = rec.loglikes(waves)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ll = rec.loglikes(waves)
    torch.cuda.synchronize()
    tdnn_s = time.perf_counter() - t
    B, T, P = ll.shape
    if (B, P) != (8, 2048) or not bool(torch.isfinite(ll).all()):
        raise AssertionError(f"int8 loglikes {tuple(ll.shape)} not "
                             f"finite/shaped")

    q.launches = tg.launches = 0          # count the int8 path only
    answers, secs = [], []
    for _ in range(3):
        t = time.perf_counter()
        answers.append(rec.recognize(waves))
        secs.append(time.perf_counter() - t)
    launches, g_launches = q.launches, tg.launches
    if launches != 6 * 3:
        raise AssertionError(f"{launches} qaffine launches in 3 requests, "
                             f"want 6 per request")
    if g_launches < 2 * T * 3:
        raise AssertionError(f"{g_launches} gather launches for 3 x {T} "
                             f"frames")
    if any(a != answers[0] for a in answers[1:]):
        raise AssertionError("repeated int8 requests gave different answers")
    res = answers[0]
    if any(r is None for r in res):
        raise AssertionError("an utterance has no hypothesis (int8)")
    dec = rec.decoder
    audio = B * waves.shape[1] / 16000.0
    steady = float(np.median(secs[1:]))
    corpus_wer = wer([list(w) for w in sl["ref_words"]], [r[0] for r in res])
    log(f"  int8 slice: {audio / steady:.3f} audio-sec/s (median of requests "
        f"2-3), per-request s {[round(s_, 4) for s_ in secs]}, fbank+CMVN+"
        f"int8 TDNN {tdnn_s:.4f} s, qaffine launches {launches} "
        f"({launches // 3}/request), gather launches {g_launches} "
        f"({g_launches / (3 * T):.1f}/frame), overflow sum "
        f"{int(dec.last_overflow.sum())}, active tokens mean "
        f"{dec.last_active_sum.sum() / (B * T):.1f} peak "
        f"{int(dec.last_active_max.max())}, corpus WER {corpus_wer:.2f}% "
        f"(untrained random-weight AM: not a quality number) | card: {card}")
    # the host loop sets both paths' request time and its speed drifts
    # within a call, so the two are compared in turns
    turns = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        r = sl["rec"] if name == "bf16" else rec
        t = time.perf_counter()
        r.recognize(waves)
        turns[name].append(time.perf_counter() - t)
    log(f"  in turns (bf16, int8, int8, bf16): request s bf16 "
        f"{[round(x, 4) for x in turns['bf16']]} int8 "
        f"{[round(x, 4) for x in turns['int8']]}")
    return {"launches": launches}


def _stream_all(srv, waves: list, sizes: list) -> tuple[list, list]:
    """Open one slot per wave, feed each `sizes[i]` samples per step until
    all is fed, flush, and read every stream's best path. -> (results,
    host seconds of each step, each ending in a device sync)."""
    slots = [srv.open() for _ in waves]
    pos = [0] * len(waves)
    step_s = []

    def step():
        t = time.perf_counter()
        srv.step()
        srv.sync()
        step_s.append(time.perf_counter() - t)

    while any(p < len(w) for p, w in zip(pos, waves)):
        for i, w in enumerate(waves):
            if pos[i] < len(w):
                srv.feed(slots[i], w[pos[i]: pos[i] + sizes[i]])
                pos[i] += sizes[i]
        step()
    for s in slots:
        srv.input_finished(s)
    while not all(srv.finished(s) for s in slots):
        step()
    out = [srv.best_path(s) for s in slots]
    for s in slots:
        srv.close(s)
    return out, step_s


def _offline(am, dec, waves: list, fb) -> list:
    """The offline decode of each wave on the decoder's device: fbank ->
    AmNnet.loglikes -> CsrBeamDecoder.decode, one batch if the waves are
    all of one length."""
    import torch
    from kaldi_tpu_torch.ops.features import fbank
    if len({len(w) for w in waves}) > 1:
        return [r for w in waves for r in _offline(am, dec, [w], fb)]
    feats = fbank(torch.as_tensor(np.stack(waves), device=dec.device), fb)
    ll = am.loglikes(feats)
    return dec.decode(ll, np.full(len(waves), feats.shape[1], np.int32))


def small_stream_setup() -> dict:
    """tests/test_fused_serving.py's fixture, with seeded weights and
    priors: 24-bin fbank, the 40-word HCLG, a relu TDNN of width 64 over
    16 pdfs."""
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
    from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
    from kaldi_tpu_torch.ops.features import FbankOpts
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts
    from kaldi_tpu_torch.params import random_tdnn_params
    graph, _ = make_big_hclg(BigGraphConfig(vocab=40, avg_bigram_succ=6,
                                            num_pdfs=16, seed=3))
    cfg = TdnnConfig(feat_dim=24, num_pdfs=16, hidden_dim=64,
                     pnorm_output_dim=32, nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    return dict(
        fb=FbankOpts(frame_opts=FrameOpts(dither=0.0),
                     mel_opts=MelOpts(num_bins=24)),
        graph=graph, cfg=cfg,
        params=random_tdnn_params(cfg, np.random.default_rng(0)),
        priors=np.random.default_rng(1).dirichlet(np.ones(16)),
        opts=CsrBeamOpts(beam=11.0, max_active=128, acoustic_scale=0.1,
                         expand_budget=2048, eps_budget=512,
                         hub_threshold=64))


def small_stream_server(su: dict, dev: str, **kw):
    """The small fixture's AmNnet, decoder and server on `dev`."""
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.online.serving import FusedStreamingServer
    am = AmNnet(Tdnn(su["cfg"]).load_jax_params(su["params"]),
                priors=su["priors"])
    dec = CsrBeamDecoder(su["graph"], su["opts"], device=dev)
    return am, dec, FusedStreamingServer(am, dec, su["fb"],
                                         chunk_samples=2560, t_max=256, **kw)


def phase_stream_small():
    su = small_stream_setup()
    fb = su["fb"]
    rng = np.random.default_rng(21)
    waves = [rng.standard_normal(L).astype(np.float32) * 4000
             for L in (9000, 17000, 30000, 12345)]
    res = {}
    for dev in ("cuda", "cpu"):
        am, dec, srv = small_stream_server(su, dev, n_streams=4)
        res[dev], _ = _stream_all(srv, waves, [2560, 1300, 5000, 2000])
        if dev == "cuda":
            offline = _offline(am, dec, waves, fb)
    if any(r is None for r in res["cuda"]):
        raise AssertionError("small streaming: a stream has no hypothesis")
    _same_results("small streaming", res["cuda"], res["cpu"], "cuda server")
    _same_results("small streaming", res["cuda"], offline, "cuda server")
    log(f"  4 streams, mixed lengths and feed sizes: card == CPU (words, "
        f"tids; cost within 1e-2) and card == offline decode on the card; "
        f"{[len(r[0]) for r in res['cuda']]} words")


def phase_stream_full(tg, sl: dict, card: str,
                      profile: bool = False) -> dict:
    import torch
    from kaldi_tpu_torch.decoder.simulate import make_corpus
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.online.serving import FusedStreamingServer
    from kaldi_tpu_torch.params import random_tdnn_params
    from kaldi_tpu_torch.recognize import SERVING_FBANK

    cfg, dec = sl["cfg"], sl["decoder"]
    n, chunk = 16, 2560
    am = AmNnet(Tdnn(cfg).load_jax_params(
        random_tdnn_params(cfg, np.random.default_rng(0))),
        priors=np.random.default_rng(2).dirichlet(np.ones(cfg.num_pdfs)))
    waves, _segs, ref_words = make_corpus(sl["graph"], n, 1000,
                                          np.random.default_rng(1),
                                          noise=0.25)
    srv = FusedStreamingServer(am, dec, SERVING_FBANK, n_streams=n,
                               chunk_samples=chunk, t_max=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tg.launches = 0                       # count the streaming path only
    t0 = time.perf_counter()
    res, step_s = _stream_all(srv, list(waves), [chunk] * n)
    wall = time.perf_counter() - t0
    launches = tg.launches
    frames = int(srv._decoded.max())
    if launches < 2 * frames:
        raise AssertionError(f"{launches} gather launches for {frames} "
                             f"lockstep frames")
    in_use = torch.cuda.memory_allocated() / 2**30
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = time.perf_counter()
    offline = _offline(am, dec, list(waves), SERVING_FBANK)
    off_s = time.perf_counter() - t
    if any(r is None for r in res):
        raise AssertionError("full-width streaming: a stream has no "
                             "hypothesis")
    _same_results("full-width streaming", res, offline, "server")
    ms = np.asarray(step_s) * 1e3
    p50, p95 = float(np.percentile(ms, 50)), float(np.percentile(ms, 95))
    n = len(res)
    audio = n * waves.shape[1] / 16000.0
    chunk_ms = 1e3 * chunk / 16000.0
    corpus_wer = wer([list(w) for w in ref_words], [r[0] for r in res])
    log(f"  streaming: {n} streams x {waves.shape[1] / 16000.0:.1f} s, "
        f"{len(step_s)} steps of {chunk_ms:.0f} ms chunks, {frames} frames; "
        f"step ms p50 {p50:.3f} p95 {p95:.3f} max {ms.max():.3f} "
        f"(p95 < {chunk_ms:.0f} ms: {p95 < chunk_ms}); {audio / wall:.3f} "
        f"audio-sec/s aggregate over {wall:.3f} s (feeding, steps and "
        f"best_path); gather launches {launches} "
        f"({launches / frames:.1f}/frame step); device memory in use "
        f"{in_use:.3f} GiB, peak {peak:.3f} GiB; all {n} streams == offline "
        f"decode on the card (words, tids; offline took {off_s:.3f} s); "
        f"corpus WER {corpus_wer:.2f}% (untrained random-weight AM: not a "
        f"quality number) | card: {card}")
    if profile:
        profile_stream(srv, list(waves), chunk, p50 / 1e3)
    return {"launches": launches}


def _same_records(name: str, got: dict, want: dict, f16: bool):
    """decode_raw results: the same keys, shapes and dtypes; ints and
    scores rebuilt from float16 identical, other floats within 1e-5."""
    if list(got) != list(want):
        raise AssertionError(f"{name}: record keys {list(got)}")
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {key} {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        exact = w.dtype.kind != "f" or (f16 and key in ("scores",
                                                       "init_scores"))
        if exact and not np.array_equal(g, w):
            raise AssertionError(f"{name}: {key} differs")
        if not exact and np.abs(g - w).max(initial=0) > 1e-5:
            raise AssertionError(f"{name}: {key} off by "
                                 f"{np.abs(g - w).max()}")


def lattice_form(lat) -> tuple:
    """A lattice without its node numbering: node and arc counts and the
    sorted (ilabel, olabel, graph cost, acoustic cost) of its arcs."""
    n, _src, il, ol, gc, ac, _dst = lat.to_arrays()
    return n, sorted(zip(np.asarray(il).tolist(), np.asarray(ol).tolist(),
                         np.asarray(gc).tolist(), np.asarray(ac).tolist()))


def phase_lattice_small():
    import torch
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import (AdaptiveCsrBeamDecoder,
                                                  ChunkedCsrBeamDecoder,
                                                  CsrBeamDecoder, CsrBeamOpts)
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.generate import (decode_to_lattices,
                                              raw_lattice_from_decode)
    from kaldi_tpu_torch.ops.features import fbank
    small, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                            num_pdfs=64, seed=1))
    base = dict(beam=10.0, max_active=256, acoustic_scale=0.1,
                expand_budget=8192, eps_budget=2048)
    rec = dict(base, rec_cap=128, rec_beam=6.0)
    cases = [("dense", small, 64, base),
             ("f16", small, 64, dict(rec, rec_f16=True)),
             ("flat", small, 64, dict(rec, rec_f16=True, rec_flat=True,
                                      rec_flat_cap=128)),
             ("init rounds", small, 64, dict(rec, fold_eps=False)),
             ("star hub G>128, flat", star_hub_graph(300), 301,
              dict(base, max_active=128, hub_threshold=32, rec_cap=96,
                   rec_beam=8.0, rec_f16=True, rec_flat=True,
                   rec_flat_cap=96))]
    rng = np.random.RandomState(1)
    for name, graph, P, kw in cases:
        ll = (rng.randn(2, 25, P) * 3).astype(np.float32)
        nf = np.array([25, 19], np.int32)
        opts = CsrBeamOpts(**kw)
        dg = CsrBeamDecoder(graph, opts, device="cuda")
        dc = CsrBeamDecoder(graph, opts, device="cpu")
        rg, rc = dg.decode_raw(ll, nf), dc.decode_raw(ll, nf)
        _same_records(name, rg, rc, bool(kw.get("rec_f16")))
        for attr in ("last_overflow", "last_saturated", "last_rec_trunc",
                     "last_active_sum", "last_active_max",
                     "last_flat_fallbacks"):
            if not np.array_equal(getattr(dg, attr), getattr(dc, attr)):
                raise AssertionError(f"{name}: {attr} differs")
        sizes = []
        for b in range(2):
            lats = {(d, native): raw_lattice_from_decode(
                        dec, r, nf, b, 6.0, use_native=native)
                    for d, dec, r in (("cuda", dg, rg), ("cpu", dc, rc))
                    for native in (True, False)}
            form = lattice_form(lats["cuda", True])
            best = lattice_best_path(lats["cuda", True])
            for key, lat in lats.items():
                if lattice_form(lat) != form:
                    raise AssertionError(f"{name}: utt {b} lattice {key} "
                                         f"differs from the card's native")
                if lattice_best_path(lat)[:2] != best[:2]:
                    raise AssertionError(f"{name}: utt {b} best path {key}")
            sizes.append((form[0], len(form[1])))
        log(f"  decode_raw {name}: card == CPU (states, counters, f16 bits; "
            f"f32 within 1e-5); lattices card native == card numpy == CPU "
            f"native == CPU numpy; (states, arcs) {sizes}"
            + (f", {rg['rec_wire_slots']} wire slots" if "rec_wire_slots"
               in rg else ""))

    ll = (rng.randn(3, 50, 64) * 3).astype(np.float32)
    nf = np.array([50, 41, 23], np.int32)
    opts = CsrBeamOpts(beam=9.0, max_active=128, acoustic_scale=0.1,
                       expand_budget=4096, eps_budget=1024, hub_threshold=64)
    ref = CsrBeamDecoder(small, opts, device="cuda")
    want = ref.decode(ll, nf)
    for tc in (7, 16, 50):
        ch = ChunkedCsrBeamDecoder(small, opts, chunk_frames=tc,
                                   device="cuda")
        _same_results(f"chunked {tc}", ch.decode(ll, nf), want, "chunked")
        for attr in ("last_overflow", "last_saturated", "last_active_sum",
                     "last_active_max"):
            if not np.array_equal(getattr(ch, attr), getattr(ref, attr)):
                raise AssertionError(f"chunked {tc}: {attr} differs")
    full = CsrBeamOpts(beam=8.0, max_active=512, acoustic_scale=0.1,
                       expand_budget=16384, eps_budget=2048)
    ll = (rng.randn(3, 40, 64) * 3).astype(np.float32)
    nf = np.full(3, 40, np.int32)
    ad = AdaptiveCsrBeamDecoder(small, full, small_max_active=64,
                                small_expand_budget=2048, device="cuda")
    _same_results("adaptive", ad.decode(ll, nf), ad.full.decode(ll, nf),
                  "adaptive")
    log(f"  chunked (7, 16, 50 frames) == one-shot on the card; adaptive == "
        f"full on the card, escalated {ad.last_escalated.tolist()}, small "
        f"chunks {ad.last_small_chunks}")

    su = small_stream_setup()
    am, dec, srv = small_stream_server(su, "cuda", n_streams=2,
                                       keep_loglikes=True)
    rng2 = np.random.default_rng(51)
    waves = [rng2.standard_normal(L).astype(np.float32) * 4000
             for L in (12000, 9000)]
    slots = []
    for w in waves:
        s = srv.open()
        srv.feed(s, w)
        srv.input_finished(s)
        slots.append(s)
    for s in slots:
        srv.drain(s)
    for i, (s, w) in enumerate(zip(slots, waves)):
        lat = srv.get_lattice(s, 6.0)
        feats = fbank(torch.as_tensor(w, device="cuda"), su["fb"])
        off = decode_to_lattices(dec, am.loglikes(feats[None]),
                                 np.array([feats.shape[0]], np.int32),
                                 6.0)[0]
        if lat is None or off is None:
            raise AssertionError(f"get_lattice stream {i}: no lattice")
        g_n, g_arcs = lattice_form(lat)
        o_n, o_arcs = lattice_form(off)
        gb, ob = lattice_best_path(lat), lattice_best_path(off)
        if (g_n != o_n or [a[:2] for a in g_arcs] != [a[:2] for a in o_arcs]
                or gb[:2] != ob[:2] or abs(gb[2] - ob[2]) > 1e-2):
            raise AssertionError(f"get_lattice stream {i} differs from the "
                                 f"offline lattice")
        log(f"  keep-loglikes server, stream {i}: get_lattice == offline "
            f"lattice on the card ({g_n} states, {len(g_arcs)} arcs, best "
            f"path {len(gb[0])} words, cost {gb[2]:.4f} vs {ob[2]:.4f})")


LATTICE_BEAM = 8.0
LATGEN_BATCHES = 3


def _sizes(lats) -> list:
    """(states, arcs) of each lattice, None where there is none."""
    return [None if x is None else (x.num_states, x.num_arcs) for x in lats]


# bench.py:60-63: the AM's training corpus and steps
TRAIN_UTTS, TEST_UTTS, TRAIN_STEPS, TIMED_TRAIN_STEPS = 16, 8, 400, 10
NG_STEPS = 20                  # two refreshes at update_period 10
SMALL_TDNN = dict(feat_dim=8, num_pdfs=12, hidden_dim=16, pnorm_output_dim=4,
                  nonlinearity="relu",
                  splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
# card vs CPU limits of the small training phase, relative to each leaf's
# max |p| and to the loss. f32 (TF32 off): cuBLAS and the CPU sum the same
# products in another order, as the port and JAX do on the CPU, so the
# bar PARITY.md pins for the train step. bf16: a sum that lands on the
# other side of a bf16 rounding boundary moves that element by 2^-8, and
# a weight that rounds differently moves its products (measured against
# JAX on the CPU after 6 steps: leaves 5.9e-3, loss 3.5e-4). NG-SGD and
# Adam: eigh (cuSOLVER against LAPACK) and Adam's division by sqrt(nu)
# each add f32 rounding on top of f32's.
TRAIN_LIMITS = {"f32": (1e-5, 1e-5), "bf16": (2e-2, 1e-3),
                "ng_sgd": (1e-4, 1e-5), "progressive": (1e-4, 1e-5)}


def _small_train_case(seed: int, nonlinearity: str = "relu"):
    """tests/test_torch_train.py's shapes: a 3-layer TDNN of width 16 over
    12 pdfs, a batch of 3 x 10 frames with uneven frame weights."""
    from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
    from kaldi_tpu_torch.params import random_tdnn_params
    cfg = TdnnConfig(**dict(SMALL_TDNN, nonlinearity=nonlinearity))
    rng = np.random.default_rng(seed)
    tree = random_tdnn_params(cfg, rng)
    batch = (rng.standard_normal((3, 17, 8)).astype(np.float32),
             rng.integers(0, 12, (3, 10)).astype(np.int32),
             rng.uniform(0.5, 1.5, (3, 10)).astype(np.float32))
    return cfg, tree, batch


def _train_small_on(dev: str, cfg, tree, batch, opt, steps: int,
                    compute_dtype=None) -> tuple[dict, list]:
    """`steps` train steps on `dev` from the numpy tree. -> (params on the
    CPU, losses)."""
    import torch
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.nnet.train import make_train_step
    from kaldi_tpu_torch.params import tdnn_params_from_jax
    params = {k: v.to(dev) for k, v in tdnn_params_from_jax(tree).items()}
    state = opt.init(params)
    step = make_train_step(Tdnn(cfg), opt, compute_dtype=compute_dtype)
    b = [torch.as_tensor(a, device=dev) for a in batch]
    losses = []
    for _ in range(steps):
        params, state, loss, _acc = step(params, state, *b)
        losses.append(float(loss))
    if params["final.w"].device.type != torch.device(dev).type:
        raise AssertionError(f"train step left {dev}")
    return {k: v.cpu() for k, v in params.items()}, losses


def _train_errors(name: str, got: tuple, want: tuple) -> tuple[float, float]:
    """Card against CPU: the worst leaf error over the leaf's max |p| and
    the worst loss error over |loss|, held to TRAIN_LIMITS[name]."""
    (gp, gl), (wp, wl) = got, want
    leaf = max(float((gp[k] - wp[k]).abs().max()) /
               max(float(wp[k].abs().max()), 1e-30) for k in wp)
    loss = max(abs(a - b) / abs(b) for a, b in zip(gl, wl))
    lim_leaf, lim_loss = TRAIN_LIMITS[name]
    if not (leaf <= lim_leaf and loss <= lim_loss):
        raise AssertionError(f"{name} training, card vs CPU: leaves "
                             f"{leaf:.3e} (limit {lim_leaf}), loss "
                             f"{loss:.3e} (limit {lim_loss})")
    return leaf, loss


def phase_train_small():
    """The train step, NG-SGD, progressive training and a checkpoint on
    the card against the same on the CPU, at the CPU tests' shapes."""
    import tempfile
    import torch
    from kaldi_tpu_torch.nnet.natural_gradient import ng_sgd
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                            train_progressive)
    from kaldi_tpu_torch.params import tdnn_params_from_jax
    from kaldi_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.2, final_lr=0.05,
                                       max_grad_norm=0.5, l2_regularize=1e-2,
                                       momentum=0.9), 8)
    cases = [("f32", "clip 0.5, l2 1e-2, momentum 0.9", opt, 8, None, 3),
             ("bf16", "the same in bf16", opt, 8, torch.bfloat16, 4),
             ("ng_sgd", "NG-SGD, momentum 0.9, refresh at step 10",
              ng_sgd(0.05, alpha=0.5, update_period=10, momentum=0.9), 12,
              None, 1)]
    for name, what, o, steps, dt, seed in cases:
        cfg, tree, batch = _small_train_case(seed)
        runs = [_train_small_on(d, cfg, tree, batch, o, steps, dt)
                for d in ("cuda", "cpu")]
        leaf, loss = _train_errors(name, *runs)
        log(f"  {name}: {steps} steps ({what}), card vs CPU: leaves within "
            f"{leaf:.3e} of their max |p|, losses within {loss:.3e} (limits "
            f"{TRAIN_LIMITS[name]})")
    cfg, tree, (x, t, w) = _small_train_case(5, "pnorm")
    tree["final"]["w"][:] = 0.0
    prog = {d: train_progressive(Tdnn(cfg), tdnn_params_from_jax(tree), x, t,
                                 w, steps_per_stage=4, final_steps=6, device=d)
            for d in ("cuda", "cpu")}
    (gp, gh), (wp, wh) = prog["cuda"], prog["cpu"]
    if [h[0] for h in gh] != [1, 2, 3]:
        raise AssertionError(f"progressive stages {gh}")
    leaf, loss = _train_errors(
        "progressive", ({k: v.cpu() for k, v in gp.items()}, [h[1] for h in gh]),
        (wp, [h[1] for h in wh]))
    log(f"  train_progressive, 3 p-norm stages (Adam, 4/4/6 steps), card vs "
        f"CPU: leaves within {leaf:.3e}, stage losses within {loss:.3e}")
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 12, gp, extra={"loss": gh[-1][1]})
        step, back, extra = load_checkpoint(d, like=gp)
        if step != 12 or extra["loss"] != gh[-1][1] or any(
                back[k].device != gp[k].device or not torch.equal(back[k], gp[k])
                for k in gp):
            raise AssertionError("checkpoint of card tensors did not read back")
    log(f"  checkpoint of card params written and read back equal, on the "
        f"card ({len(gp)} leaves)")


def train_flops_per_step(cfg, frames: int) -> float:
    """The bench's count (bench.py:213-216): 6 FLOPs (forward 2, backward
    4) per GEMM weight per output frame."""
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    w = sum(p.numel() for n, p in Tdnn(cfg).named_parameters()
            if n.endswith(".w"))
    return 6.0 * w * frames


def _event_ms(fn, n: int) -> float:
    """Device time of n calls between two CUDA events, per call."""
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def phase_train_full(sl: dict, card: str, profile: bool = False) -> dict:
    """The bench's AM training on the card with the port's train step:
    the bench's corpus (16 x 10 s, full batch), bf16 products, SGD from
    0.1 to 0.02 over 400 steps with gradients clipped at a global norm of
    5 (bench.py:173-217); then 10 timed steps, 20 NG-SGD steps and one
    f32 step at the same width. -> the corpus and the trained Tdnn."""
    import torch
    from kaldi_tpu_torch.decoder.simulate import fbank_targets, make_corpus
    from kaldi_tpu_torch.nnet.natural_gradient import ng_sgd
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                            make_train_step)
    from kaldi_tpu_torch.ops.features import cmvn, fbank
    from kaldi_tpu_torch.params import random_tdnn_params, tdnn_params_from_jax
    from kaldi_tpu_torch.recognize import SERVING_FBANK

    cfg, graph = sl["cfg"], sl["graph"]
    t = time.perf_counter()
    waves_all, segs, ref_all = make_corpus(graph, TRAIN_UTTS + TEST_UTTS,
                                           1000, np.random.default_rng(0),
                                           noise=0.25)
    t_corpus = time.perf_counter() - t
    with torch.no_grad():
        feats = cmvn(fbank(torch.as_tensor(waves_all[:TRAIN_UTTS],
                                           device="cuda"), SERVING_FBANK))
    Tf = feats.shape[1]
    tgt = np.stack([fbank_targets(s, Tf) for s in segs[:TRAIN_UTTS]])
    tgt = torch.as_tensor(tgt[:, cfg.left_context:Tf - cfg.right_context],
                          device="cuda")
    w = torch.ones(tgt.shape, device="cuda")
    tdnn = Tdnn(cfg, device="cuda")
    init = {k: v.cuda() for k, v in tdnn_params_from_jax(
        random_tdnn_params(cfg, np.random.default_rng(0))).items()}
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.1, final_lr=0.02,
                                       max_grad_norm=5.0), TRAIN_STEPS)
    step = make_train_step(tdnn, opt, compute_dtype=torch.bfloat16)
    params, state = init, opt.init(init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, state, loss, acc = step(params, state, feats, tgt, w)
    loss, acc = float(loss), float(acc)
    t_train = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (np.isfinite(loss) and acc > 0.5):
        raise AssertionError(f"training did not converge: loss {loss}, "
                             f"frame accuracy {acc}")
    run = {"p": params, "s": state}

    def one():
        run["p"], run["s"], run["loss"], _ = step(run["p"], run["s"], feats,
                                                  tgt, w)
    ms = _event_ms(one, TIMED_TRAIN_STEPS)
    frames = tgt.numel()
    flops = train_flops_per_step(cfg, frames)
    tflops = flops / ms / 1e9
    bound_ms = flops / BF16_FLOP_PER_S * 1e3
    log(f"  AM trained on {TRAIN_UTTS} x 10 s ({frames} output frames per "
        f"step) in {TRAIN_STEPS} steps: {t_train:.3f} s on the host clock "
        f"({1e3 * t_train / TRAIN_STEPS:.3f} ms/step); loss {loss:.4f}, frame "
        f"accuracy {acc:.4f}; peak device memory {peak:.3f} GiB (corpus "
        f"{t_corpus:.3f} s on the host) | card: {card}")
    log(f"  train step (bf16, clip + SGD), {TIMED_TRAIN_STEPS} steps between "
        f"CUDA events: {ms:.4f} ms/step, {frames / ms * 1e3:.1f} frames/s, "
        f"{tflops:.2f} TFLOP/s by the bench's count (6 x {flops / 6 / frames:.0f}"
        f" GEMM weights x frames = {flops:.4e} FLOP/step), train_mfu "
        f"{tflops * 1e12 / BF16_FLOP_PER_S:.4f} of {BF16_FLOP_PER_S / 1e12:.0f}"
        f" TFLOP/s (bound {bound_ms:.4f} ms/step) | card: {card}")
    if profile:
        busy, n_ops, by_name = device_time(lambda: [one() for _ in range(3)])
        log_profile("3 bf16 train steps", "step", 3, busy, n_ops, by_name,
                    ms / 1e3, 20)
        log_by_kind(by_name, 3, "step")
    tdnn.load_state_dict(run["p"])

    ng = ng_sgd(0.02, update_period=10)
    nrun = {"p": init, "s": ng.init(init)}
    ng_step = make_train_step(tdnn, ng, compute_dtype=torch.bfloat16)
    per = []
    for _ in range(NG_STEPS):
        per.append(_event_ms(lambda: nrun.update(zip(
            ("p", "s", "loss", "acc"),
            ng_step(nrun["p"], nrun["s"], feats, tgt, w))), 1))
    if not np.isfinite(float(nrun["loss"])):
        raise AssertionError("NG-SGD loss is not finite")
    refresh = [per[i - 1] for i in range(10, NG_STEPS + 1, 10)]
    plain = [x for i, x in enumerate(per, 1) if i % 10]
    log(f"  NG-SGD (bf16, update_period 10, {len(nrun['s'][0].factors)} "
        f"factored weights), {NG_STEPS} steps: {float(np.mean(per)):.4f} "
        f"ms/step mean; steps without a refresh median "
        f"{float(np.median(plain)):.4f} ms; refresh steps (eigh of every "
        f"factor, up to 2048 x 2048) {[round(x, 4) for x in refresh]} ms; "
        f"loss after {NG_STEPS} steps {float(nrun['loss']):.4f} | card: {card}")
    f32_step = make_train_step(tdnn, opt)
    frun = {"p": init, "s": opt.init(init)}
    f32_ms = [_event_ms(lambda: frun.update(zip(
        ("p", "s", "loss", "acc"),
        f32_step(frun["p"], frun["s"], feats, tgt, w))), 1) for _ in range(2)]
    log(f"  one f32 train step (TF32 off): {f32_ms[1]:.4f} ms (first call "
        f"{f32_ms[0]:.4f} ms), {flops / f32_ms[1] / 1e9:.2f} TFLOP/s; the "
        f"FP32 bound {flops / FP32_FLOP_PER_S * 1e3:.4f} ms | card: {card}")
    return {"tdnn": tdnn, "waves": waves_all, "segs": segs, "ref": ref_all,
            "loss": loss, "acc": acc, "t_train": t_train, "ms": ms}


def phase_lattice_full(tg, sl: dict, tr: dict, card: str) -> dict:
    import copy
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from kaldi_tpu_torch.decoder.csr_beam import (AdaptiveCsrBeamDecoder,
                                                  CsrBeamDecoder, CsrBeamOpts)
    from kaldi_tpu_torch.lat import native_gen
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.generate import (decode_to_lattices,
                                              decode_to_lattices_stream,
                                              raw_lattice_from_decode)
    from kaldi_tpu_torch.recognize import Recognizer

    # the bench's 8 test utterances, decoded with the AM that the train
    # phase trained on its 16 training utterances
    graph, tdnn = sl["graph"], tr["tdnn"]
    search = dict(beam=13.0, max_active=7000, acoustic_scale=0.1,
                  expand_budget=16384, eps_budget=2048)
    rec = Recognizer(tdnn, graph, CsrBeamOpts(**search), device="cuda")
    waves = tr["waves"][TRAIN_UTTS:]
    answers = rec.recognize(waves)
    if any(a is None for a in answers):
        raise AssertionError("trained AM: an utterance has no best path")
    log(f"  trained AM (loss {tr['loss']:.4f}, frame accuracy "
        f"{tr['acc']:.4f}): best-path WER on the {TEST_UTTS} test "
        f"utterances {wer(tr['ref'][TRAIN_UTTS:], [a[0] for a in answers]):.2f}%")
    # the bench's latgen point (bench.py:415-425)
    t = time.perf_counter()
    dec = CsrBeamDecoder(graph, CsrBeamOpts(
        **search, rec_cap=3072, rec_beam=LATTICE_BEAM, rec_f16=True,
        rec_flat=True, rec_flat_cap=512), device="cuda")
    setup_s = time.perf_counter() - t
    ll_np = rec.loglikes(waves).float().cpu().numpy()   # bf16 TDNN's
    B, T, P = ll_np.shape
    nf = np.full(B, T, np.int32)
    audio = B * waves.shape[1] / 16000.0
    o = dec.opts
    R, Kc = 1 + int(o.eps_expansions), min(o.rec_cap, o.max_active)

    native_gen.extractions = 0
    t = time.perf_counter()
    list(decode_to_lattices_stream(dec, [(ll_np, nf)], LATTICE_BEAM,
                                   num_threads=8))
    warm_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tg.launches = 0                       # count the latgen path only
    rates, fallbacks0 = [], dec.last_flat_fallbacks
    for _ in range(2):
        t = time.perf_counter()
        outs = list(decode_to_lattices_stream(
            dec, [(ll_np, nf)] * LATGEN_BATCHES, LATTICE_BEAM,
            num_threads=8))
        rates.append(LATGEN_BATCHES * audio / (time.perf_counter() - t))
    launches = tg.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches < 2 * T * LATGEN_BATCHES * 2:
        raise AssertionError(f"{launches} gather launches for "
                             f"{2 * LATGEN_BATCHES} batches of {T} frames")
    lats = outs[-1]
    if len(outs) != LATGEN_BATCHES:
        raise AssertionError(f"latgen: {len(outs)} batches came out")
    # one more batch, split by stage (host clock)
    t0 = time.perf_counter()
    fin = dec.decode_raw_async(ll_np, nf)
    t1 = time.perf_counter()
    raw = fin()
    t2 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as ex:
        lats1 = list(ex.map(lambda b: raw_lattice_from_decode(
            dec, raw, nf, b, LATTICE_BEAM), range(B)))
    t3 = time.perf_counter()
    if _sizes(lats1) != _sizes(lats):
        raise AssertionError("latgen: the split batch's lattices differ from "
                             "the stream's")
    shipped = B * T * R * Kc
    trunc = int(dec.last_rec_trunc.sum())
    wire = raw.get("rec_wire_slots", float("nan"))
    share = 100.0 * trunc / shipped
    log(f"  latgen: {[round(r, 3) for r in rates]} audio-sec/s per run of "
        f"{LATGEN_BATCHES} batches x {B} x {waves.shape[1] / 16000.0:.1f} s "
        f"(decode_to_lattices_stream, 8 extraction threads; warm-up batch "
        f"{warm_s:.3f} s, decoder set-up {setup_s:.3f} s); gather launches "
        f"{launches} ({launches / (2 * LATGEN_BATCHES * T):.1f}/frame); "
        f"peak device memory {peak:.3f} GiB | card: {card}")
    log(f"  one batch: record decode enqueue {t1 - t0:.4f} s, device drain + "
        f"one copy + dense rebuild {t2 - t1:.4f} s, native extraction of "
        f"{B} utts on 8 threads {t3 - t2:.4f} s")
    log(f"  records: rec_trunc {trunc} of {shipped} shipped slots = "
        f"{share:.3f}% (bench.py:445 fails at 5%); rec_wire_slots "
        f"{wire} ({wire / (B * T * R):.1f}/frame; nan after a dense "
        f"fallback); flat fallbacks {dec.last_flat_fallbacks - fallbacks0} in "
        f"the timed runs, {dec.last_flat_fallbacks} in all; dense view width "
        f"{raw['states'].shape[-1]}; active tokens mean "
        f"{dec.last_active_sum.sum() / (B * T):.1f} peak "
        f"{int(dec.last_active_max.max())}; (lattice states, arcs) per utt "
        f"{_sizes(lats)} (None: no path survived the records)")
    failed = []
    if not share < 5.0:
        failed.append(f"record compaction truncated {share:.3f}% of shipped "
                      f"slots (rec_cap={Kc})")

    # untruncated records (bench.py:494-498), the same search: their
    # occupancy within rec_beam is what rec_cap cuts, so the capped run's
    # rec_trunc must be exactly its excess over Kc
    unc = copy.copy(dec)              # shares the tier tables
    unc.opts = dataclasses.replace(dec.opts, rec_cap=None,
                                   rec_flat_cap=1024)
    t = time.perf_counter()
    raw_u = unc.decode_raw(ll_np, nf)
    with ThreadPoolExecutor(max_workers=8) as ex:
        lats_u = list(ex.map(lambda b: raw_lattice_from_decode(
            unc, raw_u, nf, b, LATTICE_BEAM), range(B)))
    t_u = time.perf_counter() - t
    occ = np.sum(raw_u["scores"] < 5e9, axis=-1)          # [B, T, R]
    if not np.array_equal(np.maximum(occ - Kc, 0).sum(axis=(1, 2)),
                          dec.last_rec_trunc):
        failed.append("rec_trunc is not the untruncated records' excess "
                      "over rec_cap")
    # rec_beam may drop slots of the best path (ROADMAP §5): count the
    # lattices that still hold the decoder's best cost
    held = sum(lat is not None and abs(lattice_best_path(lat)[2] - want[2])
               <= 1e-3 * abs(want[2]) for lat, want in zip(lats_u, answers))
    log(f"  untruncated batch (rec_cap None, rec_flat_cap 1024): {t_u:.3f} "
        f"s, rec_trunc {int(unc.last_rec_trunc.sum())}, flat fallbacks "
        f"{unc.last_flat_fallbacks - dec.last_flat_fallbacks}; slots within "
        f"rec_beam per frame: mean {occ.mean():.1f}, p50 "
        f"{np.percentile(occ, 50):.0f}, p99 {np.percentile(occ, 99):.0f}, "
        f"max {occ.max()}, over rec_cap in {np.mean(occ > Kc):.4f} of frames, "
        f"their excess == rec_trunc exactly; lattices holding the "
        f"Recognizer's best cost {held}/{B}; (states, arcs) "
        f"{_sizes(lats_u)}")

    # records with nothing masked (rec_beam = beam, dense): every lattice's
    # best path is the decoder's, held against the bf16 Recognizer's words
    whole = copy.copy(dec)
    whole.opts = dataclasses.replace(dec.opts, rec_cap=None, rec_beam=None,
                                     rec_flat=False)
    t = time.perf_counter()
    lats_w = decode_to_lattices(whole, ll_np, nf, LATTICE_BEAM,
                                num_threads=8)
    t_w = time.perf_counter() - t
    ties = 0
    for b, (lat, want) in enumerate(zip(lats_w, answers)):
        if lat is None:
            failed.append(f"unmasked records, utt {b}: no lattice")
            continue
        got = lattice_best_path(lat)
        rel = abs(got[2] - want[2]) / max(abs(want[2]), 1e-9)
        if got[0] != want[0]:
            ties += 1
            log(f"  utt {b}: lattice best path differs from the Recognizer's "
                f"words: cost {got[2]:.6f} vs {want[2]:.6f} (rel {rel:.2e})")
        if rel > 1e-3:
            failed.append(f"unmasked records, utt {b}: lattice best cost "
                          f"{got[2]} vs the Recognizer's {want[2]}")
    log(f"  unmasked batch (rec_cap None, rec_beam = beam 13, dense): "
        f"{t_w:.3f} s; best paths of {B} lattices == the bf16 Recognizer's "
        f"words for {B - ties}/{B}, the rest ties within 1e-3; (states, "
        f"arcs) {_sizes(lats_w)}")

    # adaptive decode: a chunked small-frontier program, then escalation
    t = time.perf_counter()
    ad = AdaptiveCsrBeamDecoder(graph, CsrBeamOpts(**search),
                                small_max_active=1024, device="cuda")
    ad_setup = time.perf_counter() - t
    ll_dev = torch.as_tensor(ll_np, device="cuda")
    tg.launches = 0
    t = time.perf_counter()
    res_a = ad.decode(ll_dev, nf)
    t_a = time.perf_counter() - t
    a_launches = tg.launches
    t = time.perf_counter()
    res_f = ad.full.decode(ll_dev, nf)
    t_f = time.perf_counter() - t
    _same_results("adaptive full width", res_a, res_f, "adaptive")
    log(f"  adaptive (small_max_active 1024, 128-frame chunks): "
        f"{t_a:.4f} s against one full decode {t_f:.4f} s; escalated "
        f"{int(ad.last_escalated.sum())}/{B}, small chunks "
        f"{ad.last_small_chunks} of {-(-T // 128)}, gather launches "
        f"{a_launches}; set-up {ad_setup:.3f} s; words == full decode")
    if native_gen.extractions < B * (2 * LATGEN_BATCHES + 4):
        failed.append(f"native extractor ran {native_gen.extractions} times")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"launches": launches, "adaptive_launches": a_launches}


# --------------------------------------------- the single-stream online path

ONLINE_FB = dict(samp_freq=16000.0, dither=0.0)


def _online_fused_stream(fused, wave, chunk: int):
    fused.reset()
    for pos in range(0, len(wave), chunk):
        fused.accept_waveform(wave[pos:pos + chunk])
    fused.input_finished()
    return fused.best_path()


def _online_generic(am, dec, fb, wave, chunk: int, ivec=None, tm=None):
    """SingleUtteranceNnet2Decoder over OnlineMfcc(fbank) (+ i-vectors) on
    the decoder's device, fed `chunk` samples at a time."""
    from kaldi_tpu_torch.online.features import OnlineMfcc
    from kaldi_tpu_torch.online.nnet2_decoding import (
        OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
    from kaldi_tpu_torch.ops.features import fbank
    pipe = OnlineNnet2FeaturePipeline(
        OnlineMfcc(fb, computer=fbank, device=dec.device), ivec)
    d = SingleUtteranceNnet2Decoder(am, tm or _TmShim, dec, pipe,
                                    chunk_frames=16, silence_phones={0})
    for pos in range(0, len(wave), chunk):
        d.pipeline.accept_waveform(wave[pos:pos + chunk])
        d.advance_decoding()
    d.finalize_decoding()
    return d.best_path()


class _TmShim:
    """scripts/bench_streaming.py:97-104: the online decoder needs only a
    phone per transition id for its trailing-silence checks."""

    @staticmethod
    def transition_id_to_phone(tid):
        return 0


class _TmMod3:
    """Phone = tid % 3, phone 0 silence: the i-vector's silence weighting
    then reweights some frames."""

    @staticmethod
    def transition_id_to_phone(tid):
        return int(tid) % 3


def phase_online_small():
    """Card vs CPU on small shapes: mfcc, plp and deltas; the padded
    BeamSearchDecoder; both FusedOnlineDecoder engines (and each stream vs
    the offline decode on the card); SingleUtteranceNnet2Decoder with
    i-vectors; the mixed-up AM's group sum (two card runs bit-equal, the
    card within 1e-6 relative of the CPU)."""
    import torch
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.combine import sum_group_log_posteriors
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
    from kaldi_tpu_torch.online.ivector import (OnlineIvectorConfig,
                                                OnlineIvectorFeature)
    from kaldi_tpu_torch.ops.delta import add_deltas
    from kaldi_tpu_torch.ops.features import (MfccOpts, PlpOpts, fbank, mfcc,
                                              plp)
    from kaldi_tpu_torch.ops.window import FrameOpts
    from kaldi_tpu_torch.params import random_tdnn_params

    rng = np.random.default_rng(31)
    wave = torch.from_numpy(rng.standard_normal((2, 16000))
                            .astype(np.float32) * 1000)
    fo = FrameOpts(**ONLINE_FB)
    worst = 0.0
    for fn, opts in ((mfcc, MfccOpts(frame_opts=fo)),
                     (plp, PlpOpts(frame_opts=fo))):
        got, want = fn(wave.cuda(), opts), fn(wave, opts)
        for g, w in ((got, want), (add_deltas(got), add_deltas(want))):
            g = g.cpu()
            if not torch.allclose(g, w, rtol=2e-4, atol=2e-3):
                raise AssertionError(f"{fn.__name__}: card != CPU, max "
                                     f"{float((g - w).abs().max())}")
            worst = max(worst, float((g - w).abs().max()))
    log(f"  mfcc, plp and their deltas: card == CPU within rtol 2e-4 / "
        f"atol 2e-3 (max |diff| {worst:.3e})")

    su = small_stream_setup()
    fb = su["fb"]
    am = AmNnet(Tdnn(su["cfg"]).load_jax_params(su["params"]),
                priors=su["priors"])
    ll = (np.random.RandomState(3).randn(2, 40, 16) * 3).astype(np.float32)
    nf = np.array([40, 27], np.int32)
    bopts = BeamSearchOpts(beam=11.0, max_active=128, acoustic_scale=0.1)
    bd = {dev: BeamSearchDecoder(su["graph"], bopts, device=dev)
          for dev in ("cuda", "cpu")}
    _same_results("padded decode", bd["cuda"].decode(ll, nf),
                  bd["cpu"].decode(ll, nf), "cuda")
    rg, rc = bd["cuda"].decode_raw(ll, nf), bd["cpu"].decode_raw(ll, nf)
    for key in rc:
        if rc[key].dtype.kind != "f" and not np.array_equal(rg[key], rc[key]):
            raise AssertionError(f"padded decode_raw: {key} differs")
    log(f"  BeamSearchDecoder (padded, E = {bd['cuda'].E}): decode and "
        f"decode_raw's states equal on the card and the CPU")

    waves = [rng.standard_normal(n).astype(np.float32) * 4000
             for n in (9000, 23456, 17000)]
    for engine in ("padded", "csr"):
        res = {}
        for dev in ("cuda", "cpu"):
            dec = (BeamSearchDecoder(su["graph"], bopts, device=dev)
                   if engine == "padded"
                   else CsrBeamDecoder(su["graph"], su["opts"], device=dev))
            fused = FusedOnlineDecoder(am, dec, fb, t_max=256)
            res[dev] = [_online_fused_stream(fused, w, c)
                        for w, c in zip(waves, (2560, 1000, 7000))]
            if dev == "cuda":
                offline = _offline(am, dec, waves, fb)
        if any(r is None for r in res["cuda"]):
            raise AssertionError(f"fused {engine}: a stream has no "
                                 f"hypothesis")
        _same_results(f"fused {engine}", res["cuda"], res["cpu"], "cuda")
        _same_results(f"fused {engine}", res["cuda"], offline, "streamed")
        log(f"  FusedOnlineDecoder ({engine}), 3 streams fed 2560/1000/7000 "
            f"samples per call: card == CPU == offline decode on the card "
            f"(words, tids; cost within 1e-2); "
            f"{[len(r[0]) for r in res['cuda']]} words")

    ubm_frames = fbank(torch.from_numpy(waves[1]), fb).numpy()
    pick = np.random.default_rng(1).choice(len(ubm_frames), 4, replace=False)
    ubm = DiagGmm(np.full(4, 0.25), ubm_frames[pick],
                  np.tile(ubm_frames.var(axis=0) + 0.5, (4, 1)))
    ext = IvectorExtractor(ubm, 4, seed=1)
    ext.M *= 5.0
    icfg = dataclasses.replace(su["cfg"], feat_dim=28)
    iam_params = random_tdnn_params(icfg, np.random.default_rng(5))
    res = {}
    for dev in ("cuda", "cpu"):
        iam = AmNnet(Tdnn(icfg).load_jax_params(iam_params),
                     priors=su["priors"])
        dec = BeamSearchDecoder(su["graph"], bopts, device=dev)
        res[dev] = [_online_generic(
            iam, dec, fb, w, 1600, tm=_TmMod3,
            ivec=OnlineIvectorFeature(ext, OnlineIvectorConfig(
                num_gselect=3, silence_weight=0.1))) for w in waves[:2]]
    _same_results("nnet2 + i-vectors", res["cuda"], res["cpu"], "cuda")
    log(f"  SingleUtteranceNnet2Decoder with 4-dim online i-vectors, 2 "
        f"streams: card == CPU; {[len(r[0]) for r in res['cuda']]} words")

    gid = np.random.default_rng(4).permutation(np.repeat(np.arange(64), 3))
    mcfg = TdnnConfig(feat_dim=40, num_pdfs=192, hidden_dim=256,
                      nonlinearity="relu",
                      splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    mam = AmNnet(Tdnn(mcfg, device="cuda").load_jax_params(
        random_tdnn_params(mcfg, np.random.default_rng(3))), group_ids=gid)
    x = torch.from_numpy(rng.standard_normal((4, 300, 40))
                         .astype(np.float32)).cuda()
    a, b = mam.loglikes(x), mam.loglikes(x)
    if not torch.equal(a, b):
        raise AssertionError("mixed-up AM: two card runs differ")
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal(
        (4, 300, 192)).astype(np.float32)), dim=-1)
    got = sum_group_log_posteriors(lp.cuda(), gid, 64).cpu()
    want = sum_group_log_posteriors(lp, gid, 64)
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    if rel > 1e-6:
        raise AssertionError(f"group sum: card vs CPU {rel:.3e} relative")
    log(f"  mixed-up AM (192 rows -> 64 pdfs): two card runs bit-equal; "
        f"group sum card vs CPU {rel:.3e} relative (limit 1e-6)")


def _pcts(ms: list) -> tuple:
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 95))


def profile_online(what: str, wave, chunk: int, host_s_per_chunk: float,
                   feed):
    """Ten steady chunks of one stream (past its first four) under
    torch.profiler; `feed` takes a piece of the waveform."""
    feed(wave[:4 * chunk])
    n = 10
    busy, n_ops, by_name = device_time(
        lambda: [feed(wave[(4 + i) * chunk:(5 + i) * chunk])
                 for i in range(n)])
    log_profile(f"{what}, {n} chunks of one stream", "chunk", n, busy, n_ops,
                by_name, host_s_per_chunk, 12)


def phase_online_full(tg, card: str, profile: bool = False) -> dict:
    """scripts/bench_streaming.py's configuration on the card: 16 kHz,
    40-bin fbank, the 300-word HCLG, 18 x 6 s utterances, the relu TDNN of
    width 512 over 64 pdfs trained 300 bf16 steps with the port's train
    step, priors from alignment counts; the fused path (FusedOnlineDecoder
    on the CSR engine, keep_loglikes) over the 6 test utterances and the
    generic path (SingleUtteranceNnet2Decoder over OnlineMfcc(fbank), the
    padded decoder) over 3, each fed 160 ms per call, after a warm-up
    pass over one utterance; every hypothesis must equal the offline
    decode on the card and every lattice exist."""
    import torch
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.decoder.simulate import fbank_targets, make_corpus
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                            make_train_step)
    from kaldi_tpu_torch.online.features import OnlineMfcc
    from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
    from kaldi_tpu_torch.online.nnet2_decoding import (
        OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
    from kaldi_tpu_torch.online.timing import OnlineTimer, OnlineTimingStats
    from kaldi_tpu_torch.ops.features import FbankOpts, fbank
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts

    SR, chunk = 16000.0, 2560
    n_train, n_test, T = 12, 6, 600
    fb = FbankOpts(frame_opts=FrameOpts(**ONLINE_FB),
                   mel_opts=MelOpts(num_bins=40))
    t = time.perf_counter()
    graph, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                            num_pdfs=64, seed=1))
    waves, segs, _words = make_corpus(graph, n_train + n_test, T,
                                      np.random.default_rng(0), noise=0.25)
    with torch.no_grad():
        feats = fbank(torch.as_tensor(waves, device="cuda"), fb)
    Tf = feats.shape[1]
    tgt = np.stack([fbank_targets(s, Tf) for s in segs])
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64, hidden_dim=512,
                     pnorm_output_dim=128, nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    tdnn = Tdnn(cfg, device="cuda")
    params = tdnn.init(torch.Generator(device="cuda").manual_seed(0))
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.1, final_lr=0.02), 300)
    state = opt.init(params)
    step = make_train_step(tdnn, opt, compute_dtype=torch.bfloat16)
    tt = torch.as_tensor(tgt[:n_train, cfg.left_context:Tf - cfg.right_context],
                         device="cuda")
    wt = torch.ones(tt.shape, device="cuda")
    for _ in range(300):
        params, state, loss, acc = step(params, state, feats[:n_train], tt, wt)
    tdnn.load_state_dict(params)
    am = AmNnet(tdnn)
    am.set_priors_from_alignment_counts(
        np.bincount(tgt[:n_train].ravel(), minlength=64) + 1.0)
    t_setup = time.perf_counter() - t
    base_dec = BeamSearchDecoder(graph, BeamSearchOpts(
        beam=13.0, max_active=512, acoustic_scale=0.1), device="cuda")
    csr_dec = CsrBeamDecoder(graph, CsrBeamOpts(
        beam=13.0, max_active=512, acoustic_scale=0.1, expand_budget=8192,
        eps_budget=1024), device="cuda")
    ll_off = am.loglikes(feats[n_train:])
    nf = np.full(n_test, Tf, np.int32)
    off, off_csr = base_dec.decode(ll_off, nf), csr_dec.decode(ll_off, nf)
    log(f"  graph {graph.num_states} states / {graph.num_arcs} arcs (max "
        f"out-degree {base_dec.E}); AM trained 300 bf16 steps on {n_train} x "
        f"{waves.shape[1] / SR:.2f} s: loss {float(loss):.4f}, frame "
        f"accuracy {float(acc):.4f}; set-up {t_setup:.3f} s | card: {card}")

    fused = FusedOnlineDecoder(am, csr_dec, fb, chunk_samples=chunk,
                               t_max=1024, keep_loglikes=True)
    for pass_ in range(2):                # pass 0 warms up on one utt
        if pass_ == 1:
            tg.launches = 0               # count the fused path only
        f_stats, f_lat, fin_ms, lat_ms, f_mism = OnlineTimingStats(), [], \
            [], [], 0
        lat_launches = 0
        for u in range(n_test if pass_ else 1):
            wave = waves[n_train + u]
            fused.reset()
            timer = OnlineTimer(f"u{u}")
            for pos in range(0, len(wave), chunk):
                t0 = time.perf_counter()
                fused.accept_waveform(wave[pos:pos + chunk])
                fused.sync()
                f_lat.append((time.perf_counter() - t0) * 1e3)
                timer.wait_until(min(pos + chunk, len(wave)) / SR)
            t0 = time.perf_counter()
            fused.input_finished()
            res = fused.best_path()
            fin_ms.append((time.perf_counter() - t0) * 1e3)
            timer.finish(f_stats)
            t0, n0 = time.perf_counter(), tg.launches
            lat = fused.get_lattice(8.0)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            lat_launches += tg.launches - n0
            if res is None or list(res[0]) != list(off_csr[u][0]):
                f_mism += 1
            if lat is None:
                f_mism += 1
    launches = tg.launches - lat_launches     # streaming only
    frames = n_test * Tf
    if launches < frames:
        raise AssertionError(f"{launches} gather launches for {frames} "
                             f"fused frames")
    fp50, fp95 = _pcts(f_lat)
    log(f"  fused path (CSR engine, B = 1): online RTF "
        f"{f_stats.real_time_factor:.4f} over {f_stats.total_audio:.2f} s "
        f"of audio ({n_test} utts); chunk latency (accept + sync, 160 ms "
        f"chunks) p50 {fp50:.3f} ms p95 {fp95:.3f} ms; finalize "
        f"(input_finished + best_path) median {np.median(fin_ms):.3f} ms; "
        f"get_lattice median {np.median(lat_ms):.3f} ms; max delay "
        f"{f_stats.max_delay:.4f} s; hypothesis mismatches vs offline "
        f"{f_mism} (None lattices counted); gather launches {launches} "
        f"streaming ({launches / frames:.2f}/frame) and {lat_launches} in "
        f"get_lattice's record decodes | card: {card}")
    if f_mism:
        raise AssertionError(f"fused path: {f_mism} mismatches")
    if profile:
        wave = waves[n_train]
        fused.reset()
        profile_online("fused path", wave, chunk, fp50 / 1e3,
                       fused.accept_waveform)

    for pass_ in range(2):                # pass 0 warms up on one utt
        g_stats, g_lat, g_mism = OnlineTimingStats(), [], 0
        for u in range(3 if pass_ else 1):
            wave = waves[n_train + u]
            d = SingleUtteranceNnet2Decoder(
                am, _TmShim, base_dec, OnlineNnet2FeaturePipeline(
                    OnlineMfcc(fb, computer=fbank, device="cuda")),
                chunk_frames=16)
            timer = OnlineTimer(f"u{u}")
            for pos in range(0, len(wave), chunk):
                t0 = time.perf_counter()
                d.pipeline.accept_waveform(wave[pos:pos + chunk])
                d.advance_decoding()
                torch.cuda.synchronize()
                g_lat.append((time.perf_counter() - t0) * 1e3)
                timer.wait_until(min(pos + chunk, len(wave)) / SR)
            d.finalize_decoding()
            timer.finish(g_stats)
            res = d.best_path()
            if res is None or list(res[0]) != list(off[u][0]):
                g_mism += 1
    gp50, gp95 = _pcts(g_lat)
    log(f"  generic path (SingleUtteranceNnet2Decoder, padded engine at "
        f"E = {base_dec.E}, K = 512: {512 * base_dec.E} candidates per "
        f"emitting round): online RTF {g_stats.real_time_factor:.4f} over "
        f"{g_stats.total_audio:.2f} s (3 utts); chunk latency p50 "
        f"{gp50:.3f} ms p95 {gp95:.3f} ms; max delay "
        f"{g_stats.max_delay:.4f} s; hypothesis mismatches vs offline "
        f"{g_mism} | card: {card}")
    if g_mism:
        raise AssertionError(f"generic path: {g_mism} mismatches")
    if profile:
        d = SingleUtteranceNnet2Decoder(
            am, _TmShim, base_dec, OnlineNnet2FeaturePipeline(
                OnlineMfcc(fb, computer=fbank, device="cuda")),
            chunk_frames=16)

        def feed(w):
            d.pipeline.accept_waveform(w)
            d.advance_decoding()
        profile_online("generic path", waves[n_train], chunk, gp50 / 1e3,
                       feed)

    # the gather kernel at the fused CSR path's B = 1 shapes
    o, tabs = csr_dec.opts, csr_dec.tabs
    K = int(o.max_active)
    cbr = -(-int(o.expand_budget) // tabs.b_apr)
    shapes = [(1, 64, 2 * K + (tabs.b_apr * cbr if tabs.brow.shape[0] > 1
                               else 0)), (1, K, cbr)]
    g = torch.Generator(device="cuda").manual_seed(3)
    times = {}
    for (B, P, N) in shapes:
        tab = torch.randn(B, P, device="cuda", generator=g)
        idx = torch.randint(0, P, (B, N), device="cuda", generator=g,
                            dtype=torch.int32)
        if not torch.equal(tg.gather_cuda(tab, idx),
                           tg.batched_table_gather_ref(tab, idx)):
            raise AssertionError(f"gather != plain at {(B, P, N)}")
        times[(B, P, N)] = (cuda_ms(lambda: tg.gather_cuda(tab, idx)),
                            cuda_ms(lambda: tg.batched_table_gather_ref(
                                tab, idx)),
                            cuda_ms(lambda: torch.gather(tab, 1,
                                                         idx.long())))
        k_ms, p_ms, l_ms = times[(B, P, N)]
        log(f"  gather at the fused path's shape tab [{B}, {P}] idx [{B}, "
            f"{N}]: kernel {k_ms:.6f} ms, plain version {p_ms:.6f} ms, "
            f"torch.gather {l_ms:.6f} ms, bound "
            f"{gather_bound_ms(B, P, N):.6f} ms by bytes")
    return {"launches": launches, "shape": shapes[0],
            "times": times[shapes[0]]}


def device_time(fn) -> tuple[float, int, dict]:
    """Run fn under torch.profiler. -> (device busy seconds: the sum of
    kernel, memcpy and memset durations, which do not overlap on one
    stream; device op count; {name: [us, count]})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in dev:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    return sum(e.time_range.elapsed_us() for e in dev) / 1e6, len(dev), by_name


def log_profile(what: str, per: str, n: int, busy: float, n_ops: int,
                by_name: dict, host_s_per: float, top: int):
    """Device busy time per unit against the unprofiled host time per unit,
    and the device ops that take the time."""
    log(f"  profile ({what}): device busy {busy / n * 1e3:.4f} ms/{per} in "
        f"{n_ops / n:.1f} device ops/{per}; unprofiled host "
        f"{host_s_per * 1e3:.4f} ms/{per} -> device idle "
        f"{100 * (1 - busy / n / host_s_per):.1f}%")
    for name, (us, k) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        log(f"    {us / n:9.2f} us/{per} {k / n:6.1f}/{per}  {name[:80]}")


# device kernels by kind, by a substring of the kernel's name
KERNEL_KINDS = (("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
                ("copy and cast", ("copy", "Memcpy", "Memset")),
                ("reduction", ("reduce",)))


def log_by_kind(by_name: dict, n: int, per: str):
    """Device time per unit summed by KERNEL_KINDS; the rest is
    elementwise and other kernels."""
    kinds: dict[str, list] = {}
    for name, (us, k) in by_name.items():
        kind = next((kind for kind, keys in KERNEL_KINDS
                     if any(key in name for key in keys)),
                    "elementwise and other")
        acc = kinds.setdefault(kind, [0.0, 0])
        acc[0] += us
        acc[1] += k
    log("  by kind: " + "; ".join(
        f"{kind} {us / n / 1e3:.4f} ms/{per} in {k / n:.1f} ops"
        for kind, (us, k) in sorted(kinds.items(), key=lambda kv: -kv[1][0])))


def profile_decode(dec, ll, frames: int, host_s_per_frame: float):
    """One decode of the first `frames` frames under torch.profiler."""
    ll = ll[:, :frames].contiguous()
    B = ll.shape[0]
    busy, n_ops, by_name = device_time(
        lambda: dec.decode(ll, np.full(B, frames, np.int32)))
    log_profile(f"{frames} frames x {B} utts", "frame", frames, busy, n_ops,
                by_name, host_s_per_frame, 25)


def profile_stream(srv, waves, chunk: int, host_s_per_step: float):
    """Six steady streaming steps (all slots fed, past the first chunks)
    under torch.profiler."""
    slots = [srv.open() for _ in waves]
    for s, w in zip(slots, waves):
        srv.feed(s, w[:10 * chunk])
    for _ in range(4):
        srv.step()
    n = 6
    busy, n_ops, by_name = device_time(
        lambda: [srv.step() for _ in range(n)])
    for s in slots:
        srv.close(s)
    log_profile(f"{n} steady steps x {len(slots)} streams", "step", n, busy,
                n_ops, by_name, host_s_per_step, 12)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kaldi_tpu_torch import cuda_build
    from kaldi_tpu_torch.device import card_info, resolve_device
    from kaldi_tpu_torch.nnet import quantized as q
    from kaldi_tpu_torch.ops import table_gather as tg

    resolve_device("cuda")                # also turns TF32 off
    card = card_info()
    log(f"[1/16] card: {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t = time.perf_counter()
    libs = cuda_build.build()
    log(f"[2/16] build: {len(libs)} kernels in {time.perf_counter() - t:.3f} "
        f"s (one nvcc each, in parallel)")
    for name, so in libs.items():
        with open(os.path.join(os.path.dirname(so), "nvcc.log")) as f:
            regs = [ln.split("info    : ")[-1] for ln in f
                    if "registers" in ln or "spill" in ln]
        log(f"  {os.path.relpath(so, ROOT)}: {' | '.join(regs)}")

    log("[3/16] table-gather kernel vs plain version")
    k = phase_kernel(tg)
    log("[4/16] qaffine kernel vs plain version")
    qk = phase_qaffine(q)
    log("[5/16] decoder on the card vs on the CPU")
    phase_decoder_parity()
    log("[6/16] int8 decode on the card vs on the CPU")
    phase_int8_parity()
    log("[7/16] full-width serving slice (bf16 TDNN)")
    sl = phase_slice(tg, card, profile="--profile" in sys.argv[1:])
    log("[8/16] full-width int8 serving slice")
    s8 = phase_int8_slice(q, tg, sl, card)
    log("[9/16] streaming server, small: card vs CPU vs offline")
    phase_stream_small()
    log("[10/16] streaming server, full width")
    st = phase_stream_full(tg, sl, card, profile="--profile" in sys.argv[1:])
    log("[11/16] lattice path, small: card vs CPU, native vs numpy")
    phase_lattice_small()
    log("[12/16] training, small: card vs CPU")
    phase_train_small()
    log("[13/16] training, full width: the bench's AM with the port's "
        "train step")
    tr = phase_train_full(sl, card, profile="--profile" in sys.argv[1:])
    log("[14/16] lattice path, full width (latgen at the bench's point)")
    lt = phase_lattice_full(tg, sl, tr, card)
    log("[15/16] online path, small: card vs CPU vs offline")
    phase_online_small()
    log("[16/16] online path, full width (scripts/bench_streaming.py's "
        "configuration)")
    on = phase_online_full(tg, card, profile="--profile" in sys.argv[1:])

    g_shape = GATHER_SHAPES[0]
    ms, plain_ms, library_ms, floor_ms = k["times"][g_shape]
    log(f"launches: gather {sl['launches']} on the bf16 slice, "
        f"{st['launches']} on the streaming path, {lt['launches']} on the "
        f"latgen path, {lt['adaptive_launches']} in the adaptive decode, "
        f"{on['launches']} on the fused online path; qaffine "
        f"{s8['launches']} on the int8 slice")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "batched_table_gather", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/table_gather.cu",
        "replaces": "kaldi_tpu/ops/table_gather.py:50",
        "launches": sl["launches"], "lattice_launches": lt["launches"],
        "online_launches": on["launches"],
        "max_abs_err": k["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": gather_bound_ms(*g_shape), "bound_by": "bytes",
        "library_ms": library_ms, "floor_ms": floor_ms,
        "online_shape": on["shape"], "online_ms": on["times"][0],
        "online_plain_ms": on["times"][1],
        "online_library_ms": on["times"][2],
        "online_bound_ms": gather_bound_ms(*on["shape"])}, {
        "name": "qaffine", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/qaffine.cu",
        "replaces": "kaldi_tpu/nnet/quantized.py:46",
        "launches": s8["launches"], "max_abs_err": qk["max_abs_err"],
        "max_rel_err": qk["max_rel_err"],
        "ms": qk["ms"], "plain_ms": qk["plain_ms"],
        "max_rel_err_f64": qk["max_rel_err_f64"],
        "plain_max_rel_err_f64": qk["plain_max_rel_err_f64"],
        "bound_ms": qk["bound_ms"], "bound_by": qk["bound_by"],
        "three_pass_bound_ms": qk["three_pass_bound_ms"],
        "fp32_bound_ms": qk["fp32_bound_ms"],
        "library_ms": qk["library_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
