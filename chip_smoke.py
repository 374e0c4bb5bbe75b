#!/usr/bin/env python3
"""Run the PyTorch port's serving path once on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and the script exits non-zero):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile the table-gather kernel from kaldi_tpu_torch/csrc;
  3. kernel vs plain: bit-exact against torch.gather at the decoder's
     shapes and at the edges, with CUDA-event timings of both;
  4. decoder on the card vs the same port on the CPU, on small graphs:
     identical words, tids and counters, cost within 1e-2;
  5. full-width slice: the 60k-word / 1.05M-state HCLG and the 2048-pdf
     relu TDNN (random weights from a seed) behind `Recognizer`, answering
     three requests of 8 x 10 s utterances in bf16 at beam 13,
     max_active 7000, expand_budget 16384, then one request split by
     layer; --profile adds one decode under torch.profiler (device busy
     share and the kernels that take the device time).

The line before the last is a JSON object with each kernel's launches on
the main path, error against its plain version and times; the last line
is {"ok": true, "device": {...}}. There is no CPU fallback: without CUDA
the script fails.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

GATHER_SHAPES = [(8, 2048, 30384),   # fused acoustic lookup, per frame
                 (8, 7000, 4096)]    # frontier-score lookup, per frame
GATHER_EDGES = [(3, 200, 1000),      # P not a multiple of 128
                (2, 16384, 5000),    # widest staged row
                (2, 20000, 3000),    # global-memory path
                (4, 7000, 1),        # N = 1
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


def phase_kernel(tg) -> dict:
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    err = 0.0
    for (B, P, N) in GATHER_SHAPES + GATHER_EDGES:
        tab = torch.randn(B, P, device="cuda", generator=g)
        idx = torch.randint(0, P, (B, N), device="cuda", generator=g,
                            dtype=torch.int32)
        got = tg.gather_cuda(tab, idx)
        torch.cuda.synchronize()
        want = torch.gather(tab, 1, idx.long())
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != torch.gather at {(B, P, N)}")
        err = max(err, float((got - want).abs().max()))
    # out-of-range indices give 0.0, as in the TPU kernel
    tab = torch.randn(2, 100, device="cuda", generator=g)
    idx = torch.tensor([[-1, 0, 99, 100], [5, 1000, -7, 3]],
                       dtype=torch.int32, device="cuda")
    if not torch.equal(tg.gather_cuda(tab, idx),
                       tg.batched_table_gather_ref(tab, idx)):
        raise AssertionError("kernel != plain version on out-of-range indices")
    torch.cuda.synchronize()
    times = {}
    for (B, P, N) in GATHER_SHAPES:
        tab = torch.randn(B, P, device="cuda", generator=g)
        idx = torch.randint(0, P, (B, N), device="cuda", generator=g,
                            dtype=torch.int32)
        il = idx.long()
        times[(B, P, N)] = (cuda_ms(lambda: tg.gather_cuda(tab, idx)),
                            cuda_ms(lambda: tg.batched_table_gather_ref(tab,
                                                                        idx)),
                            cuda_ms(lambda: torch.gather(tab, 1, il)))
        log(f"  gather tab [{B}, {P}] idx [{B}, {N}]: kernel "
            f"{times[(B, P, N)][0]:.6f} ms, plain version "
            f"{times[(B, P, N)][1]:.6f} ms, torch.gather alone "
            f"{times[(B, P, N)][2]:.6f} ms (device time per call: CUDA graph "
            f"of 100 calls, median of 20 replays)")
    log(f"  kernel bit-exact at {len(GATHER_SHAPES + GATHER_EDGES)} shapes "
        f"and out-of-range indices")
    return {"max_abs_err": err, "times": times}


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
    return {"launches": launches}


def profile_decode(dec, ll, frames: int, host_s_per_frame: float):
    """One decode of the first `frames` frames under torch.profiler: the
    device's busy time (sum of kernel, memcpy and memset durations; one
    stream, so they do not overlap) against the unprofiled host time per
    frame, and the kernels that take the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ll = ll[:, :frames].contiguous()
    B = ll.shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.decode(ll, np.full(B, frames, np.int32))
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    by_name: dict[str, list] = {}
    for e in dev:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    per_frame = busy / frames
    log(f"  profile ({frames} frames x {B} utts): device busy "
        f"{per_frame * 1e3:.4f} ms/frame in {len(dev) / frames:.1f} device "
        f"ops/frame; unprofiled host loop {host_s_per_frame * 1e3:.4f} "
        f"ms/frame -> device idle {100 * (1 - per_frame / host_s_per_frame):.1f}%")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        log(f"    {us / frames:9.2f} us/frame {n / frames:6.1f}/frame  {name[:80]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kaldi_tpu_torch.device import card_info, resolve_device
    from kaldi_tpu_torch.ops import table_gather as tg

    resolve_device("cuda")                # also turns TF32 off
    card = card_info()
    log(f"[1/5] card: {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t = time.perf_counter()
    so = tg.build()
    tg._load()
    log(f"[2/5] build: {os.path.relpath(so, ROOT)} in "
        f"{time.perf_counter() - t:.3f} s")

    log("[3/5] table-gather kernel vs plain version")
    k = phase_kernel(tg)
    log("[4/5] decoder on the card vs on the CPU")
    phase_decoder_parity()
    log("[5/5] full-width serving slice")
    s = phase_slice(tg, card, profile="--profile" in sys.argv[1:])

    ms, plain_ms, _ = k["times"][GATHER_SHAPES[0]]
    log(card)
    log(json.dumps({"kernels": [{
        "name": "batched_table_gather", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/table_gather.cu",
        "replaces": "kaldi_tpu/ops/table_gather.py:50",
        "launches": s["launches"], "max_abs_err": k["max_abs_err"],
        "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
