"""Batched Viterbi alignment over per-utterance training graphs.

Counterpart of kaldi_tpu/decoder/viterbi.py (ref: decoder/faster-decoder.h:61,
gmmbin/gmm-align-compiled.cc): dense masked dynamic programming over the
padded [B, S] state space of a `PackedGraphBatch`,

    alpha[t+1, dst] = min over arcs a into dst of
        alpha[t, src(a)] + graph_cost(a) + acoustic_cost(t+1, pdf(a))

one gather and one scatter-min per frame. JAX's `lax.scan` is a frame loop
that enqueues device work without synchronising; its `.at[].min(mode=
"drop")` scatters are `scatter_reduce(amin, include_self=True)` into one
spare column past the last state, cut off after (min is exact in any order,
so the result does not depend on the scatter's order). The backpointer of
a state is the smallest arc index among the arcs that reach it within 1e-6
of its best and below BIG/2, -1 for none: an int32 amin scatter, as in JAX.
The [T, B, S] backpointers come to the host in one copy and are walked
there, as JAX does. Assumes no input-epsilon arcs (training graphs after
self-loop insertion are fully emitting).
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.decoder.graph_pack import PackedGraphBatch
from kaldi_tpu_torch.decoder.hostpack import BIG, device_mask, fetch_host
from kaldi_tpu_torch.device import resolve_device


def _viterbi_forward(loglikes, src, nextstate, cost, pdf, start, final,
                     frame_mask, num_states: int):
    """loglikes [B, T, P] f32; src, nextstate, pdf [B, A] int64; cost
    [B, A] f32; start [B] int64; final [B, S] f32; frame_mask [B, T] bool,
    all on one device. -> (bp [T, B, S] int32, best_state [B],
    total_cost [B]). Padded frames copy alpha through and write -1."""
    B, T, _P = loglikes.shape
    S = num_states
    A = src.shape[1]
    dev = loglikes.device
    alpha = torch.full((B, S), float(BIG), device=dev)
    alpha[torch.arange(B, device=dev), start] = 0.0
    # mode="drop": a target outside [0, S) lands in the spare column S
    dst = torch.where((nextstate >= 0) & (nextstate < S), nextstate, S)
    arc_idx = torch.arange(A, dtype=torch.int32, device=dev)[None, :]
    no_arc = torch.tensor(A + 1, dtype=torch.int32, device=dev)
    minus1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    big = torch.full((B, S + 1), float(BIG), device=dev)
    none = torch.full((B, S + 1), A + 1, dtype=torch.int32, device=dev)
    bps = torch.empty((T, B, S), dtype=torch.int32, device=dev)
    for t in range(T):
        # arc scores: alpha[src] + graph cost + acoustic cost of arc pdf
        a_src = torch.gather(alpha, 1, src)
        am = -torch.gather(loglikes[:, t], 1, pdf)
        score = a_src + cost + am
        new_full = big.scatter_reduce(1, dst, score, "amin",
                                      include_self=True)
        # winning arc per dst: the smallest index among the arcs within
        # 1e-6 of the best
        dst_best = torch.gather(new_full, 1, dst)
        is_best = (score <= dst_best + 1e-6) & (score < BIG * 0.5)
        bp_val = torch.where(is_best, arc_idx, no_arc)
        bp = none.scatter_reduce(1, dst, bp_val, "amin",
                                 include_self=True)[:, :S]
        bp = torch.where(bp > A, -1, bp)
        m = frame_mask[:, t, None]
        alpha = torch.where(m, new_full[:, :S], alpha)
        torch.where(m, bp, minus1, out=bps[t])
    total = alpha + final
    best_state = torch.argmin(total, dim=1)
    best_cost = torch.gather(total, 1, best_state[:, None])[:, 0]
    return bps, best_state, best_cost


def viterbi_align(
    batch: PackedGraphBatch,
    loglikes,
    num_frames: np.ndarray,
    acoustic_scale: float = 1.0,
    device="cuda",
):
    """Align a batch on `device` (the card unless the caller asks for
    "cpu"). loglikes [B, T, num_pdfs] (unscaled; numpy or tensor),
    num_frames [B].

    Returns list over batch of (tids [T_b], words, total_cost) or None if
    alignment failed (no path).
    """
    dev = resolve_device(device)
    ll = torch.as_tensor(loglikes).to(device=dev, dtype=torch.float32)
    B, T, _P = ll.shape

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    bp_d, best_state_d, best_cost_d = _viterbi_forward(
        ll * acoustic_scale, t64(batch.src), t64(batch.nextstate),
        torch.as_tensor(batch.cost, device=dev), t64(batch.pdf),
        t64(batch.start), torch.as_tensor(batch.final, device=dev),
        device_mask(np.asarray(num_frames), T, dev),
        int(batch.final.shape[1]))
    bp, best_state, best_cost = fetch_host([bp_d, best_state_d, best_cost_d])
    results = []
    for b in range(B):
        Tb = int(num_frames[b])
        if not np.isfinite(best_cost[b]) or best_cost[b] >= BIG * 0.5:
            results.append(None)
            continue
        tids = np.zeros(Tb, np.int32)
        words = []
        s = int(best_state[b])
        ok = True
        for t in range(Tb - 1, -1, -1):
            a = int(bp[t, b, s])
            if a < 0:
                ok = False
                break
            tids[t] = batch.ilabel[b, a]
            if batch.olabel[b, a] != 0:
                words.append(int(batch.olabel[b, a]))
            s = int(batch.src[b, a])
        words.reverse()
        results.append((tids, words, float(best_cost[b])) if ok else None)
    return results


def equal_align(batch: PackedGraphBatch, num_frames: np.ndarray,
                seed: int = 0, device="cuda"):
    """A legal T-frame path through each graph, acoustics-free.

    (ref: bin/align-equal-compiled.cc / fstext EqualAlign — used for the 0th
    training iteration.) The same DP with zero acoustic input and a small
    random perturbation on arc costs so ties spread across paths; the
    perturbation is JAX's draw from np.random.RandomState(seed).
    """
    rng = np.random.RandomState(seed)
    B = len(batch.start)
    T = int(np.max(num_frames))
    ll = np.zeros((B, T, 1), np.float32)
    pert = batch.cost + rng.uniform(0.0, 0.01, batch.cost.shape).astype(np.float32)
    batch2 = PackedGraphBatch(
        batch.arc_start, batch.ilabel, batch.olabel, pert, batch.nextstate,
        batch.src, np.zeros_like(batch.pdf), batch.final, batch.start,
        batch.num_states, batch.num_arcs,
    )
    return viterbi_align(batch2, ll, num_frames, device=device)
