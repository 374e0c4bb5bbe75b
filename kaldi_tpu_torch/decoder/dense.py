"""Dense Viterbi decoding over the FULL state space — the fast path for
small and medium HCLG graphs.

Counterpart of kaldi_tpu/decoder/dense.py (ref: decoder/faster-decoder.h:61
FasterDecoder — best-path decoding without lattices). Per frame,

    alpha[t+1, dst] = min over arcs (alpha[t, src] + w + am[pdf])

is a gather of each state's incoming arcs (static [S, cap] tables built
once on the host, plus a hub table for states of in-degree > cap) and a
min over them, then the epsilon-closure rounds; no sorts. `make_decoder`
picks this decoder or the beam decoders by the graph's size, as JAX's does.

Three forward passes, as in JAX:
- sequential (`_dense_decode`): a frame loop on the device that keeps the
  [T, rounds, B, S] backpointer arena;
- checkpointed (`_dense_decode_ckpt`, for arenas over the memory budget):
  the forward keeps each C-frame chunk's entry alpha; the backward pass
  re-runs one chunk at a time and walks it;
- associative (`_dense_decode_assoc`, S <= assoc_max_states): each frame
  is an [S, S] min-plus matrix and the prefix products come from JAX's
  own odd-even `associative_scan` recursion (`_associative_scan`), so the
  f32 sums associate as in JAX; the min-plus product reduces over k one
  slice at a time, so [..., S, S] stays live instead of [..., S, S, S].
  The backpointers of all frames are then recomputed at once from the
  per-frame alphas, with amin scatters over a flat src * S + nxt index.

What changes with the framework: `jnp.argmin` takes the first minimum,
and so does `torch.min` along a dim; JAX's vmapped reverse-scan
traceback is a walk on the host over the backpointers, fetched in one copy
and vectorised over the batch (`_trace_frames`, `_trace_init`); the
checkpointed path fetches one chunk's backpointers at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.csr_beam import (_HALF_BIG, BIG, CsrBeamDecoder,
                                              CsrBeamOpts, resolve_eps_rounds)
from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
from kaldi_tpu_torch.decoder.hostpack import (device_mask, fetch_host,
                                              parse_label_seqs)
from kaldi_tpu_torch.device import resolve_device

def _incoming_tables(dst: np.ndarray, A: int, S: int, cap: int = 64):
    """Static incoming-arc tables for gather-based min relaxation.

    Arcs are grouped by destination ONCE (host side): a [S, cap] table of
    incoming arc ids for normal states, plus a small hub table [H, E_hub]
    for high-in-degree states (e.g. the HCLG loop state, where thousands
    of word arcs converge — padding every state to that width would blow
    up memory). Dummy slot = A.
    -> (t1 [S, cap] int32, hub_states [H] int32, t2 [H, E_hub] int32).
    """
    if A == 0:
        return (np.full((S, 1), A, np.int32), np.zeros(0, np.int32),
                np.full((0, 1), A, np.int32))
    order = np.argsort(dst, kind="stable").astype(np.int32)
    indeg = np.bincount(dst, minlength=S)
    start = np.concatenate([[0], np.cumsum(indeg)])
    cap = int(min(cap, max(indeg.max(), 1)))
    hub = indeg > cap
    hub_states = np.where(hub)[0].astype(np.int32)
    t1 = np.full((S, cap), A, np.int32)
    sorted_dst = dst[order]
    cols = np.arange(A) - start[sorted_dst]
    lo = ~hub[sorted_dst]
    t1[sorted_dst[lo], cols[lo]] = order[lo]
    if len(hub_states):
        Em = int(indeg[hub_states].max())
        t2 = np.full((len(hub_states), Em), A, np.int32)
        hidx = np.zeros(S, np.int64)
        hidx[hub_states] = np.arange(len(hub_states))
        hi = ~lo
        t2[hidx[sorted_dst[hi]], cols[hi]] = order[hi]
    else:
        t2 = np.full((0, 1), A, np.int32)
    return t1, hub_states, t2


def _gather_min(cand_pad, t1, hub_states, t2, A: int, want_bp: bool = True):
    """cand_pad [B, A+1] (slot A = BIG dummy) -> per-state (min [B, S],
    winning arc id [B, S] int32, -1 where nothing reached; None when not
    want_bp). Tables are int64 tensors on cand_pad's device."""
    B = cand_pad.shape[0]
    g1 = cand_pad[:, t1]                                  # [B, S, cap]
    if not want_bp:
        new = torch.amin(g1, dim=-1)
        if t2.shape[0]:
            hmin = torch.amin(cand_pad[:, t2], dim=-1)
            new[:, hub_states] = torch.minimum(hmin, new[:, hub_states])
        return new, None
    new, pos = torch.min(g1, dim=-1)                      # first minimum
    arc = torch.gather(t1.expand(B, -1, -1), 2, pos[..., None])[..., 0]
    if t2.shape[0]:
        hmin, hpos = torch.min(cand_pad[:, t2], dim=-1)   # [B, H]
        harc = torch.gather(t2.expand(B, -1, -1), 2, hpos[..., None])[..., 0]
        cur = new[:, hub_states]
        better = hmin < cur
        new[:, hub_states] = torch.where(better, hmin, cur)
        arc[:, hub_states] = torch.where(better, harc, arc[:, hub_states])
    bp = torch.where((new < _HALF_BIG) & (arc < A), arc, -1).to(torch.int32)
    return new, bp


def _build_steps(e_src, e_cost, e_pdf, z_src, z_cost, e_tabs, z_tabs,
                 B: int, n_eps: int):
    """The per-frame gather-min relaxation + eps-closure rounds, shared by
    the full-arena and checkpointed forward passes. Backpointers hold the
    winning ARC id per (batch, state), -1 if unreached."""
    Ae = e_src.shape[0]
    Az = z_src.shape[0]
    dev = e_src.device
    pad1 = torch.full((B, 1), float(BIG), device=dev)
    minus1 = torch.tensor(-1, dtype=torch.int32, device=dev)

    def eps_round(alpha, want_bp=True):
        cand = torch.clamp(alpha.index_select(1, z_src) + z_cost[None, :],
                           max=float(BIG))
        relaxed, bp = _gather_min(torch.cat([cand, pad1], dim=1), *z_tabs,
                                  Az, want_bp)
        keep = alpha <= relaxed
        new = torch.where(keep, alpha, relaxed)
        if want_bp:
            bp = torch.where(keep, minus1, bp)
        return new, bp

    def frame_step(alpha, ll_t, mask_t, bp_out=None):
        """-> alpha after the frame. bp_out: None, or a pair of views
        ([B, S], [n_eps, B, S] int32) to write the backpointers into."""
        want = bp_out is not None
        am = -ll_t.index_select(1, e_pdf)                 # [B, Ae]
        cand = torch.clamp(alpha.index_select(1, e_src) + e_cost[None, :]
                           + am, max=float(BIG))
        new, bp_e = _gather_min(torch.cat([cand, pad1], dim=1), *e_tabs,
                                Ae, want)
        m = mask_t[:, None]
        for r in range(n_eps):
            new, bp_z = eps_round(new, want)
            if want:
                torch.where(m, bp_z, minus1, out=bp_out[1][r])
        if want:
            torch.where(m, bp_e, minus1, out=bp_out[0])
        return torch.where(m, new, alpha)

    return eps_round, frame_step


def _best_end_state(alpha_T, final):
    """-> (state0 [B], cost [B]): the best final state, or the best state
    of all (cost >= BIG/2 then) when no final state was reached."""
    total = alpha_T + final[None, :]
    best_final_cost, best_state = torch.min(total, dim=1)
    any_cost, any_state = torch.min(alpha_T, dim=1)
    reached = best_final_cost < _HALF_BIG
    state0 = torch.where(reached, best_state, any_state)
    cost = torch.where(reached, best_final_cost, any_cost)
    return state0, cost


def _start_alpha(B: int, S: int, start: int, eps_round, n_eps: int, dev):
    """The start state's alpha after its eps closure, and the closure's
    backpointers [n_eps, B, S]."""
    alpha = torch.full((B, S), float(BIG), device=dev)
    alpha[:, start] = 0.0
    init_bps = torch.empty((n_eps, B, S), dtype=torch.int32, device=dev)
    for r in range(n_eps):
        alpha, init_bps[r] = eps_round(alpha)
    return alpha, init_bps


def _dense_decode(ll, frame_mask, steps, final, start: int, S: int,
                  n_eps: int):
    """Sequential forward with the full backpointer arena. ll [B, T, P]
    scaled. -> device tensors (bp_e [T, B, S], bp_z [T, n_eps, B, S],
    init_bps [n_eps, B, S], state0 [B], cost [B])."""
    eps_round, frame_step = steps
    B, T, _P = ll.shape
    dev = ll.device
    alpha, init_bps = _start_alpha(B, S, start, eps_round, n_eps, dev)
    bp_e = torch.empty((T, B, S), dtype=torch.int32, device=dev)
    bp_z = torch.empty((T, n_eps, B, S), dtype=torch.int32, device=dev)
    for t in range(T):
        alpha = frame_step(alpha, ll[:, t], frame_mask[:, t],
                           (bp_e[t], bp_z[t]))
    state0, cost = _best_end_state(alpha, final)
    return bp_e, bp_z, init_bps, state0, cost


def _dense_decode_ckpt(ll, frame_mask, steps, final, start: int, S: int,
                       n_eps: int, C: int, labels):
    """Checkpointed-memory dense Viterbi: the forward keeps only each
    C-frame chunk's entry alpha; the backward pass re-runs one chunk at a
    time with its [C, rounds, B, S] backpointers, copies them to the host
    and walks them (memory O(T/C·B·S + C·rounds·B·S) for ~2x forward
    compute; T must be a multiple of C). -> host (ols [B, T, n_eps+1],
    ils [B, T, 1], init_ols [B, n_eps], cost [B])."""
    eps_round, frame_step = steps
    B, T, _P = ll.shape
    assert T % C == 0
    dev = ll.device
    alpha, init_bps = _start_alpha(B, S, start, eps_round, n_eps, dev)
    alphas_in = []
    for c in range(T // C):
        alphas_in.append(alpha)             # the chunk's ENTRY alpha
        for t in range(c * C, (c + 1) * C):
            alpha = frame_step(alpha, ll[:, t], frame_mask[:, t])
    state0, cost = _best_end_state(alpha, final)
    s, cost, init_bps = fetch_host([state0, cost, init_bps])
    ols = np.zeros((B, T, n_eps + 1), np.int32)
    ils = np.zeros((B, T, 1), np.int32)
    bp_e = torch.empty((C, B, S), dtype=torch.int32, device=dev)
    bp_z = torch.empty((C, n_eps, B, S), dtype=torch.int32, device=dev)
    for c in range(T // C - 1, -1, -1):
        a = alphas_in[c]
        for i, t in enumerate(range(c * C, (c + 1) * C)):
            a = frame_step(a, ll[:, t], frame_mask[:, t], (bp_e[i], bp_z[i]))
        e_h, z_h = fetch_host([bp_e, bp_z])
        o, il, s = _trace_frames(e_h, z_h, s, *labels)
        ols[:, c * C:(c + 1) * C] = o
        ils[:, c * C:(c + 1) * C] = il
    init_ols = _trace_init(init_bps, s, labels[3], labels[4])
    return ols, ils, init_ols, cost


def _trace_frames(bp_e, bp_z, state0, e_src, e_ol, e_il, z_src, z_ol):
    """Walk states backward over a span of frames on the host, vectorised
    over the batch.

    bp_e [T, B, S]; bp_z [T, n_eps, B, S]; state0 [B] is the state at the
    END of the span. -> (ols [B, T, n_eps+1] (the emitting arc's olabel,
    then each eps round's), ils [B, T, 1], s_start [B] — the state at the
    span's start)."""
    T, R, B, _S = bp_z.shape
    ols = np.zeros((T, R + 1, B), np.int32)
    ils = np.zeros((T, B), np.int32)
    rb = np.arange(B)
    s = np.asarray(state0, np.int64)
    for t in range(T - 1, -1, -1):
        for r in range(R - 1, -1, -1):
            a = bp_z[t, r, rb, s]
            taken = a >= 0
            a = np.maximum(a, 0)
            ols[t, r + 1] = np.where(taken, z_ol[a], 0)
            s = np.where(taken, z_src[a], s)
        a = bp_e[t, rb, s]
        taken = a >= 0
        a = np.maximum(a, 0)
        ols[t, 0] = np.where(taken, e_ol[a], 0)
        ils[t] = np.where(taken, e_il[a], 0)
        s = np.where(taken, e_src[a], s)
    return ols.transpose(2, 0, 1), ils.T[:, :, None], s


def _trace_init(init_bps, s_start, z_src, z_ol):
    """Trace the pre-frame-0 eps closure on the host. init_bps
    [n_eps, B, S] -> init_ols [B, n_eps]."""
    R, B = init_bps.shape[:2]
    out = np.zeros((R, B), np.int32)
    rb = np.arange(B)
    s = np.asarray(s_start, np.int64)
    for r in range(R - 1, -1, -1):
        a = init_bps[r, rb, s]
        taken = a >= 0
        a = np.maximum(a, 0)
        out[r] = np.where(taken, z_ol[a], 0)
        s = np.where(taken, z_src[a], s)
    return out.T


def _minplus(x, y):
    """Min-plus product out[..., i, j] = min_k x[..., i, k] + y[..., k, j]
    (y may be [S, S] or batched like x). Reduces over k one slice at a
    time: [..., S, S] stays live, never [..., S, S, S]. min is exact, so
    the order over k changes nothing."""
    out = x[..., :, 0:1] + y[..., 0:1, :]
    for k in range(1, x.shape[-1]):
        torch.minimum(out, x[..., :, k:k + 1] + y[..., k:k + 1, :], out=out)
    return out


def _interleave(a, b):
    """a [B, n_a, ...], b [B, n_b, ...] with n_a in (n_b, n_b + 1) ->
    [B, n_a + n_b, ...] with a at even and b at odd positions."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _associative_scan(fn, elems):
    """Inclusive scan of `fn` along dim 1, by the recursion of
    jax.lax.associative_scan (combine adjacent pairs, scan the halves,
    fill in the evens): the same products, associated the same way."""
    n = elems.shape[1]
    if n < 2:
        return elems
    reduced = fn(elems[:, 0:n - 1:2], elems[:, 1::2])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(odd[:, :-1], elems[:, 2::2])
    else:
        even = fn(odd, elems[:, 2::2])
    even = torch.cat([elems[:, :1], even], dim=1)
    return _interleave(even, odd)


def _scatter_min_last(base, idx, src):
    """base [..., N] with src [..., A] amin-scattered at idx [A] along the
    last dim (include_self: base's values take part)."""
    return base.scatter_reduce(-1, idx.expand(src.shape), src, "amin",
                               include_self=True)


def _dense_decode_assoc(ll, frame_mask, e_src, e_nxt, e_cost, e_pdf,
                        z_src, z_nxt, z_cost, final, start: int, S: int,
                        n_eps: int):
    """Depth-parallel Viterbi: the frame recurrence is a min-plus matrix
    product, so the forward pass is ONE associative scan of per-frame
    [S, S] transition matrices; backpointers are then recomputed for all
    frames at once from the per-frame alphas. Memory O(B·T·S²): the
    caller gates this path to small S. -> device tensors (bp_e [B, T, S],
    bp_z [n_eps, B, T, S], init_bps [n_eps, B, S], state0, cost)."""
    B, T, _P = ll.shape
    Ae = e_src.shape[0]
    Az = z_src.shape[0]
    dev = ll.device
    big = float(BIG)
    eye = torch.where(torch.eye(S, dtype=torch.bool, device=dev), 0.0, big)
    Z = _scatter_min_last(torch.full((S * S,), big, device=dev),
                          z_src * S + z_nxt, z_cost).view(S, S)
    IZ = torch.minimum(Z, eye)
    E = eye
    for _ in range(n_eps):
        E = _minplus(E[None], IZ)[0]

    # per-frame emitting min-plus matrices (+ eps closure folded in)
    am = -ll.index_select(2, e_pdf)                       # [B, T, Ae]
    cand = am + e_cost[None, None, :]
    Mt = _scatter_min_last(torch.full((B, T, S * S), big, device=dev),
                           e_src * S + e_nxt, cand).view(B, T, S, S)
    A = _minplus(Mt, E)                                   # [B, T, S, S]
    del Mt
    # padded frames are identity (tokens pass through unchanged)
    A = torch.where(frame_mask[:, :, None, None], A, eye)
    Pt = _associative_scan(_minplus, A)                   # prefix products
    del A
    alpha0 = E[start]                                     # [S]
    alpha_t = torch.amin(alpha0[None, None, :, None] + Pt, dim=-2)
    del Pt
    alpha_prev = torch.cat([alpha0.expand(B, 1, S), alpha_t[:, :-1]], dim=1)

    # recompute per-frame backpointers for ALL frames in fused ops
    m3 = frame_mask[:, :, None]
    minus1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    cand_e = alpha_prev.index_select(2, e_src) + e_cost + am
    after = _scatter_min_last(torch.full((B, T, S), big, device=dev), e_nxt,
                              cand_e)
    dst_best = after.index_select(2, e_nxt)
    is_best = (cand_e <= dst_best + 1e-6) & (cand_e < _HALF_BIG)
    ar = torch.arange(Ae, dtype=torch.int32, device=dev)
    bp_val = torch.where(is_best, ar, Ae + 1).to(torch.int32)
    bp_e = _scatter_min_last(
        torch.full((B, T, S), Ae + 1, dtype=torch.int32, device=dev), e_nxt,
        bp_val)
    bp_e = torch.where(bp_e > Ae, minus1, bp_e)
    bp_e = torch.where(m3, bp_e, minus1)

    arz = torch.arange(Az, dtype=torch.int32, device=dev)
    bp_z = torch.empty((n_eps, B, T, S), dtype=torch.int32, device=dev)
    cur = after
    for r in range(n_eps):
        cz = cur.index_select(2, z_src) + z_cost          # [B, T, Az]
        new = _scatter_min_last(cur, z_nxt, cz)
        dstb = new.index_select(2, z_nxt)
        isb = (cz <= dstb + 1e-6) & (cz < _HALF_BIG) & \
            (cz < cur.index_select(2, z_nxt))
        bv = torch.where(isb, arz, Az + 1).to(torch.int32)
        bz = _scatter_min_last(
            torch.full((B, T, S), Az + 1, dtype=torch.int32, device=dev),
            z_nxt, bv)
        bz = torch.where(bz > Az, minus1, bz)
        bp_z[r] = torch.where(m3, bz, minus1)
        cur = new

    # padded tails: A is identity there, so the prefix-product alpha at
    # T-1 is the last REAL frame's alpha
    state0, cost = _best_end_state(alpha_t[:, -1], final)

    # initial eps-closure records from the bare start state
    a0b = torch.full((B, S), big, device=dev)
    a0b[:, start] = 0.0
    init_bps = torch.empty((n_eps, B, S), dtype=torch.int32, device=dev)
    for r in range(n_eps):
        czi = a0b.index_select(1, z_src) + z_cost
        newi = _scatter_min_last(a0b, z_nxt, czi)
        dstb = newi.index_select(1, z_nxt)
        isb = (czi <= dstb + 1e-6) & (czi < _HALF_BIG) & \
            (czi < a0b.index_select(1, z_nxt))
        bv = torch.where(isb, arz, Az + 1).to(torch.int32)
        bzi = _scatter_min_last(
            torch.full((B, S), Az + 1, dtype=torch.int32, device=dev),
            z_nxt, bv)
        init_bps[r] = torch.where(bzi > Az, minus1, bzi)
        a0b = newi
    return bp_e, bp_z, init_bps, state0, cost


@dataclasses.dataclass(frozen=True)
class DenseDecoderOpts:
    eps_expansions: int | None = None   # None = infer exact eps depth
    acoustic_scale: float = 0.1
    # time-parallel (associative-scan) forward pass when S is small enough
    # that O(B·T·S²) matrices fit comfortably; 0 disables
    assoc_max_states: int = 48
    # >0: checkpointed traceback with this chunk size — the [T,rounds,B,S]
    # backpointer arena becomes O(T/C + C) per (B,S) at ~2x forward
    # compute; enables the dense path on graphs/batches whose full arena
    # would not fit the card (set automatically by make_decoder)
    traceback_chunk: int = 0


class DenseViterbiDecoder:
    """Best-path decoder over the full state space (small graphs), on
    `device` (the card unless the caller asks for "cpu")."""

    def __init__(self, graph: PackedGraph, opts=DenseDecoderOpts(),
                 device="cuda"):
        if graph.pdf is None:
            raise ValueError("PackedGraph has no tid->pdf mapping: the graph "
                             "must carry per-arc pdfs for decoding")
        self.device = dev = resolve_device(device)
        self.graph = graph
        opts = dataclasses.replace(
            opts, eps_expansions=resolve_eps_rounds(graph, opts.eps_expansions))
        self.opts = opts
        il = np.asarray(graph.ilabel)
        emit = il > 0
        src = np.repeat(np.arange(graph.num_states),
                        np.diff(graph.arc_start))
        pdf = np.maximum(graph.pdf, 0)
        z = ~emit
        if z.any():
            z_np = (src[z], graph.nextstate[z],
                    graph.cost[z].astype(np.float32), graph.olabel[z])
        else:
            # a placeholder eps arc of cost BIG that never wins
            z_np = (np.zeros(1, np.int64), np.zeros(1, np.int64),
                    np.full(1, BIG, np.float32), np.zeros(1, np.int64))

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        self._e = (i64(src[emit]), i64(graph.nextstate[emit]),
                   torch.as_tensor(graph.cost[emit].astype(np.float32),
                                   device=dev), i64(pdf[emit]))
        self._z = (i64(z_np[0]), i64(z_np[1]),
                   torch.as_tensor(z_np[2], device=dev))
        self._final = torch.as_tensor(
            np.where(np.isfinite(graph.final), graph.final,
                     BIG).astype(np.float32), device=dev)
        # host label tables for the traceback walk
        self._labels = (src[emit].astype(np.int64),
                        graph.olabel[emit].astype(np.int32),
                        il[emit].astype(np.int32),
                        np.asarray(z_np[0], np.int64),
                        np.asarray(z_np[3], np.int32))
        # incoming-arc gather tables (scatter-free min relaxation)
        S = graph.num_states
        e_dst = np.asarray(graph.nextstate[emit], np.int64)
        self._e_tabs = tuple(i64(a) for a in _incoming_tables(
            e_dst, len(e_dst), S))
        # the placeholder eps arc (no real eps arcs) has cost BIG and
        # must never win: exclude it from the tables by passing A=0
        self._z_tabs = tuple(i64(a) for a in _incoming_tables(
            np.asarray(z_np[1], np.int64) if z.any()
            else np.zeros(0, np.int64), int(z.sum()), S))

    @torch.no_grad()
    def decode_async(self, loglikes, num_frames: np.ndarray):
        """Enqueue the decode on the device and return a finisher callable.

        The finisher makes the one device->host copy of the backpointers
        and walks them on the host. The checkpointed path (traceback_chunk
        > 0 on a graph over assoc_max_states) walks its chunks here, one
        copy each, and its finisher only parses.

        loglikes [B, T, P] unscaled: a tensor (moved to the decoder's
        device) or a numpy array."""
        o = self.opts
        dev = self.device
        ll = torch.as_tensor(loglikes).to(device=dev, dtype=torch.float32)
        B, T, _P = ll.shape
        nf = np.asarray(num_frames)
        S = int(self.graph.num_states)
        n_eps = int(o.eps_expansions)
        start = int(self.graph.start)
        C = int(o.traceback_chunk)
        use_ckpt = C > 0 and S > o.assoc_max_states
        if use_ckpt and T % C:
            pad = C - T % C   # masked pad frames pass alpha/bp through
            ll = torch.cat([ll, ll.new_zeros((B, pad, ll.shape[2]))], dim=1)
            T += pad
        mask = device_mask(nf, T, dev)
        ll = ll * o.acoustic_scale
        if S <= o.assoc_max_states:
            bp_e, bp_z, init_bps, state0, cost = _dense_decode_assoc(
                ll, mask, self._e[0], self._e[1], self._e[2], self._e[3],
                self._z[0], self._z[1], self._z[2], self._final, start, S,
                n_eps)
            # [B, T, S] -> [T, B, S] (fetch_host copies the view in order)
            outs = [bp_e.movedim(1, 0), bp_z.permute(2, 0, 1, 3), init_bps,
                    state0, cost]
        else:
            steps = _build_steps(self._e[0], self._e[2], self._e[3],
                                 self._z[0], self._z[2], self._e_tabs,
                                 self._z_tabs, B, n_eps)
            if use_ckpt:
                res = _dense_decode_ckpt(ll, mask, steps, self._final, start,
                                         S, n_eps, C, self._labels)
                return lambda: parse_label_seqs(*res, nf)
            outs = list(_dense_decode(ll, mask, steps, self._final, start,
                                      S, n_eps))
        labels = self._labels

        def finish():
            bp_e, bp_z, init_bps, state0, cost = fetch_host(outs)
            ols, ils, s_start = _trace_frames(bp_e, bp_z, state0, *labels)
            init_ols = _trace_init(init_bps, s_start, labels[3], labels[4])
            return parse_label_seqs(ols, ils, init_ols, cost, nf)

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()


def make_decoder(graph: PackedGraph, beam_opts=None,
                 dense_threshold: int = 200_000,
                 batch_hint: tuple[int, int] | None = None,
                 arena_budget_bytes: int = 4 << 30, device="cuda"):
    """Pick a decoder on `device`: dense full-state Viterbi when feasible,
    beam search otherwise (all expose .decode/.decode_async).

    The dense path's backpointer arena is [T, eps_rounds+1, B, S] int32,
    so feasibility depends on B*T as much as on S. With batch_hint=(B, T)
    the choice is by ARENA MEMORY against arena_budget_bytes: if the full
    arena fits, plain dense; else a checkpointed traceback chunk size C
    is picked so only O(T/C + C) of the arena is live; only when even that
    fails (or S exceeds dense_threshold) does a beam decoder take over:
    the padded `BeamSearchDecoder`, or the CSR decoder when the padded
    [S, E_max] tables would blow up (S * max out-degree > 32M, or a state
    with over 1024 arcs).
    """
    beam_opts = beam_opts or BeamSearchOpts()
    S = graph.num_states
    rounds = resolve_eps_rounds(graph, beam_opts.eps_expansions) + 1
    if S > dense_threshold:
        padded_cells = S * max(graph.max_out_degree, 1)
        if padded_cells > 32_000_000 or graph.max_out_degree > 1024:
            return CsrBeamDecoder(graph, CsrBeamOpts(
                beam=beam_opts.beam, max_active=beam_opts.max_active,
                acoustic_scale=beam_opts.acoustic_scale,
                eps_expansions=beam_opts.eps_expansions), device=device)
        return BeamSearchDecoder(graph, beam_opts, device=device)
    chunk = 0
    if batch_hint is not None:
        B, T = batch_hint
        per_frame = 4 * rounds * B * S          # bp arena bytes/frame
        if per_frame * T > arena_budget_bytes:
            # checkpoints [T/C, B, S] + live chunk [C, rounds, B, S]
            c = arena_budget_bytes // (2 * max(per_frame, 1))
            chunk = int(min(max(c, 0), 256))
            if chunk < 8:
                return BeamSearchDecoder(graph, beam_opts, device=device)
    return DenseViterbiDecoder(
        graph, DenseDecoderOpts(
            eps_expansions=beam_opts.eps_expansions,
            acoustic_scale=beam_opts.acoustic_scale,
            traceback_chunk=chunk), device=device)
