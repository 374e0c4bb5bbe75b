"""Batched Viterbi beam search over HCLG with a padded arc table, on tensors.

Counterpart of kaldi_tpu/decoder/beam_search.py (ref:
decoder/lattice-faster-decoder.cc:660-750 ProcessEmitting,
ProcessNonemitting, GetCutoff :591). The frontier is a fixed-capacity
(max_active = K) tensor of (state, score, back-pointer slot); per frame:

  1. expand every arc of every frontier token with one gather per field
     from [S, E] tables (each state's arcs, emitting first, padded to the
     graph's max out-degree E);
  2. cut candidates worse than the round's best + beam;
  3. keep the best candidate per target state, then the K best overall
     (`_dedup_prune`, the hash-free FindOrAddToken + GetCutoff);
  4. repeat 1-3 over epsilon arcs, tokens carrying themselves over
     (prev = self, olabel 0), for the non-emitting closure;
  5. record (state, score, prev slot, olabel, ilabel) per round.

What changes with the framework: JAX's `lax.scan` over frames is a Python
loop that enqueues device work without synchronising, its `vmap` over
utterances a batch dimension [B, ...]; the two stable argsorts of
`_dedup_prune` are one stable sort of an int64 (state, score) key and its
`lax.top_k` a stable ascending sort cut to K (ties to the lowest index,
signed zeros made equal), as in the port's CSR decoder. The tables live on
the decoder's device (the card unless the caller asks for "cpu"); the
acoustic lookup indexes the frame's log-likelihoods plainly, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.decoder.csr_beam import (_HALF_BIG, BIG, _f32_sort_key,
                                              _sort_order, resolve_eps_rounds)
from kaldi_tpu_torch.decoder.graph_pack import PackedGraph, split_csr
from kaldi_tpu_torch.decoder.hostpack import (device_mask, fetch_host,
                                              parse_label_seqs)
from kaldi_tpu_torch.device import resolve_device

FIELDS = ("ilabel", "olabel", "cost", "nxt", "pdf")


@dataclasses.dataclass(frozen=True)
class BeamSearchOpts:
    """(ref: decoder/faster-decoder.h:26-50 FasterDecoderOptions)"""

    beam: float = 16.0
    max_active: int = 512       # frontier capacity K (tokens kept per frame)
    # ProcessNonemitting rounds. None = infer the exact eps-chain depth from
    # the graph; construction fails if the eps subgraph is cyclic or
    # unboundedly deep
    eps_expansions: int | None = None
    acoustic_scale: float = 0.1


def _pad_csr(graph: PackedGraph):
    """Pack per-state arc lists into dense [S, E] tables, emitting-first:
    arc a of state s lands at row s, column a - arc_start[s]."""
    S = graph.num_states
    deg = np.diff(graph.arc_start)
    E = int(deg.max()) if S else 1
    A = len(graph.ilabel)
    rows = np.repeat(np.arange(S), deg)
    cols = np.arange(A) - np.repeat(graph.arc_start[:-1], deg)
    ilabel = np.zeros((S, E), np.int32)
    olabel = np.zeros((S, E), np.int32)
    cost = np.full((S, E), BIG, np.float32)
    nxt = np.zeros((S, E), np.int32)
    pdf = np.zeros((S, E), np.int32)
    ilabel[rows, cols] = graph.ilabel
    olabel[rows, cols] = graph.olabel
    cost[rows, cols] = graph.cost
    nxt[rows, cols] = graph.nextstate
    if graph.pdf is not None:
        pdf[rows, cols] = np.maximum(graph.pdf, 0)
    return dict(ilabel=ilabel, olabel=olabel, cost=cost, nxt=nxt, pdf=pdf,
                max_deg=E)


def _f32_total_key(x: torch.Tensor) -> torch.Tensor:
    """An int64 key in [0, 2^32) that orders f32 values with -0.0 below
    +0.0, as XLA's TopK compares them."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u + 0x80000000)


def _dedup_prune(states, scores, prevs, olabels, ilabels, K: int):
    """Keep the best-scoring candidate per state, then the best K overall.

    All inputs [B, N] (N >= K); dead candidates score >= BIG/2. -> five
    [B, K] tensors. JAX's two stable argsorts (by score, then by state)
    are one stable sort of the key state * 2^32 + (order-preserving score
    bits): the same groups, each best-first, ties in candidate order. The
    first of each group then competes in a stable ascending sort of the
    masked scores cut to K, which is `lax.top_k`'s order: ties to the
    lowest index, and -0.0 before +0.0 (the first sort, as JAX's argsort,
    takes them as equal; top_k does not)."""
    order = _sort_order(states.to(torch.int64) * (1 << 32)
                        + _f32_sort_key(scores))
    st_g = torch.gather(states, 1, order)
    sc_g = torch.gather(scores, 1, order)
    first = torch.ones_like(st_g, dtype=torch.bool)
    first[:, 1:] = st_g[:, 1:] != st_g[:, :-1]
    sc_masked = torch.where(first, sc_g, float(BIG))
    topi = _sort_order(_f32_total_key(sc_masked))[:, :K]
    sel = torch.gather(order, 1, topi)
    return (torch.gather(states, 1, sel),
            torch.clamp(torch.gather(sc_masked, 1, topi), max=float(BIG)),
            torch.gather(prevs, 1, sel), torch.gather(olabels, 1, sel),
            torch.gather(ilabels, 1, sel))


def _padded_rounds(tabs: dict, K: int, n_eps: int, beam: float):
    """-> (frame_step, closure) over the [S, E] tables for a [B, K]
    frontier (the per-frame program of JAX's `_decode_batch`, shared by
    the offline, chunked and fused decoders).

    frame_step(st, sc, frame_ll [B, P]) and closure(st, sc) each return
    (st, sc, records): one (st, sc, prev, olabel, ilabel) tuple of [B, K]
    tensors per round. The closure is the start state's eps closure:
    n_eps eps rounds without the beam cut, as JAX runs them."""
    ilabel, olabel, cost, nxt, pdf = (tabs[f] for f in FIELDS)
    E = ilabel.shape[1]
    dev = ilabel.device

    def expand(st, sc, frame_ll, emitting):
        B = st.shape[0]
        idx = st.reshape(-1).long()

        def rows(t):
            return t.index_select(0, idx).view(B, K, E)

        arcs_i, arcs_o, arcs_c, arcs_n = (rows(ilabel), rows(olabel),
                                          rows(cost), rows(nxt))
        if emitting:
            am = -torch.gather(frame_ll, 1,
                               rows(pdf).view(B, K * E).long()).view(B, K, E)
            use = arcs_i > 0
        else:
            am = torch.zeros_like(arcs_c)
            use = arcs_i == 0
        cand = torch.where(use, sc[:, :, None] + arcs_c + am, float(BIG))
        prev = torch.arange(K, dtype=torch.int32, device=dev)[None, :, None] \
            .expand(B, K, E)
        return (arcs_n.reshape(B, -1), cand.reshape(B, -1),
                prev.reshape(B, -1), arcs_o.reshape(B, -1),
                arcs_i.reshape(B, -1))

    def beam_cut(scores):
        best = torch.amin(scores, dim=1, keepdim=True)
        return torch.clamp(torch.where(scores > best + beam, float(BIG),
                                       scores), max=float(BIG))

    def eps_round(st, sc, cut):
        B = st.shape[0]
        est, esc, epv, eol, eil = expand(st, sc, None, False)
        ident = torch.arange(K, dtype=torch.int32,
                             device=dev)[None].expand(B, K)
        zero = torch.zeros((B, K), dtype=torch.int32, device=dev)
        msc = torch.cat([sc, esc], dim=1)
        if cut:
            msc = beam_cut(msc)
        return _dedup_prune(torch.cat([st, est], dim=1), msc,
                            torch.cat([ident, epv], dim=1),
                            torch.cat([zero, eol], dim=1),
                            torch.cat([zero, eil], dim=1), K)

    def frame_step(st, sc, frame_ll):
        cst, csc, cpv, col, cil = expand(st, sc, frame_ll, True)
        rec = _dedup_prune(cst, beam_cut(csc), cpv, col, cil, K)
        records = [rec]
        for _ in range(n_eps):
            rec = eps_round(rec[0], rec[1], cut=True)
            records.append(rec)
        return rec[0], rec[1], records

    def closure(st, sc):
        records = []
        for _ in range(n_eps):
            rec = eps_round(st, sc, cut=False)
            st, sc = rec[0], rec[1]
            records.append(rec)
        return st, sc, records

    return frame_step, closure


def _start(B: int, K: int, start: int, dev):
    st = torch.zeros((B, K), dtype=torch.int32, device=dev)
    st[:, 0] = start
    sc = torch.full((B, K), float(BIG), dtype=torch.float32, device=dev)
    sc[:, 0] = 0.0
    return st, sc


def _decode_batch(ll, frame_mask, rounds, start: int, final, K: int,
                  raw: bool):
    """The frame loop of JAX's `_decode_batch` over ll [B, T, P] (scaled)
    and frame_mask [B, T]; masked frames keep their tokens and record
    self-links. raw=True keeps every round's (state, score) snapshot for
    lattice generation, else the (prev, olabel, ilabel) back-pointers.

    -> (init [R0, 2, B, K], recs [T, R, 2 or 3, B, K], final states [B,
    K], final scores [B, K], best slot [B], best cost [B]); the snapshots
    hold states and score bits as int32."""
    frame_step, closure = rounds
    B, T, _P = ll.shape
    dev = ll.device
    st, sc, init = closure(*_start(B, K, start, dev))
    init = (torch.stack([torch.stack([r[0], r[1].view(torch.int32)])
                         if raw else torch.stack([r[2], r[3]])
                         for r in init])
            if init else torch.zeros((0, 2, B, K), dtype=torch.int32,
                                     device=dev))
    R = 1
    recs = None
    ident = torch.arange(K, dtype=torch.int32, device=dev)[None].expand(B, K)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ll_t = ll.transpose(0, 1).contiguous()
    mask_t = frame_mask.transpose(0, 1).contiguous()
    for t in range(T):
        m = mask_t[t][:, None]
        st2, sc2, records = frame_step(st, sc, ll_t[t])
        if recs is None:
            R = len(records)
            recs = torch.empty((T, R, 2 if raw else 3, B, K),
                               dtype=torch.int32, device=dev)
        for r, (r_st, r_sc, r_pv, r_ol, r_il) in enumerate(records):
            out = recs[t, r]
            if raw:
                torch.where(m, r_st, st, out=out[0])
                torch.where(m, r_sc, sc, out=out[1].view(torch.float32))
            else:
                torch.where(m, r_pv, ident, out=out[0])
                torch.where(m, r_ol, zero, out=out[1])
                torch.where(m, r_il, zero, out=out[2])
        st = torch.where(m, st2, st)
        sc = torch.where(m, sc2, sc)
    if recs is None:
        recs = torch.zeros((0, 1, 2 if raw else 3, B, K), dtype=torch.int32,
                           device=dev)
    total = sc + final[st.long()]
    best_final_slot = torch.argmin(total, dim=1)
    best_final_cost = torch.gather(total, 1, best_final_slot[:, None])[:, 0]
    # fallback: the best partial path when the beam pruned every final
    # token (ref: decoder-wrappers.cc "No final token found")
    best_any_slot = torch.argmin(sc, dim=1)
    reached = best_final_cost < _HALF_BIG
    best_slot = torch.where(reached, best_final_slot, best_any_slot)
    best_cost = torch.where(
        reached, best_final_cost,
        torch.gather(sc, 1, best_any_slot[:, None])[:, 0])
    return init, recs, st, sc, best_slot, best_cost


def _traceback(recs, init, best_slot):
    """Walk the back-pointers from best_slot on the device, frame by frame
    and round by round backwards (JAX's `_decode_batch_traced`), then
    through the init closure. recs [T, R, 3, B, K] (prev, olabel, ilabel),
    init [R0, 2, B, K] (prev, olabel). -> (olabels [B, T, R], ilabels
    [B, T, R], init olabels [B, R0])."""
    T, R, _three, B, _K = recs.shape
    R0 = init.shape[0]
    dev = recs.device
    out = torch.empty((T, R, 3, B), dtype=torch.int32, device=dev)
    s = best_slot.view(1, B, 1)
    for f in range(T - 1, -1, -1):
        for r in range(R - 1, -1, -1):
            g = torch.gather(recs[f, r], 2, s.expand(3, B, 1))[:, :, 0]
            out[f, r] = g
            s = g[0].long().view(1, B, 1)
    init_ols = torch.empty((R0, B), dtype=torch.int32, device=dev)
    for r in range(R0 - 1, -1, -1):
        g = torch.gather(init[r], 2, s.expand(2, B, 1))[:, :, 0]
        init_ols[r] = g[1]
        s = g[0].long().view(1, B, 1)
    return (out[:, :, 1].permute(2, 0, 1), out[:, :, 2].permute(2, 0, 1),
            init_ols.T)


class BeamSearchDecoder:
    """Host wrapper: pack the graph once onto `device` (the card unless the
    caller asks for "cpu"), decode utterance batches there."""

    def __init__(self, graph: PackedGraph,
                 opts: BeamSearchOpts = BeamSearchOpts(), device="cuda"):
        if graph.pdf is None:
            raise ValueError("PackedGraph has no tid->pdf mapping: the graph "
                             "must carry per-arc pdfs for decoding")
        self.device = resolve_device(device)
        self.graph = graph
        opts = dataclasses.replace(
            opts, eps_expansions=resolve_eps_rounds(graph,
                                                    opts.eps_expansions))
        self.opts = opts
        tabs = _pad_csr(graph)
        self.E = tabs.pop("max_deg")
        self._tabs_np = tabs                  # host copy (OnlineDecoder init)
        self._tabs = {k: torch.as_tensor(v, device=self.device)
                      for k, v in tabs.items()}
        self._final_np = np.where(np.isfinite(graph.final), graph.final,
                                  BIG).astype(np.float32)
        self._final = torch.as_tensor(self._final_np, device=self.device)
        self.csr = split_csr(graph)   # host CSR for lattice extraction
        self._rounds = _padded_rounds(self._tabs, int(opts.max_active),
                                      int(opts.eps_expansions),
                                      float(opts.beam))

    def _run(self, ll_scaled, num_frames, raw: bool):
        ll = torch.as_tensor(ll_scaled).to(device=self.device,
                                           dtype=torch.float32)
        mask = device_mask(np.asarray(num_frames), ll.shape[1], self.device)
        return _decode_batch(ll, mask, self._rounds, int(self.graph.start),
                             self._final, int(self.opts.max_active), raw)

    @torch.no_grad()
    def decode_raw(self, loglikes, num_frames: np.ndarray):
        """Decode with every round's frontier snapshot, fetched in one copy:
        the dict consumed by lat.generate.raw_lattice_from_decode."""
        if torch.is_tensor(loglikes):
            loglikes = loglikes.detach().cpu().numpy()
        ll_scaled = np.asarray(loglikes, np.float32) * self.opts.acoustic_scale
        init, recs, fs, fsc, best_slot, best_cost = self._run(
            ll_scaled, num_frames, raw=True)
        init, recs, fs, fsc, best_slot, best_cost = fetch_host(
            [init, recs, fs, fsc, best_slot, best_cost])
        return dict(
            init_states=init[:, 0].transpose(1, 0, 2),          # [B, R0, K]
            init_scores=init[:, 1].transpose(1, 0, 2).view(np.float32),
            states=recs[:, :, 0].transpose(2, 0, 1, 3),         # [B, T, R, K]
            scores=recs[:, :, 1].transpose(2, 0, 1, 3).view(np.float32),
            final_states=fs, final_scores=fsc,
            best_slot=best_slot, best_cost=best_cost,
            ll_scaled=ll_scaled)

    @torch.no_grad()
    def decode_async(self, loglikes, num_frames: np.ndarray):
        """Enqueue the decode and its on-device traceback; -> a finisher
        producing per-utterance (words, tids, total_cost) or None, with one
        device->host copy of the [B, T, R] label sequences.

        loglikes [B, T, P] unscaled: a tensor (moved to the decoder's
        device) or a numpy array."""
        ll = torch.as_tensor(loglikes).to(device=self.device,
                                          dtype=torch.float32)
        init, recs, _fs, _fsc, best_slot, best_cost = self._run(
            ll * self.opts.acoustic_scale, num_frames, raw=False)
        outs = list(_traceback(recs, init, best_slot)) + [best_cost]
        nf = np.asarray(num_frames)

        def finish():
            return parse_label_seqs(*fetch_host(outs), nf)

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()
