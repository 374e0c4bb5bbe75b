"""Raw-lattice generation from the port's CSR decoder records
(kaldi_tpu/lat/generate.py counterpart).

(ref: decoder/lattice-faster-decoder.cc:109 GetRawLattice — Tokens become
lattice states, ForwardLinks become arcs. The decoder records every
round's token frontier (state, score); here ALL links within
lattice-beam are rebuilt — not just the Viterbi back-pointer — by
re-expanding each round's predecessor tokens through the CSR arc tables.
A link into token k whose candidate score exceeds score(k) + lattice_beam
cannot lie on any path within lattice_beam of the best, so it is dropped:
the guarantee of the reference's PruneForwardLinks.)

The numpy extraction (`use_native=False`) is the semantic reference; the
native one (lat/native_gen.py) is the throughput path and raises when its
library cannot be built. Both take the records as host numpy arrays.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.lat import native_gen
from kaldi_tpu_torch.lat.functions import prune_lattice
from kaldi_tpu_torch.lat.lattice import Lattice

BIG = 1e10


def _frontier_expand(csr, ps, base, alive, emitting, ll_t=None):
    """Vectorized CSR expansion of one frontier.

    ps/base/alive: [K] states, scores, liveness. -> dict of flat arrays
    (tok) source slot, (state) target, (cand) candidate cost, (il/ol/gc/ac).
    """
    if emitting:
        start, nxt = csr.estart, csr.e_nxt
    else:
        start, nxt = csr.zstart, csr.z_nxt
    a0 = start[ps].astype(np.int64)
    deg = (start[ps + 1] - start[ps]).astype(np.int64)
    deg = np.where(alive, deg, 0)
    total = int(deg.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return dict(tok=z, state=z, cand=np.zeros(0), il=z, ol=z,
                    gc=np.zeros(0, np.float32), ac=np.zeros(0, np.float32))
    off = np.cumsum(deg) - deg
    tok = np.repeat(np.arange(len(ps)), deg)
    arc = a0.repeat(deg) + (np.arange(total) - off.repeat(deg))
    if emitting:
        gc = csr.e_cost[arc]
        ac = -ll_t[csr.e_pdf[arc]]
        il = csr.e_tid[arc].astype(np.int64)
        ol = csr.e_ol[arc].astype(np.int64)
    else:
        gc = csr.z_cost[arc]
        ac = np.zeros(total, np.float32)
        il = np.zeros(total, np.int64)
        ol = csr.z_ol[arc].astype(np.int64)
    cand = base[tok] + gc + ac
    return dict(tok=tok, state=nxt[arc].astype(np.int64), cand=cand,
                il=il, ol=ol, gc=gc, ac=ac)


def _slot_of(cur_states, cur_scores, alive, query):
    """Map target states -> best frontier slot holding that state."""
    order = np.lexsort((cur_scores, cur_states))
    sorted_states = cur_states[order]
    pos = np.searchsorted(sorted_states, query)
    pos = np.minimum(pos, len(sorted_states) - 1)
    slot = order[pos]
    ok = (cur_states[slot] == query) & alive[slot]
    return slot, ok


def raw_lattice_from_decode(
    dec,                    # CsrBeamDecoder
    raw: dict,              # output of dec.decode_raw(...)
    num_frames,
    b: int,
    lattice_beam: float = 10.0,
    use_native: bool = True,
) -> Lattice | None:
    """Utterance b's lattice, beam-pruned and connected; None when the
    decode failed or nothing survives."""
    csr = dec.csr
    final = csr.final
    Tb = int(num_frames[b])
    if raw["best_cost"][b] >= BIG * 0.5:
        return None

    if use_native:
        # the native extractor beam-prunes, connects and renumbers on
        # flat arrays before any Python objects exist
        n_nodes, src, il, ol, gc, ac, dst, fn, fc = native_gen.extract_native(
            csr, raw, b, Tb, lattice_beam)
        if len(src) == 0 or len(fn) == 0:
            return None
        return Lattice.from_arrays(
            n_nodes, src, il, ol, gc, ac, dst, start=0,
            finals={int(n): (float(c), 0.0) for n, c in zip(fn, fc)})
    K = raw["states"].shape[-1]
    R0 = raw["init_states"].shape[1]
    R = raw["states"].shape[2]
    ll = raw["ll_scaled"][b]

    # round sequence: R0 init eps rounds, then per frame emit + eps rounds
    def round_frontier(ri):
        if ri < R0:
            return (raw["init_states"][b, ri].astype(np.int64),
                    raw["init_scores"][b, ri].astype(np.float64))
        t, r = divmod(ri - R0, R)
        return (raw["states"][b, t, r].astype(np.int64),
                raw["scores"][b, t, r].astype(np.float64))

    n_rounds = R0 + Tb * R
    tol = lattice_beam + 1e-4

    # node ids per (round, slot); -1 = unreached
    prev_states = np.zeros(K, np.int64)
    prev_scores = np.full(K, BIG)
    prev_states[0] = csr.start
    prev_scores[0] = 0.0
    prev_nodes = np.full(K, -1, np.int64)
    prev_nodes[0] = 0
    n_nodes = 1

    arc_src: list[np.ndarray] = []
    arc_il: list[np.ndarray] = []
    arc_ol: list[np.ndarray] = []
    arc_gc: list[np.ndarray] = []
    arc_ac: list[np.ndarray] = []
    arc_dst: list[np.ndarray] = []

    for ri in range(n_rounds):
        cur_states, cur_scores = round_frontier(ri)
        cur_alive = cur_scores < BIG * 0.5
        emitting = ri >= R0 and (ri - R0) % R == 0
        t = (ri - R0) // R if ri >= R0 else 0
        p_alive = (prev_scores < BIG * 0.5) & (prev_nodes >= 0)

        ex = _frontier_expand(csr, prev_states, prev_scores, p_alive,
                              emitting, ll[t] if emitting else None)
        slot, ok = _slot_of(cur_states, cur_scores, cur_alive, ex["state"])
        keep = ok & (ex["cand"] <= cur_scores[slot] + tol)

        segs = [(ex["tok"][keep], slot[keep], ex["il"][keep],
                 ex["ol"][keep], ex["gc"][keep], ex["ac"][keep])]
        if not emitting:
            # identity carry-over: prev token -> same-state cur token
            cslot, cok = _slot_of(cur_states, cur_scores, cur_alive,
                                  prev_states)
            ckeep = cok & p_alive & (prev_scores
                                     <= cur_scores[cslot] + tol)
            toks = np.flatnonzero(ckeep)
            segs.append((toks, cslot[toks],
                         np.zeros(len(toks), np.int64),
                         np.zeros(len(toks), np.int64),
                         np.zeros(len(toks), np.float32),
                         np.zeros(len(toks), np.float32)))

        # rounds may differ in width (flat records beside rec_cap-wide
        # init snapshots), so size the node map by this round's
        cur_nodes = np.full(len(cur_states), -1, np.int64)
        used = np.unique(np.concatenate([s[1] for s in segs])) \
            if any(len(s[0]) for s in segs) else np.zeros(0, np.int64)
        cur_nodes[used] = n_nodes + np.arange(len(used))
        n_nodes += len(used)

        for (tk, sl, il, ol, gc, ac) in segs:
            if len(tk) == 0:
                continue
            arc_src.append(prev_nodes[tk])
            arc_il.append(il)
            arc_ol.append(ol)
            arc_gc.append(gc)
            arc_ac.append(ac)
            arc_dst.append(cur_nodes[sl])

        prev_states, prev_scores, prev_nodes = (cur_states, cur_scores,
                                                cur_nodes)

    if not arc_src:
        return None
    finals_slots = np.flatnonzero(
        (prev_nodes >= 0) & (final[np.minimum(prev_states,
                                              len(final) - 1)] < BIG * 0.5))
    if finals_slots.size:
        finals = {int(prev_nodes[s]): (float(final[prev_states[s]]), 0.0)
                  for s in finals_slots}
    else:
        # no token reached a final state: keep all end tokens final with
        # zero cost — the decoder's best-partial fallback semantics
        # (ref: decoder-wrappers.cc "No final token found";
        #  GetRawLattice with use_final_probs=false)
        finals = {int(prev_nodes[s]): (0.0, 0.0)
                  for s in np.flatnonzero(prev_nodes >= 0)}
    lat = Lattice.from_arrays(
        n_nodes,
        np.concatenate(arc_src), np.concatenate(arc_il),
        np.concatenate(arc_ol), np.concatenate(arc_gc),
        np.concatenate(arc_ac), np.concatenate(arc_dst),
        start=0,
        finals=finals)
    lat.connect()
    if lat.start < 0:
        return None
    return prune_lattice(lat, lattice_beam)


def decode_to_lattices(dec, loglikes, num_frames, lattice_beam: float = 10.0,
                       num_threads: int = 4):
    """Batch decode -> list of raw lattices (None where decoding failed).

    (the tensor analogue of gmm-latgen-faster's per-utterance
    GetRawLattice + lattice-beam pruning; per-utterance extraction runs
    on a thread pool — the native extractor releases the GIL during the
    C call, so utterances extract in parallel like the reference's
    TaskSequencer in gmm-latgen-faster-parallel)
    """
    raw = dec.decode_raw(loglikes, num_frames)
    B = loglikes.shape[0]
    if B == 1 or num_threads <= 1:
        return [raw_lattice_from_decode(dec, raw, num_frames, b,
                                        lattice_beam) for b in range(B)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        return list(ex.map(
            lambda b: raw_lattice_from_decode(dec, raw, num_frames, b,
                                              lattice_beam), range(B)))


def decode_to_lattices_stream(dec, batches, lattice_beam: float = 10.0,
                              num_threads: int = 4, depth: int = 2):
    """Pipelined latgen over a stream of (loglikes, num_frames) batches;
    yields one lattice list per batch, in order.

    The pipeline is the reference's (ref:
    gmmbin/gmm-latgen-faster-parallel.cc:35 TaskSequencer): a depth-2
    queue of `decode_raw_async` finishers, and a thread pool that
    extracts each finished batch's utterances. In the port the frame
    loop's enqueue runs in the calling thread, so the overlap is the main
    thread enqueueing a later batch's frames (the device running behind
    it) while the native extractions of batch i run on the pool with the
    GIL released; each finisher's one device->host copy blocks the main
    thread only until that batch's device work is done."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    it = iter(batches)
    pending: deque = deque()          # (finisher, num_frames)

    def refill():
        while len(pending) < depth:
            try:
                ll, nf = next(it)
            except StopIteration:
                return
            pending.append((dec.decode_raw_async(ll, np.asarray(nf)),
                            np.asarray(nf)))

    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        refill()
        prev_futs = None
        while pending:
            fin, nf = pending.popleft()
            raw = fin()               # blocking copy; the device runs ahead
            futs = [ex.submit(raw_lattice_from_decode, dec, raw, nf, b,
                              lattice_beam) for b in range(len(nf))]
            refill()                  # enqueued while batch i extracts
            if prev_futs is not None:
                yield [f.result() for f in prev_futs]
            prev_futs = futs
        if prev_futs is not None:
            yield [f.result() for f in prev_futs]
