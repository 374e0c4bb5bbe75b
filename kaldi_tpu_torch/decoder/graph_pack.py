"""CSR packing of decoding graphs into flat arc arrays (host code, numpy).

Copy of the parts of kaldi_tpu/decoder/graph_pack.py that the serving path
needs: `PackedGraph`, `SplitCsr`, `split_csr`, `eps_depth`,
`fold_epsilons`. The original cannot be imported without jax (importing
anything under kaldi_tpu.decoder runs its __init__, which imports the jax
decoders), so it is carried here verbatim; tests hold the two equal array
for array.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PackedGraph:
    """CSR arc table. Emitting arcs (ilabel>0) sorted before eps arcs."""

    arc_start: np.ndarray  # [S+1] int32
    ilabel: np.ndarray     # [A] int32 (transition-ids for HCLG)
    olabel: np.ndarray     # [A] int32 (word ids)
    cost: np.ndarray       # [A] float32 (graph cost)
    nextstate: np.ndarray  # [A] int32
    final: np.ndarray      # [S] float32 (INF if not final)
    start: int
    pdf: np.ndarray | None = None  # [A] int32: pdf per arc (-1 for eps)

    @property
    def num_states(self):
        return len(self.final)

    @property
    def num_arcs(self):
        return len(self.ilabel)

    @property
    def max_out_degree(self):
        return int(np.max(np.diff(self.arc_start))) if self.num_states else 0


@dataclasses.dataclass
class SplitCsr:
    """Emitting / epsilon arc CSR split of a PackedGraph.

    The decode-time layout for production-scale graphs: two flat CSR
    tables per state (emitting arcs, eps arcs) so ProcessEmitting and
    ProcessNonemitting each gather only the arcs they can use — memory
    stays O(arcs) with no [S, E_max] densification (the reference walks
    per-state arc lists the same way, decoder/lattice-faster-decoder.cc
    :660 ProcessEmitting / :750 ProcessNonemitting).
    """

    estart: np.ndarray   # [S+1] int32 — emitting-arc row offsets
    e_tid: np.ndarray    # [Ae] int32 transition-ids (ilabels)
    e_pdf: np.ndarray    # [Ae] int32 pdf per arc
    e_ol: np.ndarray     # [Ae] int32 word olabels
    e_cost: np.ndarray   # [Ae] float32 graph cost
    e_nxt: np.ndarray    # [Ae] int32
    zstart: np.ndarray   # [S+1] int32 — eps-arc row offsets
    z_ol: np.ndarray     # [Az] int32
    z_cost: np.ndarray   # [Az] float32
    z_nxt: np.ndarray    # [Az] int32
    final: np.ndarray    # [S] float32 (BIG-clamped, not inf)
    start: int
    max_olabel: int

    @property
    def num_states(self):
        return len(self.final)


def split_csr(graph: PackedGraph, big: float = 1e10) -> SplitCsr:
    """Vectorized emitting/eps CSR split (no per-state Python loop — a
    10M-arc HCLG must pack in seconds)."""
    S = graph.num_states
    deg = np.diff(graph.arc_start).astype(np.int64)
    src = np.repeat(np.arange(S, dtype=np.int64), deg)
    il = np.asarray(graph.ilabel)
    em = il > 0
    e_idx = np.flatnonzero(em)
    z_idx = np.flatnonzero(~em)
    # arcs are CSR-ordered by source state, so src[e_idx] is nondecreasing
    estart = np.searchsorted(src[e_idx], np.arange(S + 1)).astype(np.int32)
    zstart = np.searchsorted(src[z_idx], np.arange(S + 1)).astype(np.int32)
    if graph.pdf is not None:
        e_pdf = np.maximum(graph.pdf[e_idx], 0).astype(np.int32)
    else:
        e_pdf = np.zeros(len(e_idx), np.int32)
    final = np.where(np.isfinite(graph.final), graph.final,
                     big).astype(np.float32)
    max_ol = int(graph.olabel.max()) if graph.num_arcs else 0
    return SplitCsr(
        estart=estart,
        e_tid=il[e_idx].astype(np.int32),
        e_pdf=e_pdf,
        e_ol=graph.olabel[e_idx].astype(np.int32),
        e_cost=graph.cost[e_idx].astype(np.float32),
        e_nxt=graph.nextstate[e_idx].astype(np.int32),
        zstart=zstart,
        z_ol=graph.olabel[z_idx].astype(np.int32),
        z_cost=graph.cost[z_idx].astype(np.float32),
        z_nxt=graph.nextstate[z_idx].astype(np.int32),
        final=final,
        start=int(graph.start),
        max_olabel=max_ol,
    )


def eps_depth(graph: PackedGraph, cap: int = 8) -> int | None:
    """Longest eps-arc chain (None if cyclic or deeper than `cap`).

    Vectorized fixpoint iteration (np.maximum.at relaxation), O(cap * Az)
    — the Python-adjacency Kahn walk does not scale to multimillion-arc
    graphs. ProcessNonemitting's fixpoint count, made static per graph.
    """
    deg = np.diff(graph.arc_start).astype(np.int64)
    src = np.repeat(np.arange(graph.num_states, dtype=np.int64), deg)
    z = np.asarray(graph.ilabel) == 0
    zsrc, znxt = src[z], np.asarray(graph.nextstate)[z].astype(np.int64)
    if len(zsrc) == 0:
        return 0
    nodes = np.unique(np.concatenate([zsrc, znxt]))
    zsrc = np.searchsorted(nodes, zsrc)
    znxt = np.searchsorted(nodes, znxt)
    depth = np.zeros(len(nodes), np.int64)
    for _ in range(cap + 1):
        new = depth.copy()
        np.maximum.at(new, znxt, depth[zsrc] + 1)
        if np.array_equal(new, depth):
            return int(depth.max())
        depth = new
        if depth.max() > cap:
            return None   # too deep to bound usefully, or cyclic
    return None


def fold_epsilons(graph: PackedGraph,
                  max_growth: float = 2.0) -> PackedGraph | None:
    """Eps-remove a PackedGraph by composing emitting arcs with the eps
    closure of their target states (and closing final weights), so the
    decoder needs NO ProcessNonemitting rounds at all.

    The per-frame eps round costs a frontier-sized row gather plus a
    full dedup+top_k — for typical HCLG the only eps arcs are LM
    backoff arcs (olabel 0, chain depth 1), so the closure fold is
    exact and nearly free in arcs: each arc into a backoff-capable
    state gains one composed twin. Viterbi semantics are preserved
    exactly: a token reaching X could continue through X's eps arcs
    with the same accumulated cost, which is precisely the composed
    arc; per-(X,Y) min-cost closure matches the decoder's best-per-
    state dedup. (ref: ProcessNonemitting fixpoint,
    decoder/lattice-faster-decoder.cc:750; classic eps-removal,
    fstrmepsilon semantics restricted to input-eps arcs.)

    Returns None (caller keeps eps rounds) when the fold is not
    exactly representable or not worth it:
      - eps cycles / depth > 8 (eps_depth returns None),
      - an eps path would stack two nonzero olabels on one arc,
      - a nonzero-olabel eps arc reaches a final state (the word would
        be lost on the final hop),
      - arc growth would exceed `max_growth` x the original count.
    Eps arcs AT the start state (e.g. a real HCLG's <s>-entry arc) fold
    too: the start's eps closure is bridged into direct start arcs.
    """
    il = np.asarray(graph.ilabel)
    S = graph.num_states
    z = il == 0
    nz = int(z.sum())
    if nz == 0:
        return graph
    if eps_depth(graph) is None:
        return None
    deg = np.diff(graph.arc_start).astype(np.int64)
    src = np.repeat(np.arange(S, dtype=np.int64), deg)
    zsrc = src[z]
    znxt = np.asarray(graph.nextstate)[z].astype(np.int64)
    zcost = np.asarray(graph.cost)[z].astype(np.float32)
    zol = np.asarray(graph.olabel)[z].astype(np.int32)
    # eps-arc CSR (zsrc is nondecreasing: arcs are CSR-ordered by source)
    order = np.argsort(zsrc, kind="stable")
    zsrc, znxt, zcost, zol = (zsrc[order], znxt[order], zcost[order],
                              zol[order])
    zs = np.searchsorted(zsrc, np.arange(S + 1))
    zdeg = np.diff(zs)

    # --- closure: all eps paths (x -> y, cost, olabel), then min per (x,y)
    cx, cy, cc, col = zsrc, znxt, zcost, zol
    parts = [(cx, cy, cc, col)]
    cur = (cx, cy, cc, col)
    while True:
        fx, fy, fc, fo = cur
        ext = zdeg[fy] > 0
        if not ext.any():
            break
        fx, fy, fc, fo = fx[ext], fy[ext], fc[ext], fo[ext]
        rep = zdeg[fy]
        nx = np.repeat(fx, rep)
        base = np.repeat(zs[fy], rep)
        within = np.arange(len(base)) - np.repeat(
            np.concatenate([[0], np.cumsum(rep)[:-1]]), rep)
        ai = base + within
        ny, nc = znxt[ai], np.repeat(fc, rep) + zcost[ai]
        po, ao = np.repeat(fo, rep), zol[ai]
        if np.any((po != 0) & (ao != 0)):
            return None                          # two words on one eps path
        no = np.where(po != 0, po, ao)
        cur = (nx, ny, nc.astype(np.float32), no)
        parts.append(cur)
        if sum(len(p[0]) for p in parts) > max_growth * graph.num_arcs:
            return None
    cx = np.concatenate([p[0] for p in parts])
    cy = np.concatenate([p[1] for p in parts])
    cc = np.concatenate([p[2] for p in parts])
    col = np.concatenate([p[3] for p in parts])
    # min-cost entry per (x, y) — matches best-per-state dedup semantics
    key = np.lexsort((cc, cy, cx))
    cx, cy, cc, col = cx[key], cy[key], cc[key], col[key]
    keep = np.concatenate([[True], (cx[1:] != cx[:-1]) | (cy[1:] != cy[:-1])])
    cx, cy, cc, col = cx[keep], cy[keep], cc[keep], col[keep]
    cstart = np.searchsorted(cx, np.arange(S + 1))
    cdeg = np.diff(cstart)

    # --- closed final weights
    final = np.asarray(graph.final).astype(np.float32).copy()
    fy_final = np.isfinite(final[cy])
    if np.any(fy_final & (col != 0)):
        return None                 # word-bearing eps hop into a final state
    np.minimum.at(final, cx[fy_final], cc[fy_final] + final[cy[fy_final]])

    # --- compose each emitting arc with its target's closure
    e = ~z
    e_src = src[e]
    e_il = il[e]
    e_ol = np.asarray(graph.olabel)[e].astype(np.int32)
    e_cost = np.asarray(graph.cost)[e].astype(np.float32)
    e_nxt = np.asarray(graph.nextstate)[e].astype(np.int64)
    e_pdf = (np.asarray(graph.pdf)[e].astype(np.int32)
             if graph.pdf is not None else None)
    rep = cdeg[e_nxt]
    j = np.flatnonzero(rep > 0)
    repj = rep[j]
    if len(j):
        base = np.repeat(cstart[e_nxt[j]], repj)
        within = np.arange(len(base)) - np.repeat(
            np.concatenate([[0], np.cumsum(repj)[:-1]]), repj)
        ci = base + within
        n_ol = col[ci]
        p_ol = np.repeat(e_ol[j], repj)
        if np.any((p_ol != 0) & (n_ol != 0)):
            return None
        new_src = np.repeat(e_src[j], repj)
        new_il = np.repeat(e_il[j], repj)
        new_ol = np.where(p_ol != 0, p_ol, n_ol).astype(np.int32)
        new_cost = (np.repeat(e_cost[j], repj) + cc[ci]) \
            .astype(np.float32)
        new_nxt = cy[ci]
        new_pdf = np.repeat(e_pdf[j], repj) if e_pdf is not None else None
    else:
        new_src = new_il = np.zeros(0, np.int64)
        new_ol = new_nxt = np.zeros(0, np.int32)
        new_cost = np.zeros(0, np.float32)
        new_pdf = np.zeros(0, np.int32) if e_pdf is not None else None
    A_new = len(e_src) + len(new_src)
    if A_new > max_growth * graph.num_arcs:
        return None

    # --- rebuild CSR: original emitting arcs, then composed arcs, grouped
    # by source (stable sort keeps originals first within each state)
    all_src = np.concatenate([e_src, new_src])
    order = np.argsort(all_src, kind="stable")
    all_src = all_src[order]

    def _cat(a, b):
        return np.concatenate([a, b])[order]

    arc_start = np.searchsorted(all_src, np.arange(S + 1)).astype(np.int64)
    f_il = _cat(e_il, new_il).astype(np.int32)
    f_ol = _cat(e_ol, new_ol).astype(np.int32)
    f_cost = _cat(e_cost, new_cost).astype(np.float32)
    f_nxt = _cat(e_nxt, new_nxt).astype(np.int32)
    f_pdf = (_cat(e_pdf, new_pdf).astype(np.int32)
             if e_pdf is not None else None)

    # --- start-state eps bridge: the start's eps closure becomes direct
    # start arcs over the (already folded, eps-free) arc sets of the
    # closure targets, so initial tokens need no eps seeding at all
    s0 = int(graph.start)
    c0 = np.arange(cstart[s0], cstart[s0 + 1])
    if len(c0):
        ys = cy[c0].astype(np.int64)
        rep0 = (arc_start[ys + 1] - arc_start[ys]).astype(np.int64)
        k = np.flatnonzero(rep0 > 0)
        repk = rep0[k]
        base = np.repeat(arc_start[ys[k]], repk)
        within = np.arange(len(base)) - np.repeat(
            np.concatenate([[0], np.cumsum(repk)[:-1]]), repk)
        ai = base + within
        b_pol = np.repeat(col[c0][k], repk)
        if np.any((b_pol != 0) & (f_ol[ai] != 0)):
            return None          # word on the bridge AND on the arc
        b_src = np.full(len(ai), s0, np.int64)
        b_il = f_il[ai]
        b_ol = np.where(b_pol != 0, b_pol, f_ol[ai]).astype(np.int32)
        b_cost = (np.repeat(cc[c0][k], repk) + f_cost[ai]) \
            .astype(np.float32)
        b_nxt = f_nxt[ai]
        b_pdf = f_pdf[ai] if f_pdf is not None else None
        if len(all_src) + len(b_src) > max_growth * graph.num_arcs:
            return None
        all2 = np.concatenate([all_src, b_src])
        order2 = np.argsort(all2, kind="stable")
        all_src = all2[order2]

        def _cat2(a, b):
            return np.concatenate([a, b])[order2]

        arc_start = np.searchsorted(all_src,
                                    np.arange(S + 1)).astype(np.int64)
        f_il = _cat2(f_il, b_il)
        f_ol = _cat2(f_ol, b_ol)
        f_cost = _cat2(f_cost, b_cost)
        f_nxt = _cat2(f_nxt, b_nxt)
        f_pdf = _cat2(f_pdf, b_pdf) if f_pdf is not None else None

    return PackedGraph(
        arc_start=arc_start.astype(np.int32),
        ilabel=f_il,
        olabel=f_ol,
        cost=f_cost,
        nextstate=f_nxt,
        final=final,
        start=int(graph.start),
        pdf=f_pdf,
    )
