"""Production-scale HCLG builds over FlatFst arrays.

The full mkgraph pipeline (ref: egs/wsj/s5/utils/mkgraph.sh:64-104)
  L∘G -> determinize*(log) -> C (context relabel) -> Ha∘CLG ->
  determinize*(log) -> rm-disambig -> add-self-loops -> connect
with the two hot stages (composition, determinization) in native C++
(native/fst_ops.cc) and everything else vectorized numpy — no per-arc
Python objects anywhere, so a 60k-word-vocab graph with millions of
arcs builds in seconds instead of hours. The Fst-object pipeline in
fst/graph.py (make_hclg) is the semantic reference at yesno scale;
tests/test_mkgraph_flat.py asserts both produce equivalent graphs.

The port's copy of kaldi_tpu/fst/mkgraph_flat.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from kaldi_tpu_torch.fst.fst import EPS
from kaldi_tpu_torch.fst.flat import FlatFst, remove_symbols_flat, BIG
from kaldi_tpu_torch.fst import native_ops


def add_self_loops_flat(f: FlatFst, trans_model, disambig_tids=(),
                        self_loop_scale: float = 1.0) -> FlatFst:
    """Vectorized AddSelfLoops, reorder=True (ref: hmm/hmm-utils.cc:573
    AddSelfLoops + fstext-utils-inl.h MakePrecedingInputSymbolsSameClass
    with start_is_epsilon; semantics identical to
    fst/hmm_graph.py:add_self_loops)."""
    tm = trans_model
    n_ts = len(tm.id2state) and int(tm.id2state.max())
    # per-transition-state tables (tiny: one entry per HMM state)
    scale_cost = np.zeros(n_ts + 1, np.float32)
    sl_tid = np.zeros(n_ts + 1, np.int32)
    sl_cost = np.zeros(n_ts + 1, np.float32)
    for ts in range(1, n_ts + 1):
        scale_cost[ts] = -tm.non_self_loop_log_prob(ts) * self_loop_scale
        t = tm.self_loop_of(ts)
        sl_tid[ts] = t
        if t:
            sl_cost[ts] = -float(tm.log_probs[t]) * self_loop_scale

    # arc class: transition-state of the ilabel (0 for eps/disambig)
    id2state = np.zeros(int(f.il.max(initial=0)) + 1, np.int32)
    m = min(len(id2state), len(tm.id2state))
    id2state[:m] = tm.id2state[:m]
    dset = np.asarray(sorted(int(t) for t in disambig_tids), np.int32)
    acls = np.where(f.il == 0, 0, id2state[f.il])
    if len(dset):
        acls = np.where(np.isin(f.il, dset), 0, acls)

    S = f.num_states
    C = n_ts + 1
    # incoming (state, class) pairs; the start state is virtually entered
    # by epsilon (class 0)
    keys = f.dst.astype(np.int64) * C + acls
    keys = np.unique(np.concatenate([keys, [np.int64(f.start) * C]]))
    kstate = (keys // C).astype(np.int64)
    kcls = (keys % C).astype(np.int32)
    first = np.concatenate([[True], kstate[1:] != kstate[:-1]])
    # primary (first class) keeps the original id; the rest duplicate
    n_dup = int((~first).sum())
    new_id = np.empty(len(keys), np.int64)
    new_id[first] = kstate[first]
    new_id[~first] = S + np.arange(n_dup)
    dup_src = kstate[~first]            # original state each dup copies

    # duplicate outgoing arcs + finals of dup states
    a0 = f.arc_start[dup_src]
    deg = (f.arc_start[dup_src + 1] - a0).astype(np.int64)
    tot = int(deg.sum())
    off = np.cumsum(deg) - deg
    didx = a0.repeat(deg) + (np.arange(tot) - off.repeat(deg))
    src_all = np.concatenate([
        np.repeat(np.arange(S, dtype=np.int64), np.diff(f.arc_start)),
        np.repeat(new_id[~first], deg)])
    il_all = np.concatenate([f.il, f.il[didx]])
    ol_all = np.concatenate([f.ol, f.ol[didx]])
    w_all = np.concatenate([f.w, f.w[didx]]).astype(np.float32)
    dst_all = np.concatenate([f.dst, f.dst[didx]])
    acls_all = np.concatenate([acls, acls[didx]])
    final = np.concatenate([f.final, f.final[dup_src]])
    Sn = S + n_dup

    # retarget every arc to the (dst, class) duplicate
    dst_all = new_id[np.searchsorted(keys,
                                     dst_all.astype(np.int64) * C + acls_all)]

    # state class (the unique incoming class after duplication)
    state_cls = np.zeros(Sn, np.int32)
    state_cls[new_id] = kcls

    # scale outgoing arcs + finals of class>0 states; append self-loops
    sc = scale_cost[state_cls]
    w_all = w_all + sc[src_all]
    alive = final < BIG * 0.5
    final = np.where(alive, final + sc, final).astype(np.float32)
    loop_states = np.flatnonzero((state_cls > 0) & (sl_tid[state_cls] > 0))
    ts_l = state_cls[loop_states]
    src_all = np.concatenate([src_all, loop_states])
    il_all = np.concatenate([il_all, sl_tid[ts_l]])
    ol_all = np.concatenate([ol_all, np.zeros(len(loop_states), np.int32)])
    w_all = np.concatenate([w_all, sl_cost[ts_l]]).astype(np.float32)
    dst_all = np.concatenate([dst_all, loop_states])

    # regroup by source (stable, preserving original arc order per state)
    order = np.argsort(src_all, kind="stable")
    counts = np.bincount(src_all, minlength=Sn)
    arc_start = np.zeros(Sn + 1, np.int64)
    np.cumsum(counts, out=arc_start[1:])
    return FlatFst(arc_start, il_all[order].astype(np.int32),
                   ol_all[order].astype(np.int32), w_all[order],
                   dst_all[order].astype(np.int32), final, int(f.start))


def pack_graph_flat(f: FlatFst, tid_to_pdf: np.ndarray | None = None):
    """FlatFst -> PackedGraph (decoder input), vectorized: per-state arcs
    ordered emitting-then-eps by ilabel (pack_graph's convention)."""
    from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
    src = np.repeat(np.arange(f.num_states, dtype=np.int64),
                    np.diff(f.arc_start))
    order = np.lexsort((f.il, (f.il == 0), src))
    il = f.il[order]
    final = np.where(f.final < BIG * 0.5, f.final,
                     np.float32(np.inf)).astype(np.float32)
    pdf = None
    if tid_to_pdf is not None:
        pdf = np.where(il > 0, tid_to_pdf[np.maximum(il, 0)],
                       -1).astype(np.int32)
    return PackedGraph(
        arc_start=f.arc_start.astype(np.int32),
        ilabel=il.astype(np.int32),
        olabel=f.ol[order].astype(np.int32),
        cost=f.w[order].astype(np.float32),
        nextstate=f.dst[order].astype(np.int32),
        final=final, start=int(f.start), pdf=pdf)


def make_hclg_flat(lang, g, trans_model, ctx_dep,
                   transition_scale: float = 1.0,
                   self_loop_scale: float = 0.1,
                   verbose: bool = False):
    """Full HCLG build over flat arrays with native compose/det*.

    -> (FlatFst hclg, stats dict). Mono AND N-phone context (triphone
    CLG via the native on-the-fly context composition).
    """
    import time
    from kaldi_tpu_torch.fst.hmm_graph import make_h_transducer

    def log(msg):
        # stderr: callers (bench.py) reserve stdout for their JSON line
        if verbose:
            print(msg, flush=True, file=sys.stderr)

    stats = {}
    t0 = time.time()
    L = FlatFst.from_fst(lang.L_disambig)
    G = g if isinstance(g, FlatFst) else FlatFst.from_fst(g)
    lg = native_ops.compose_flat(L, G)
    stats["lg_arcs"] = lg.num_arcs
    log(f"L({L.num_states}/{L.num_arcs}) o G({G.num_states}/{G.num_arcs})"
        f" = LG {lg} [{time.time()-t0:.1f}s]")
    t0 = time.time()
    lg = native_ops.determinize_star_flat(lg, use_log=True)
    stats["lg_det_arcs"] = lg.num_arcs
    log(f"det(LG) = {lg} [{time.time()-t0:.1f}s]")
    t0 = time.time()
    lg = native_ops.minimize_encoded_flat(lg)
    stats["lg_min_arcs"] = lg.num_arcs
    log(f"min(LG) = {lg} [{time.time()-t0:.1f}s]")

    # context expansion: mono = identity relabel; N-phone = native
    # on-the-fly C o LG (ref: fstext/context-fst.h:491 ComposeContext)
    disambig = set(lang.disambig_phone_ids)
    if ctx_dep.context_width == 1:
        ilabel_info = [[]]
        relabel = {EPS: EPS}
        for sym in range(1, len(lang.phones)):
            ilabel_info.append([-sym] if sym in disambig else [sym])
            relabel[sym] = len(ilabel_info) - 1
        clg = lg.relabel(imap=relabel)
    else:
        t0 = time.time()
        clg, ilabel_info = native_ops.compose_context_flat(
            lg, disambig, N=ctx_dep.context_width,
            P=ctx_dep.central_position)
        stats["clg_arcs"] = clg.num_arcs
        log(f"C o LG = {clg} ({len(ilabel_info)} context ilabels) "
            f"[{time.time()-t0:.1f}s]")

    t0 = time.time()
    ha, disambig_tids = make_h_transducer(ilabel_info, ctx_dep, trans_model,
                                          transition_scale)
    hclga = native_ops.compose_flat(FlatFst.from_fst(ha), clg)
    stats["hclga_arcs"] = hclga.num_arcs
    log(f"Ha({ha.num_states}/{ha.num_arcs}) o CLG = {hclga} "
        f"[{time.time()-t0:.1f}s]")
    t0 = time.time()
    hclga = native_ops.determinize_star_flat(hclga, use_log=True)
    log(f"det(HaCLG) = {hclga} [{time.time()-t0:.1f}s]")
    hclga = remove_symbols_flat(hclga, disambig_tids)
    t0 = time.time()
    hclga = native_ops.minimize_encoded_flat(hclga)
    stats["hclga_min_arcs"] = hclga.num_arcs
    log(f"min(HaCLG) = {hclga} [{time.time()-t0:.1f}s]")
    t0 = time.time()
    hclg = add_self_loops_flat(hclga, trans_model, (),
                               self_loop_scale)
    hclg = native_ops.connect_flat(hclg)
    stats["hclg_states"] = hclg.num_states
    stats["hclg_arcs"] = hclg.num_arcs
    log(f"HCLG = {hclg} [{time.time()-t0:.1f}s]")
    return hclg, stats
