"""Lattice algorithms: forward-backward, pruning, best path, scaling,
posteriors, word-level determinization, LM rescoring.

(ref: lat/lattice-functions.h:44-304 — LatticeForwardBackward :62,
 PruneLattice :130, shortest path :241, AddWordInsPenToCompactLattice :246,
 Rescore{Compact,}Lattice :253,294; lat/determinize-lattice-pruned.h:255.)

The port's copy of kaldi_tpu/lat/functions.py (host code), carried verbatim
so the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from kaldi_tpu_torch.lat.lattice import Lattice, LatticeArc

INF = float("inf")


def _log_add(a, b):
    if a == -INF:
        return b
    if b == -INF:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(-abs(a - b)))


def lattice_scale(lat: Lattice, lm_scale: float = 1.0,
                  acoustic_scale: float = 1.0) -> Lattice:
    """(ref: latbin/lattice-scale.cc)"""
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            a.graph_cost *= lm_scale
            a.acoustic_cost *= acoustic_scale
    lat.finals = {s: (g * lm_scale, a * acoustic_scale)
                  for s, (g, a) in lat.finals.items()}
    return lat


def add_word_ins_penalty(lat: Lattice, penalty: float) -> Lattice:
    """(ref: lattice-functions.h:246 AddWordInsPenToCompactLattice)"""
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            if a.olabel != 0:
                a.graph_cost += penalty
    return lat


def lattice_best_path(lat: Lattice):
    """-> (words, tids, total_cost) via Viterbi over the (acyclic) lattice.
    (ref: latbin/lattice-best-path.cc)"""
    order = lat.topological_order()
    n = lat.num_states
    alpha = np.full(n, INF)
    back: list = [None] * n
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == INF:
            continue
        for a in lat.arcs[s]:
            c = alpha[s] + a.cost
            if c < alpha[a.nextstate]:
                alpha[a.nextstate] = c
                back[a.nextstate] = (s, a)
    best_s, best_c = -1, INF
    for s, (g, ac) in lat.finals.items():
        if alpha[s] + g + ac < best_c:
            best_c = alpha[s] + g + ac
            best_s = s
    if best_s < 0:
        return None
    words, tids = [], []
    s = best_s
    while back[s] is not None:
        p, a = back[s]
        if a.olabel:
            words.append(a.olabel)
        if a.ilabel:
            tids.append(a.ilabel)
        s = p
    return words[::-1], tids[::-1], best_c


def lattice_forward_backward(lat: Lattice):
    """-> (arc posteriors dict (state, arc_idx) -> gamma, total log-like,
    per-state alpha/beta in -log space).

    (ref: lattice-functions.h:62 LatticeForwardBackward — sum semiring over
    total costs.)
    """
    order = lat.topological_order()
    n = lat.num_states
    alpha = np.full(n, -INF)  # log-probs
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == -INF:
            continue
        for a in lat.arcs[s]:
            alpha[a.nextstate] = _log_add(alpha[a.nextstate],
                                          alpha[s] - a.cost)
    beta = np.full(n, -INF)
    for s, (g, ac) in lat.finals.items():
        beta[s] = -(g + ac)
    for s in reversed(order):
        for a in lat.arcs[s]:
            beta[s] = _log_add(beta[s], -a.cost + beta[a.nextstate])
    tot = beta[lat.start]
    post = {}
    for s in range(n):
        for i, a in enumerate(lat.arcs[s]):
            lp = alpha[s] - a.cost + beta[a.nextstate] - tot
            post[(s, i)] = math.exp(min(lp, 0.0))
    return post, tot, alpha, beta


def prune_lattice(lat: Lattice, beam: float) -> Lattice:
    """Drop arcs/states not on any path within `beam` of the best
    (ref: lattice-functions.h:130 PruneLattice — Viterbi semiring)."""
    if lat.num_states == 0 or lat.start < 0:
        return lat
    order = lat.topological_order()
    n = lat.num_states
    alpha = np.full(n, INF)
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == INF:
            continue
        for a in lat.arcs[s]:
            alpha[a.nextstate] = min(alpha[a.nextstate], alpha[s] + a.cost)
    beta = np.full(n, INF)
    for s, (g, ac) in lat.finals.items():
        beta[s] = g + ac
    for s in reversed(order):
        for a in lat.arcs[s]:
            beta[s] = min(beta[s], a.cost + beta[a.nextstate])
    if n == 0 or lat.start < 0:
        return lat
    best = beta[lat.start]
    cutoff = best + beam
    out = Lattice()
    for _ in range(n):
        out.add_state()
    out.start = lat.start
    for s in range(n):
        for a in lat.arcs[s]:
            if alpha[s] + a.cost + beta[a.nextstate] <= cutoff:
                out.add_arc(s, a.ilabel, a.olabel, a.graph_cost,
                            a.acoustic_cost, a.nextstate)
    for s, (g, ac) in lat.finals.items():
        if alpha[s] + g + ac <= cutoff:
            out.set_final(s, g, ac)
    return out.connect()


def _word_eps_closure(lat: Lattice, topo_pos, elems):
    """Close a weighted subset over olabel=0 arcs (which may carry tids).

    elems: dict state -> (g, a, tids). The input lattice is acyclic, so
    relaxation in topological order is exact even with negative acoustic
    costs. Combination is the CompactLattice semiring plus: min by
    (total cost, then tid string) — one element per state.
    """
    better = lambda x, y: (x[0] + x[1], x[2]) < (y[0] + y[1], y[2])
    out = dict(elems)
    # states are processed in topo order; arcs only go forward, so each
    # state is settled before it expands (re-pushed only on improvement)
    import heapq
    h = [(topo_pos[s], s) for s in elems]
    heapq.heapify(h)
    seen_pos = set()
    while h:
        _p, s = heapq.heappop(h)
        if (s, out[s]) in seen_pos:
            continue
        seen_pos.add((s, out[s]))
        g, a, tids = out[s]
        for arc in lat.arcs[s]:
            if arc.olabel != 0:
                continue
            cand = (g + arc.graph_cost, a + arc.acoustic_cost,
                    tids + ((arc.ilabel,) if arc.ilabel else ()))
            cur = out.get(arc.nextstate)
            if cur is None or better(cand, cur):
                out[arc.nextstate] = cand
                heapq.heappush(h, (topo_pos[arc.nextstate], arc.nextstate))
    return out


class DeterminizeLatticeOverflow(RuntimeError):
    """Raised when subset construction exceeds max_states — the
    reference's DeterminizeLatticePruned failure mode (it bounds work
    with max_mem/max_states and returns false; callers keep the raw
    lattice, decoder-wrappers.cc:283)."""


def determinize_lattice(lat: Lattice, beam: float | None = None,
                        max_states: int = 200_000) -> Lattice:
    """Word-level determinization with optional beam pruning: the output
    accepts one path per word sequence, with the best (min-cost) weight
    and that path's transition-id alignment distributed along its arcs.

    Bottom-up weighted subset construction over elements
    (input-state, cost-residual pair, tid-string residual), normalized by
    subtracting the best element's weight and emitting the longest common
    string prefix on each output arc — the reference algorithm
    (ref: lat/determinize-lattice-pruned.h:112-267,
     fstext/determinize-lattice.h:120 — the CompactLattice semiring:
     min by (cost, string)). No path budget: the input is acyclic, so
    the construction terminates even when no subsets merge.

    beam: drop subset elements whose best completion exceeds the overall
    best path by more than beam (DeterminizeLatticePrunedOptions beam,
    determinize-lattice-pruned.h:60) — the decode-side lattice-beam.

    max_states bounds the determinized state count (the reference's
    max_mem/max_states safety valve, determinize-lattice-pruned.h:70);
    raises DeterminizeLatticeOverflow beyond it — callers should fall
    back to the raw lattice, as the reference's wrappers do.
    """
    if lat.num_states == 0 or lat.start < 0:
        return Lattice()
    order = lat.topological_order()
    topo_pos = {s: i for i, s in enumerate(order)}
    n = lat.num_states
    # backward best total cost (for pruning)
    beta = np.full(n, INF)
    for s, (g, a) in lat.finals.items():
        beta[s] = g + a
    for s in reversed(order):
        for arc in lat.arcs[s]:
            beta[s] = min(beta[s], arc.cost + beta[arc.nextstate])
    best_total = beta[lat.start]
    if not np.isfinite(best_total):
        return Lattice()
    cutoff = best_total + (beam if beam is not None else INF)

    def normalize(elems, base):
        """-> (emit_pair, emit_tids, subset_key, kept dict).
        Subtract the best element's weight, strip the common tid prefix;
        prune elements whose best completion exceeds the cutoff."""
        kept = {s: v for s, v in elems.items()
                if base + v[0] + v[1] + beta[s] <= cutoff + 1e-6}
        if not kept:
            return None
        bs = min(kept, key=lambda s: (kept[s][0] + kept[s][1], kept[s][2]))
        bg, ba, _bt = kept[bs]
        strings = [v[2] for v in kept.values()]
        lcp = strings[0]
        for t in strings[1:]:
            m = 0
            while m < len(lcp) and m < len(t) and lcp[m] == t[m]:
                m += 1
            lcp = lcp[:m]
        k = len(lcp)
        norm = {s: (g - bg, a - ba, tids[k:])
                for s, (g, a, tids) in kept.items()}
        key = tuple(sorted(
            (s, round(g, 6), round(a, 6), t)
            for s, (g, a, t) in norm.items()))
        return (bg, ba), lcp, key, norm

    out = Lattice()
    init = _word_eps_closure(lat, topo_pos,
                             {lat.start: (0.0, 0.0, ())})
    nrm = normalize(init, 0.0)
    if nrm is None:
        return Lattice()
    (ig, ia), itids, ikey, ielems = nrm
    out.start = out.add_state()
    state_of = {ikey: out.start}
    base_of = {ikey: ig + ia}
    # initial residual weight/string: attach to the start via an eps arc
    # only if nonzero (keeps simple lattices simple)
    if ig or ia or itids:
        real_start = out.start
        s0 = out.add_state()
        out.start = s0
        out.add_arc(s0, 0, 0, ig, ia, real_start)
        if itids:
            out.arcs[s0][-1].tids = tuple(itids)  # type: ignore

    from collections import deque
    queue = deque([(ikey, ielems)])
    done = set()
    while queue:
        key, elems = queue.popleft()
        if key in done:
            continue
        done.add(key)
        src = state_of[key]
        base = base_of[key]
        # final weight of this det state
        fin = None
        for s, (g, a, tids) in elems.items():
            f = lat.finals.get(s)
            if f is None:
                continue
            cand = (g + f[0], a + f[1], tids)
            if base + cand[0] + cand[1] <= cutoff + 1e-6 and \
                    (fin is None or (cand[0] + cand[1], cand[2])
                     < (fin[0] + fin[1], fin[2])):
                fin = cand
        if fin is not None:
            fg, fa, ftids = fin
            if ftids:
                term = out.add_state()
                out.add_arc(src, 0, 0, fg, fa, term)
                out.arcs[src][-1].tids = tuple(ftids)  # type: ignore
                out.set_final(term, 0.0, 0.0)
            else:
                out.set_final(src, fg, fa)
        # group outgoing word transitions
        trans: dict[int, dict] = {}
        for s, (g, a, tids) in elems.items():
            for arc in lat.arcs[s]:
                if arc.olabel == 0:
                    continue
                cand = (g + arc.graph_cost, a + arc.acoustic_cost,
                        tids + ((arc.ilabel,) if arc.ilabel else ()))
                d = trans.setdefault(arc.olabel, {})
                cur = d.get(arc.nextstate)
                if cur is None or (cand[0] + cand[1], cand[2]) < \
                        (cur[0] + cur[1], cur[2]):
                    d[arc.nextstate] = cand
        for w, nelems in trans.items():
            nelems = _word_eps_closure(lat, topo_pos, nelems)
            nrm = normalize(nelems, base)
            if nrm is None:
                continue
            (eg, ea), etids, nkey, norm = nrm
            dst = state_of.get(nkey)
            if dst is None:
                if out.num_states >= max_states:
                    raise DeterminizeLatticeOverflow(
                        f"lattice determinization exceeded {max_states} "
                        f"states (input: {lat.num_states} states, "
                        f"{lat.num_arcs} arcs)")
                dst = out.add_state()
                state_of[nkey] = dst
                base_of[nkey] = base + eg + ea
                queue.append((nkey, norm))
            out.add_arc(src, 0, w, eg, ea, dst)
            if etids:
                out.arcs[src][-1].tids = tuple(etids)  # type: ignore
    return out.connect()


def nbest(lat: Lattice, n: int):
    """-> list of (words, tids, cost), best first
    (ref: latbin/lattice-nbest / nbest-to-linear)."""
    import heapq
    if lat.num_states == 0 or lat.start < 0:
        return []
    h = [(0.0, 0, lat.start, (), ())]
    out = []
    seq = 0
    seen = defaultdict(int)
    while h and len(out) < n:
        cost, _q, s, words, tids = heapq.heappop(h)
        if s in lat.finals:
            g, a = lat.finals[s]
            out.append((list(words), list(tids), cost + g + a))
        if seen[s] >= n:
            continue
        seen[s] += 1
        for arc in lat.arcs[s]:
            seq += 1
            heapq.heappush(h, (cost + arc.cost, seq, arc.nextstate,
                               words + ((arc.olabel,) if arc.olabel else ()),
                               tids + ((arc.ilabel,) if arc.ilabel else ())))
    return out


def compose_lattice_with_lm(lat: Lattice, g, backoff_label: int,
                            lm_scale: float = 1.0) -> Lattice:
    """Compose a (word-level or tid-level) lattice with a word acceptor G,
    adding lm_scale * G-cost to the graph part.

    (ref: latbin/lattice-lmrescore.cc — run once with lm_scale=-1 on the
    old G and once with +1 on the new G to swap LM scores; backoff #0
    arcs in G are traversed freely.)
    """
    from collections import deque

    out = Lattice()
    state_map: dict = {}
    queue: deque = deque()

    def get_state(key):
        s = state_map.get(key)
        if s is None:
            s = out.add_state()
            state_map[key] = s
            queue.append(key)
        return s

    out.start = get_state((lat.start, g.start))
    INF_ = float("inf")
    while queue:
        key = queue.popleft()
        ls, gs = key
        cur = state_map[key]
        # G backoff closure handled lazily via explicit backoff arcs
        for (gi, _go, gw, gd) in g.arcs[gs]:
            if gi == backoff_label:
                out.add_arc(cur, 0, 0, lm_scale * gw, 0.0,
                            get_state((ls, gd)))
        if ls in lat.finals:
            gfin = g.final(gs)
            if gfin < INF_:
                gc, ac = lat.finals[ls]
                out.set_final(cur, gc + lm_scale * gfin, ac)
        for a in lat.arcs[ls]:
            if a.olabel == 0:
                na = out.add_arc(cur, a.ilabel, 0, a.graph_cost,
                                 a.acoustic_cost, get_state((a.nextstate, gs)))
                if hasattr(a, "tids"):
                    out.arcs[cur][-1].tids = a.tids  # type: ignore
                continue
            for (gi, _go, gw, gd) in g.arcs[gs]:
                if gi == a.olabel:
                    out.add_arc(cur, a.ilabel, a.olabel,
                                a.graph_cost + lm_scale * gw,
                                a.acoustic_cost, get_state((a.nextstate, gd)))
    return out.connect()


def rescore_nbest(paths, lm, words_table, lm_scale=1.0, old_lm_costs=None):
    """Rescore (words, tids, cost) n-best entries with an ArpaLm.

    cost' = cost - old_lm_cost + lm_scale * new_lm_cost; if old costs are
    unknown, caller should have removed graph costs already.
    """
    out = []
    for k, (words, tids, cost) in enumerate(paths):
        sent = [words_table.sym(w) for w in words]
        new_lm = -lm.score_sentence(sent)
        old = old_lm_costs[k] if old_lm_costs else 0.0
        out.append((words, tids, cost - old + lm_scale * new_lm))
    return sorted(out, key=lambda x: x[2])


def best_path_ctm(lat: Lattice):
    """Best-path word timings: [(word, start_frame, dur_frames)].

    A word starts at the frame of the arc that EMITS its olabel and ends
    where the next word starts (or the path ends) — the tid-level lattice
    has one frame per emitting (ilabel != 0) arc
    (ref: latbin/lattice-to-ctm-conf.cc one-best mode; MBR sausage times
    replace these when --decode-mbr is on).
    """
    res = lattice_best_path(lat)
    if res is None:
        return []
    order = lat.topological_order()
    n = lat.num_states
    alpha = np.full(n, INF)
    back: list = [None] * n
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == INF:
            continue
        for a in lat.arcs[s]:
            c = alpha[s] + a.cost
            if c < alpha[a.nextstate]:
                alpha[a.nextstate] = c
                back[a.nextstate] = (s, a)
    best_s, best_c = -1, INF
    for s, (g, ac) in lat.finals.items():
        if alpha[s] + g + ac < best_c:
            best_c, best_s = alpha[s] + g + ac, s
    arcs = []
    s = best_s
    while back[s] is not None:
        p, a = back[s]
        arcs.append(a)
        s = p
    arcs.reverse()
    ctm = []
    t = 0
    for a in arcs:
        if a.olabel:
            ctm.append([a.olabel, t, 0])
        if a.ilabel:
            t += 1
            if ctm:
                ctm[-1][2] = t - ctm[-1][1]
    # close any zero-duration word at path end
    return [(w, s0, max(d, 1)) for (w, s0, d) in ctm]
