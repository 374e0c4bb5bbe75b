"""Phi (backoff) composition and push-special.

(ref: fstext — fstphicompose (the backoff-LM composition that takes a phi
 arc ONLY when no real match exists, avoiding the eps-approximation of
 backoff n-gram models) and fstext/push-special.h PushSpecial (weight
 pushing that works on CYCLIC graphs by finding the per-state potentials
 iteratively, keeping the total weight constant).)

The port's copy of kaldi_tpu/fst/special.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests/test_torch_*.py hold the two
equal.
"""

from __future__ import annotations

import bisect
from collections import deque

import numpy as np

from kaldi_tpu_torch.fst.fst import Fst, INF


def phi_compose(a: Fst, b: Fst, phi_label: int) -> Fst:
    """Compose acceptor-like b (ilabel-sorted not required) with a, where
    b's arcs labeled phi_label are failure transitions: taken (possibly in
    chains) only when b has no arc matching the incoming label. Matches
    the reference's PhiMatcher semantics: phi consumes no input, final
    weights are reachable through phi chains."""
    out = Fst()
    state_map: dict = {}
    queue: deque = deque()

    def get(key):
        s = state_map.get(key)
        if s is None:
            s = out.add_state()
            state_map[key] = s
            queue.append(key)
        return s

    # per-state ilabel-sorted copies of b's arcs, built lazily, so label
    # lookup is a bisect instead of a linear scan (b is typically a big
    # backoff G with thousands of arcs per LM state); b is NOT mutated.
    sorted_cache: dict[int, list] = {}

    def b_arcs(s):
        arcs = sorted_cache.get(s)
        if arcs is None:
            arcs = sorted(b.arcs[s], key=lambda a: a[0])
            sorted_cache[s] = arcs
        return arcs

    def find_arc(bs: int, label: int):
        """First arc at bs with the given ilabel, via bisect; None if absent."""
        arcs = b_arcs(bs)
        lo = bisect.bisect_left(arcs, label, key=lambda a: a[0])
        if lo < len(arcs) and arcs[lo][0] == label:
            return arcs[lo]
        return None

    def match_b(bs: int, label: int):
        """Follow phi chains until `label` matches. -> (cost, olabel, dst)
        or None."""
        cost = 0.0
        seen = set()
        while True:
            arc = find_arc(bs, label)
            if arc is not None:
                return cost + arc[2], arc[1], arc[3]
            phi_arc = find_arc(bs, phi_label)
            if phi_arc is None or bs in seen:
                return None
            seen.add(bs)
            cost += phi_arc[2]
            bs = phi_arc[3]

    def final_b(bs: int):
        """Final cost reachable via phi chains."""
        cost = 0.0
        seen = set()
        while True:
            f = b.final(bs)
            if f < INF:
                return cost + f
            phi_arc = find_arc(bs, phi_label)
            if phi_arc is None or bs in seen:
                return INF
            seen.add(bs)
            cost += phi_arc[2]
            bs = phi_arc[3]

    if a.start < 0 or b.start < 0:
        return out
    out.start = get((a.start, b.start))
    while queue:
        key = queue.popleft()
        as_, bs = key
        cur = state_map[key]
        fa, fb = a.final(as_), final_b(bs)
        if fa < INF and fb < INF:
            out.set_final(cur, fa + fb)
        for (il, ol, w, d) in a.arcs[as_]:
            if ol == 0:
                out.add_arc(cur, il, 0, w, get((d, bs)))
                continue
            m = match_b(bs, ol)
            if m is None:
                continue
            bw, bol, bd = m
            out.add_arc(cur, il, bol, w + bw, get((d, bd)))
    return out


def push_special(f: Fst, delta: float = 1e-3, max_iters: int = 200) -> Fst:
    """Weight pushing for (possibly cyclic) FSTs in the tropical semiring:
    find per-state potentials V(s) = min cost-to-final by value iteration,
    reweight w'(s→t) = w + V(t) − V(s), finals f' = f − V(s), and restore
    the total by adding V(start) at the start state's arcs/final
    (ref: fstext/push-special.h — same invariant: every state's best
    suffix costs ~0 after pushing, paths keep their total weight)."""
    n = f.num_states
    V = np.full(n, INF)
    for s, c in f.finals.items():
        V[s] = c
    for _ in range(max_iters):
        changed = 0.0
        for s in range(n - 1, -1, -1):
            best = f.final(s)
            for (il, ol, w, d) in f.arcs[s]:
                best = min(best, w + V[d])
            if best < V[s] - delta:
                changed = max(changed, V[s] - best)
                V[s] = best
        if changed <= delta:
            break
    out = Fst()
    for _ in range(n):
        out.add_state()
    v0 = V[f.start] if np.isfinite(V[f.start]) else 0.0
    for s in range(n):
        if not np.isfinite(V[s]):
            continue
        for (il, ol, w, d) in f.arcs[s]:
            if not np.isfinite(V[d]):
                continue
            out.add_arc(s, il, ol, w + V[d] - V[s], d)
        fc = f.final(s)
        if fc < INF:
            out.set_final(s, fc - V[s])
    # restore the total path weight exactly once, at initial entry: a
    # dedicated start state carrying V(start) on its outgoing copies
    # (cycles may revisit the original start without re-paying it)
    if v0 != 0.0:
        s_new = out.add_state()
        for (il, ol, w, d) in out.arcs[f.start]:
            out.add_arc(s_new, il, ol, w + v0, d)
        fc = out.final(f.start)
        if fc < INF:
            out.set_final(s_new, fc + v0)
        out.start = s_new
    else:
        out.start = f.start
    return out


def rho_compose(a: Fst, b: Fst, rho_label: int) -> Fst:
    """Compose a with b where b's arcs labeled rho_label are
    rest-matchers: at each b state, an incoming label with no exact
    match takes the rho arc, CONSUMING the label (the output label is
    rewritten to the matched input label, MATCHER_REWRITE_ALWAYS).
    Unlike phi, rho does not chain (ref: fstbin/fstrhocompose.cc,
    fst RhoMatcher)."""
    out = Fst()
    state_map: dict = {}
    queue: deque = deque()

    def get(key):
        s = state_map.get(key)
        if s is None:
            s = out.add_state()
            state_map[key] = s
            queue.append(key)
        return s

    sorted_cache: dict[int, list] = {}

    def b_arcs(s):
        arcs = sorted_cache.get(s)
        if arcs is None:
            arcs = sorted(b.arcs[s], key=lambda x: x[0])
            sorted_cache[s] = arcs
        return arcs

    def find_arc(bs: int, label: int):
        arcs = b_arcs(bs)
        lo = bisect.bisect_left(arcs, label, key=lambda x: x[0])
        if lo < len(arcs) and arcs[lo][0] == label:
            return arcs[lo]
        return None

    if a.start < 0 or b.start < 0:
        return out
    out.start = get((a.start, b.start))
    while queue:
        key = queue.popleft()
        as_, bs = key
        cur = state_map[key]
        fa, fb = a.final(as_), b.final(bs)
        if fa < INF and fb < INF:
            out.set_final(cur, fa + fb)
        for (il, ol, w, d) in a.arcs[as_]:
            if ol == 0:
                out.add_arc(cur, il, 0, w, get((d, bs)))
                continue
            arc = find_arc(bs, ol)
            if arc is None:
                arc = find_arc(bs, rho_label)
                if arc is None:
                    continue
                # rho consumes ol; rewrite the output to the real label
                out.add_arc(cur, il, ol, w + arc[2], get((d, arc[3])))
            else:
                out.add_arc(cur, il, arc[1], w + arc[2],
                            get((d, arc[3])))
    return out


def prop_final(f: Fst, phi_label: int) -> Fst:
    """Propagate final weights backwards through phi_label arcs: a state
    with a phi arc to a final state becomes final with the combined
    weight, iterated to a fixpoint (ref: fstbin/fstpropfinal.cc,
    fstext/deterministic-fst.h PropagateFinal)."""
    out = f.copy()
    changed = True
    while changed:
        changed = False
        for s in range(out.num_states):
            for (il, _ol, w, d) in out.arcs[s]:
                if il != phi_label:
                    continue
                fd = out.final(d)
                if fd >= INF:
                    continue
                cand = w + fd
                if cand < out.final(s) - 1e-12:
                    out.set_final(s, cand)
                    changed = True
    return out
