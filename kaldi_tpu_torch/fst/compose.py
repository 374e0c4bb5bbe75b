"""WFST composition with the standard epsilon-sequencing filter.

(ref: fstext/table-matcher.h:257-329 TableCompose — we get the same effect
of sorted-arc matching by binary-searching arcsorted arc lists; the epsilon
filter is the classic 3-state composition filter that prevents redundant
epsilon paths.)

The port's copy of kaldi_tpu/fst/compose.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import bisect
from collections import deque

from kaldi_tpu_torch.fst.fst import Fst, EPS


def _match_sorted(arcs, label):
    """Arcs with given ilabel from an ilabel-sorted arc list."""
    lo = bisect.bisect_left(arcs, label, key=lambda a: a[0])
    out = []
    for k in range(lo, len(arcs)):
        if arcs[k][0] != label:
            break
        out.append(arcs[k])
    return out


def compose(a: Fst, b: Fst, connect: bool = True) -> Fst:
    """Compose a ∘ b. Neither operand is mutated: the matcher works on
    ilabel-sorted copies of b's arc lists (callers need not pre-arcsort).

    Epsilon handling: epsilon-sequencing filter with states {0,1,2} that
    admits exactly one canonical interleaving of eps moves between matches
    (all of a's output-eps moves, then all of b's input-eps moves):
      0: after a match — any move allowed,
      1: taken an a-eps move — a-eps or b-eps or match allowed,
      2: taken a b-eps move — only b-eps or match allowed.
    """
    b_sorted = [sorted(arcs, key=lambda arc: arc[0]) for arcs in b.arcs]
    a_eps_out = [[arc for arc in arcs if arc[1] == EPS] for arcs in a.arcs]
    b_eps_in = [_match_sorted(arcs, EPS) for arcs in b_sorted]

    out = Fst()
    state_map: dict[tuple[int, int, int], int] = {}

    def get_state(key):
        s = state_map.get(key)
        if s is None:
            s = out.add_state()
            state_map[key] = s
            queue.append(key)
        return s

    if a.start < 0 or b.start < 0:
        return out
    queue: deque = deque()
    start_key = (a.start, b.start, 0)
    out.start = get_state(start_key)

    while queue:
        key = queue.popleft()
        sa, sb, filt = key
        cur = state_map[key]
        fa, fb = a.final(sa), b.final(sb)
        if fa != float("inf") and fb != float("inf"):
            out.set_final(cur, fa + fb)
        # matched (non-eps) moves — allowed from every filter state
        for (ia, oa, wa, da) in a.arcs[sa]:
            if oa == EPS:
                continue
            for (ib, ob, wb, db) in _match_sorted(b_sorted[sb], oa):
                out.add_arc(cur, ia, ob, wa + wb, get_state((da, db, 0)))
        # eps moves under the filter (a-eps blocked only after a b-eps move)
        if filt != 2:
            for (ia, oa, wa, da) in a_eps_out[sa]:
                out.add_arc(cur, ia, EPS, wa, get_state((da, sb, 1)))
        for (ib, ob, wb, db) in b_eps_in[sb]:
            out.add_arc(cur, EPS, ob, wb, get_state((sa, db, 2)))
    if connect:
        out.connect()
    return out


def table_compose(a: Fst, b: Fst) -> Fst:
    """Name-compatible alias (the table-driven matcher is an optimization the
    dict-based matcher above already achieves in Python)."""
    return compose(a, b)
