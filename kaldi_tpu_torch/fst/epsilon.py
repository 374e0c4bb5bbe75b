"""Epsilon/disambig-symbol removal utilities.

(ref: fstext/remove-eps-local.h RemoveEpsLocal — merges (eps,eps) arcs that
can be combined with a predecessor/successor without changing the language;
fstbin/fstrmsymbols.cc — replaces given input symbols by epsilon.)

The port's copy of kaldi_tpu/fst/epsilon.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

from kaldi_tpu_torch.fst.fst import Fst, EPS, INF, log_plus


def remove_symbols(fst: Fst, symbols) -> Fst:
    """Replace the given *input* labels by epsilon (fstrmsymbols)."""
    symset = set(int(s) for s in symbols)
    for s, arcs in enumerate(fst.arcs):
        fst.arcs[s] = [
            (EPS if i in symset else i, o, w, d) for (i, o, w, d) in arcs
        ]
    return fst


def remove_eps_local(fst: Fst) -> Fst:
    """Remove (eps,eps) arcs where it can be done without blowup.

    Strategy (same effect as the reference's local removal, conservative):
    repeatedly, for an (eps,eps,w) arc s->d where either
      * d has exactly one entering arc and d is not final and d != start: splice
        d's arcs onto s (prefixing w), or
      * the arc is a self-loop with w==0: drop it.
    """
    changed = True
    while changed:
        changed = False
        in_degree = [0] * fst.num_states
        for s in range(fst.num_states):
            for (_i, _o, _w, d) in fst.arcs[s]:
                in_degree[d] += 1
        for s in range(fst.num_states):
            new_arcs = []
            for arc in fst.arcs[s]:
                (i, o, w, d) = arc
                if i == EPS and o == EPS:
                    if d == s and w == 0.0:
                        changed = True
                        continue  # drop trivial self-loop
                    if (in_degree[d] == 1 and d != fst.start
                            and d not in fst.finals and d != s):
                        for (i2, o2, w2, d2) in fst.arcs[d]:
                            new_arcs.append((i2, o2, w + w2, d2))
                        fst.arcs[d] = []
                        changed = True
                        continue
                new_arcs.append(arc)
            fst.arcs[s] = new_arcs
    fst.connect()
    return fst


def rm_epsilon(fst: Fst, use_log: bool = False) -> Fst:
    """Full epsilon removal via epsilon-closure (for acyclic-in-eps FSTs)."""
    plus = log_plus if use_log else min

    n = fst.num_states
    out = Fst()
    for _ in range(n):
        out.add_state()
    out.start = fst.start

    for s in range(n):
        # epsilon closure from s: residual-propagation shortest-distance
        # (Mohri 2002) — push only the not-yet-propagated part of each
        # state's weight, so the log semiring sums every eps path exactly
        # once (full-value re-relaxation would double-count, and a tropical
        # improvement gate would drop equal-cost path mass).
        closure: dict[int, float] = {s: 0.0}
        resid: dict[int, float] = {s: 0.0}
        stack = [s]
        guard = 0
        while stack:
            guard += 1
            if guard > 100 * (n + 10):
                raise RuntimeError("epsilon cycle in rm_epsilon")
            u = stack.pop()
            ru = resid.pop(u, None)
            if ru is None:
                continue
            for (i, o, w, d) in fst.arcs[u]:
                if i == EPS and o == EPS:
                    nw = ru + w
                    old = closure.get(d, INF)
                    cw = plus(old, nw)
                    if cw < old - 1e-12:
                        closure[d] = cw
                        resid[d] = plus(resid.get(d, INF), nw)
                        stack.append(d)
        fin = INF
        for u, wu in closure.items():
            fu = fst.final(u)
            if fu < INF:
                fin = plus(fin, wu + fu)
            for (i, o, w, d) in fst.arcs[u]:
                if i == EPS and o == EPS:
                    continue
                out.add_arc(s, i, o, wu + w, d)
        if fin < INF:
            out.set_final(s, fin)
    out.connect()
    return out
