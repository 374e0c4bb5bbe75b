"""The lattice algorithms the latgen path uses: Viterbi best path and beam
pruning, copied from kaldi_tpu/lat/functions.py (ref:
lat/lattice-functions.h:130 PruneLattice, latbin/lattice-best-path.cc).
Forward-backward, determinization and rescoring are not ported yet.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.lat.lattice import Lattice

INF = float("inf")


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
