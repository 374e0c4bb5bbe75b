"""Lattice container with (graph_cost, acoustic_cost) pair weights: a copy
of kaldi_tpu/lat/lattice.py (the port imports nothing of kaldi_tpu).

(ref: lat/kaldi-lattice.h:32-46 — Lattice is an FST over LatticeWeight
 (graph, acoustic) cost pairs with transition-id ilabels and word olabels;
 CompactLattice moves tid strings onto word arcs. We keep one container
 with both ilabel (tid) and olabel (word) per arc, which covers both
 roles; 'compact' here = determinized-to-word-level.)
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(slots=True)
class LatticeArc:
    ilabel: int        # transition-id (0 = eps)
    olabel: int        # word id (0 = eps)
    graph_cost: float
    acoustic_cost: float
    nextstate: int
    tids: tuple = ()   # CompactLattice tid string (determinized word arcs)

    @property
    def cost(self) -> float:
        return self.graph_cost + self.acoustic_cost


class Lattice:
    """Arc-list lattice. `from_arrays` keeps the flat arc arrays and
    materializes the Python arc lists LAZILY on first `.arcs` access —
    production latgen produces hundreds of thousands of arcs per batch
    and the per-arc object construction (~2s for 400k arcs) must not sit
    on the decode path; consumers that only count/serialize/forward the
    lattice never pay it."""

    def __init__(self):
        self._arcs: list[list[LatticeArc]] = []
        self._arrays = None    # (n_states, src, il, ol, gc, ac, dst)
        self.finals: dict[int, tuple[float, float]] = {}  # (graph, acoustic)
        self.start = -1

    @property
    def arcs(self) -> list[list[LatticeArc]]:
        if self._arrays is not None:
            self._materialize()
        return self._arcs

    @arcs.setter
    def arcs(self, value):
        self._arrays = None
        self._arcs = value

    def _materialize(self):
        n_states, src, il, ol, gc, ac, dst = self._arrays
        self._arrays = None
        arcs = [[] for _ in range(n_states)]
        for s, i, o, g, a, d in zip(src.tolist(), il.tolist(), ol.tolist(),
                                    gc.tolist(), ac.tolist(), dst.tolist()):
            arcs[s].append(LatticeArc(i, o, g, a, d))
        self._arcs = arcs

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self._arcs) - 1

    @classmethod
    def from_arrays(cls, n_states: int, src, il, ol, gc, ac, dst,
                    start: int, finals: dict) -> "Lattice":
        """Bulk construction from flat arc arrays (the fast path for
        decoder lattice extraction — arrays are stored as-is; arc lists
        materialize only if a consumer walks them)."""
        lat = cls()
        lat.start = start
        order = np.argsort(np.asarray(src), kind="stable")
        lat._arrays = (int(n_states),
                       np.asarray(src)[order],
                       np.asarray(il)[order],
                       np.asarray(ol)[order],
                       np.asarray(gc, np.float64)[order],
                       np.asarray(ac, np.float64)[order],
                       np.asarray(dst)[order])
        lat.finals = {int(s): (float(g), float(a))
                      for s, (g, a) in finals.items()}
        return lat

    def to_arrays(self):
        """-> (n_states, src, il, ol, gc, ac, dst) flat arc arrays,
        src-sorted. Zero-copy when the lattice still holds its
        from_arrays form; otherwise built once from the arc lists."""
        if self._arrays is not None:
            return self._arrays
        n = len(self._arcs)
        src, il, ol, gc, ac, dst = [], [], [], [], [], []
        for s, arcs in enumerate(self._arcs):
            for a in arcs:
                src.append(s)
                il.append(a.ilabel)
                ol.append(a.olabel)
                gc.append(a.graph_cost)
                ac.append(a.acoustic_cost)
                dst.append(a.nextstate)
        return (n, np.asarray(src, np.int64), np.asarray(il, np.int64),
                np.asarray(ol, np.int64), np.asarray(gc, np.float64),
                np.asarray(ac, np.float64), np.asarray(dst, np.int64))

    def add_arc(self, s, ilabel, olabel, graph_cost, acoustic_cost, dst):
        self.arcs[s].append(
            LatticeArc(ilabel, olabel, float(graph_cost),
                       float(acoustic_cost), dst))

    def set_final(self, s, graph_cost=0.0, acoustic_cost=0.0):
        self.finals[s] = (float(graph_cost), float(acoustic_cost))

    @property
    def num_states(self):
        if self._arrays is not None:
            return self._arrays[0]
        return len(self._arcs)

    @property
    def num_arcs(self):
        if self._arrays is not None:
            return len(self._arrays[1])
        return sum(len(a) for a in self._arcs)

    def final_cost(self, s) -> float:
        f = self.finals.get(s)
        return f[0] + f[1] if f else np.inf

    def connect(self):
        n = self.num_states
        if self.start < 0:
            return self
        acc = np.zeros(n, bool)
        stack = [self.start]
        acc[self.start] = True
        while stack:
            s = stack.pop()
            for a in self.arcs[s]:
                if not acc[a.nextstate]:
                    acc[a.nextstate] = True
                    stack.append(a.nextstate)
        preds = [[] for _ in range(n)]
        for s in range(n):
            for a in self.arcs[s]:
                preds[a.nextstate].append(s)
        coacc = np.zeros(n, bool)
        stack = [s for s in self.finals if acc[s]]
        for s in stack:
            coacc[s] = True
        while stack:
            s = stack.pop()
            for p in preds[s]:
                if not coacc[p]:
                    coacc[p] = True
                    stack.append(p)
        keep = acc & coacc
        remap = -np.ones(n, np.int64)
        remap[keep] = np.arange(int(keep.sum()))
        new_arcs = []
        for s in range(n):
            if not keep[s]:
                continue
            row = []
            for a in self.arcs[s]:
                if not keep[a.nextstate]:
                    continue
                na = dataclasses.replace(
                    a, nextstate=int(remap[a.nextstate]))
                if hasattr(a, "tids"):      # stashed alignment strings
                    na.tids = a.tids        # survive connect()
                row.append(na)
            new_arcs.append(row)
        self.arcs = new_arcs
        self.finals = {int(remap[s]): w for s, w in self.finals.items()
                       if keep[s]}
        self.start = int(remap[self.start]) if self.start >= 0 and keep[self.start] else -1
        return self

    def topological_order(self) -> list[int]:
        n = self.num_states
        indeg = [0] * n
        for s in range(n):
            for a in self.arcs[s]:
                indeg[a.nextstate] += 1
        from collections import deque
        q = deque([s for s in range(n) if indeg[s] == 0])
        order = []
        while q:
            s = q.popleft()
            order.append(s)
            for a in self.arcs[s]:
                indeg[a.nextstate] -= 1
                if indeg[a.nextstate] == 0:
                    q.append(a.nextstate)
        if len(order) != n:
            raise ValueError("lattice has a cycle")
        return order

    def paths(self, max_paths=100000):
        """All (words, tids, total_cost) paths — small-lattice test oracle."""
        out = []

        def rec(s, words, tids, cost):
            if len(out) >= max_paths:
                return
            if s in self.finals:
                g, a = self.finals[s]
                out.append((tuple(words), tuple(tids), cost + g + a))
            for arc in self.arcs[s]:
                rec(arc.nextstate,
                    words + ([arc.olabel] if arc.olabel else []),
                    tids + ([arc.ilabel] if arc.ilabel else []),
                    cost + arc.cost)

        if self.start >= 0:
            rec(self.start, [], [], 0.0)
        return out
