"""Core weighted FST container + elementary algorithms.

Weights are costs (negative natural log probabilities), tropical semiring by
default (plus=min, times=+). The log semiring is used where the reference
uses --use-log (determinization of stochastic graphs).

(ref: fstext/fstext-utils.h — GetLinearSymbolSequence :135,
 MakeLinearAcceptor :186; the container itself plays the role OpenFst's
 VectorFst plays for the reference.)

The port's copy of kaldi_tpu/fst/fst.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

EPS = 0  # label 0 is epsilon, as in OpenFst
INF = float("inf")


def log_plus(a: float, b: float) -> float:
    """Sum in the log semiring over costs: -log(e^-a + e^-b)."""
    if a == INF:
        return b
    if b == INF:
        return a
    m = min(a, b)
    return m - math.log1p(math.exp(-(abs(a - b))))


class SymbolTable:
    def __init__(self, eps: str = "<eps>"):
        self._s2i: dict[str, int] = {eps: 0}
        self._i2s: list[str] = [eps]

    def add(self, sym: str) -> int:
        if sym in self._s2i:
            return self._s2i[sym]
        i = len(self._i2s)
        self._s2i[sym] = i
        self._i2s.append(sym)
        return i

    def __getitem__(self, sym: str) -> int:
        return self._s2i[sym]

    def __contains__(self, sym: str) -> bool:
        return sym in self._s2i

    def get(self, sym, default=None):
        return self._s2i.get(sym, default)

    def sym(self, i: int) -> str:
        return self._i2s[i]

    def __len__(self):
        return len(self._i2s)

    def symbols(self):
        return list(self._i2s)

    def write(self, path):
        with open(path, "w") as f:
            for i, s in enumerate(self._i2s):
                f.write(f"{s} {i}\n")

    @staticmethod
    def read(path) -> "SymbolTable":
        t = SymbolTable.__new__(SymbolTable)
        t._s2i, t._i2s = {}, []
        with open(path) as f:
            for line in f:
                sym, i = line.split()
                i = int(i)
                while len(t._i2s) <= i:
                    t._i2s.append(None)
                t._i2s[i] = sym
                t._s2i[sym] = i
        return t


class Fst:
    """Mutable WFST: per-state arc lists of (ilabel, olabel, cost, nextstate)."""

    __slots__ = ("arcs", "finals", "start")

    def __init__(self):
        self.arcs: list[list[tuple[int, int, float, int]]] = []
        self.finals: dict[int, float] = {}
        self.start: int = -1

    # --- construction ---

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def add_arc(self, src: int, ilabel: int, olabel: int, cost: float, dst: int):
        self.arcs[src].append((ilabel, olabel, float(cost), dst))

    def set_final(self, state: int, cost: float = 0.0):
        self.finals[state] = float(cost)

    def final(self, state: int) -> float:
        return self.finals.get(state, INF)

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def copy(self) -> "Fst":
        f = Fst()
        f.arcs = [list(a) for a in self.arcs]
        f.finals = dict(self.finals)
        f.start = self.start
        return f

    # --- elementary transforms ---

    def arcsort(self, by: str = "ilabel") -> "Fst":
        key = (lambda a: (a[0], a[1])) if by == "ilabel" else (lambda a: (a[1], a[0]))
        for state_arcs in self.arcs:
            state_arcs.sort(key=key)
        return self

    def project(self, output: bool = False) -> "Fst":
        for s, state_arcs in enumerate(self.arcs):
            self.arcs[s] = [
                (o, o, w, d) if output else (i, i, w, d)
                for (i, o, w, d) in state_arcs
            ]
        return self

    def invert(self) -> "Fst":
        for s, state_arcs in enumerate(self.arcs):
            self.arcs[s] = [(o, i, w, d) for (i, o, w, d) in state_arcs]
        return self

    def connect(self) -> "Fst":
        """Trim states not both accessible and coaccessible."""
        n = self.num_states
        if self.start < 0 or n == 0:
            self.arcs, self.finals, self.start = [], {}, -1
            return self
        # forward reachability
        acc = np.zeros(n, bool)
        stack = [self.start]
        acc[self.start] = True
        while stack:
            s = stack.pop()
            for (_i, _o, _w, d) in self.arcs[s]:
                if not acc[d]:
                    acc[d] = True
                    stack.append(d)
        # backward reachability from finals
        preds: list[list[int]] = [[] for _ in range(n)]
        for s in range(n):
            for (_i, _o, _w, d) in self.arcs[s]:
                preds[d].append(s)
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
        new_arcs: list[list[tuple[int, int, float, int]]] = []
        for s in range(n):
            if not keep[s]:
                continue
            new_arcs.append(
                [(i, o, w, int(remap[d])) for (i, o, w, d) in self.arcs[s]
                 if keep[d]]
            )
        self.arcs = new_arcs
        self.finals = {int(remap[s]): w for s, w in self.finals.items() if keep[s]}
        self.start = int(remap[self.start]) if keep[self.start] else -1
        return self

    # --- queries ---

    def is_deterministic(self, allow_eps: bool = False) -> bool:
        for state_arcs in self.arcs:
            seen = set()
            for (i, _o, _w, _d) in state_arcs:
                if i == EPS and not allow_eps:
                    return False
                if i in seen:
                    return False
                seen.add(i)
        return True

    def shortest_distance(self, semiring: str = "tropical",
                          reverse: bool = False) -> np.ndarray:
        """Distances from start (or to finals if reverse).

        Generic shortest-distance with residual propagation (Mohri 2002):
        each state keeps its accumulated total d[s] plus a residual r[s] of
        mass not yet pushed to successors; only residuals propagate, so the
        log semiring sums every path exactly once (re-relaxing with the full
        total would double-count mass on states relaxed more than once)."""
        n = self.num_states
        d = np.full(n, INF)
        plus = min if semiring == "tropical" else log_plus
        if not reverse:
            adj = [[(w, dst) for (_i, _o, w, dst) in self.arcs[s]]
                   for s in range(n)]
            sources = [(self.start, 0.0)] if self.start >= 0 else []
        else:
            adj = [[] for _ in range(n)]
            for s in range(n):
                for (_i, _o, w, dst) in self.arcs[s]:
                    adj[dst].append((w, s))
            sources = list(self.finals.items())
        r: dict[int, float] = {}
        queue = deque()
        for s, w in sources:
            d[s] = plus(d[s], w)
            r[s] = plus(r.get(s, INF), w)
            queue.append(s)
        while queue:
            s = queue.popleft()
            rs = r.pop(s, None)
            if rs is None:
                continue
            for (w, nxt) in adj[s]:
                nw = rs + w
                nd = plus(d[nxt], nw)
                if nd < d[nxt] - 1e-12:
                    d[nxt] = nd
                    had = nxt in r
                    r[nxt] = plus(r.get(nxt, INF), nw)
                    if not had:
                        queue.append(nxt)
        return d

    def shortest_path(self):
        """Tropical single shortest path -> (ilabels, olabels, total_cost).

        Works for cyclic FSTs with nonnegative-ish costs via Dijkstra-like
        label-correcting search.
        """
        import heapq

        n = self.num_states
        dist = np.full(n, INF)
        par: list[tuple[int, tuple] | None] = [None] * n
        dist[self.start] = 0.0
        h = [(0.0, self.start)]
        while h:
            dcur, s = heapq.heappop(h)
            if dcur > dist[s] + 1e-12:
                continue
            for arc in self.arcs[s]:
                (_i, _o, w, nxt) = arc
                nd = dcur + w
                if nd < dist[nxt] - 1e-12:
                    dist[nxt] = nd
                    par[nxt] = (s, arc)
                    heapq.heappush(h, (nd, nxt))
        best_state, best_cost = -1, INF
        for s, w in self.finals.items():
            if dist[s] + w < best_cost:
                best_cost = dist[s] + w
                best_state = s
        if best_state < 0:
            return [], [], INF
        ilabels, olabels = [], []
        s = best_state
        while par[s] is not None:
            p, (i, o, w, _d) = par[s]
            if i != EPS:
                ilabels.append(i)
            if o != EPS:
                olabels.append(o)
            s = p
        return ilabels[::-1], olabels[::-1], best_cost

    # --- helpers used by graph building & tests ---

    @staticmethod
    def linear_acceptor(labels, cost: float = 0.0) -> "Fst":
        """(ref: fstext-utils.h:186 MakeLinearAcceptor)"""
        f = Fst()
        f.start = f.add_state()
        cur = f.start
        for lab in labels:
            nxt = f.add_state()
            f.add_arc(cur, int(lab), int(lab), 0.0, nxt)
            cur = nxt
        f.set_final(cur, cost)
        return f

    def get_linear_symbol_sequence(self):
        """For a linear FST: (ilabels, olabels, total cost)
        (ref: fstext-utils.h:135)."""
        ilabels, olabels = [], []
        s = self.start
        cost = 0.0
        visited = set()
        while s not in self.finals:
            assert s not in visited, "fst is not linear (cycle)"
            visited.add(s)
            assert len(self.arcs[s]) == 1, "fst is not linear"
            i, o, w, d = self.arcs[s][0]
            if i != EPS:
                ilabels.append(i)
            if o != EPS:
                olabels.append(o)
            cost += w
            s = d
        return ilabels, olabels, cost + self.finals[s]

    def paths(self, max_paths: int = 100000):
        """Enumerate all (ilabels, olabels, cost) paths — tests only (acyclic)."""
        out = []

        def rec(s, il, ol, c):
            if len(out) >= max_paths:
                return
            if s in self.finals:
                out.append((tuple(il), tuple(ol), c + self.finals[s]))
            for (i, o, w, d) in self.arcs[s]:
                rec(d, il + ([i] if i != EPS else []),
                    ol + ([o] if o != EPS else []), c + w)

        if self.start >= 0:
            rec(self.start, [], [], 0.0)
        return out

    def equivalent_paths(self, other: "Fst", tol=1e-3) -> bool:
        """Path-set equality for small acyclic FSTs (test oracle).

        Compares the tropical total weight of each (ilabels, olabels) pair.
        """
        def agg(paths):
            m: dict = {}
            for il, ol, c in paths:
                key = (il, ol)
                m[key] = min(m.get(key, INF), c)
            return m

        a, b = agg(self.paths()), agg(other.paths())
        if set(a) != set(b):
            return False
        return all(abs(a[k] - b[k]) < tol for k in a)

    def relabel(self, imap: dict | None = None, omap: dict | None = None):
        for s, state_arcs in enumerate(self.arcs):
            self.arcs[s] = [
                (imap.get(i, i) if imap else i,
                 omap.get(o, o) if omap else o, w, d)
                for (i, o, w, d) in state_arcs
            ]
        return self

    def reverse_topological_order(self):
        """Topological order (raises on cycles)."""
        n = self.num_states
        WHITE, GRAY, BLACK = 0, 1, 2
        color = [WHITE] * n
        order = []
        for root in range(n):
            if color[root] != WHITE:
                continue
            stack = [(root, 0)]
            color[root] = GRAY
            while stack:
                s, idx = stack[-1]
                if idx < len(self.arcs[s]):
                    stack[-1] = (s, idx + 1)
                    d = self.arcs[s][idx][3]
                    if color[d] == GRAY:
                        raise ValueError("fst has a cycle")
                    if color[d] == WHITE:
                        color[d] = GRAY
                        stack.append((d, 0))
                else:
                    color[s] = BLACK
                    order.append(s)
                    stack.pop()
        return order  # reverse topological

    def __repr__(self):
        return (f"Fst(states={self.num_states}, arcs={self.num_arcs}, "
                f"start={self.start}, finals={len(self.finals)})")

    def to_text(self, isyms=None, osyms=None) -> str:
        lines = []
        def istr(l): return isyms.sym(l) if isyms else str(l)
        def ostr(l): return osyms.sym(l) if osyms else str(l)
        order = [self.start] + [s for s in range(self.num_states) if s != self.start]
        for s in order:
            if s < 0:
                continue
            for (i, o, w, d) in self.arcs[s]:
                lines.append(f"{s} {d} {istr(i)} {ostr(o)} {w:.4f}")
            if s in self.finals:
                lines.append(f"{s} {self.finals[s]:.4f}")
        return "\n".join(lines)
