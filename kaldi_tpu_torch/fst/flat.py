"""Flat (CSR numpy-array) FST representation.

The mutable per-state-arc-list `Fst` is convenient for yesno-scale graph
algebra; production-scale HCLG builds (60k-word vocab, millions of arcs)
keep graphs in this columnar form end-to-end — the native graph ops
(native/fst_ops.cc) consume and produce it without per-arc Python
objects, and `pack_graph_flat` hands it straight to the decoder.

(ref: the role OpenFst's ConstFst plays for the reference — an immutable
 array-backed FST for the read-mostly stages of mkgraph.sh.)

The port's copy of kaldi_tpu/fst/flat.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BIG = np.float32(1e10)


@dataclasses.dataclass
class FlatFst:
    """Arcs grouped by source state; finals dense with BIG sentinel."""

    arc_start: np.ndarray   # [S+1] int64
    il: np.ndarray          # [A] int32
    ol: np.ndarray          # [A] int32
    w: np.ndarray           # [A] float32
    dst: np.ndarray         # [A] int32
    final: np.ndarray       # [S] float32 (BIG = not final)
    start: int

    @property
    def num_states(self) -> int:
        return len(self.final)

    @property
    def num_arcs(self) -> int:
        return len(self.il)

    def __repr__(self):
        nf = int((self.final < BIG * 0.5).sum())
        return (f"FlatFst(states={self.num_states}, arcs={self.num_arcs}, "
                f"start={self.start}, finals={nf})")

    @staticmethod
    def from_fst(fst) -> "FlatFst":
        S = fst.num_states
        deg = np.fromiter((len(a) for a in fst.arcs), np.int64, S)
        arc_start = np.zeros(S + 1, np.int64)
        np.cumsum(deg, out=arc_start[1:])
        A = int(arc_start[-1])
        il = np.empty(A, np.int32)
        ol = np.empty(A, np.int32)
        w = np.empty(A, np.float32)
        dst = np.empty(A, np.int32)
        pos = 0
        for arcs in fst.arcs:
            for (i, o, c, d) in arcs:
                il[pos] = i
                ol[pos] = o
                w[pos] = c
                dst[pos] = d
                pos += 1
        final = np.full(S, BIG, np.float32)
        for s, c in fst.finals.items():
            final[s] = c
        return FlatFst(arc_start, il, ol, w, dst, final, int(fst.start))

    def to_fst(self):
        from kaldi_tpu_torch.fst.fst import Fst
        f = Fst()
        for _ in range(self.num_states):
            f.add_state()
        bounds = self.arc_start
        for s in range(self.num_states):
            a0, a1 = int(bounds[s]), int(bounds[s + 1])
            f.arcs[s] = [
                (int(self.il[a]), int(self.ol[a]), float(self.w[a]),
                 int(self.dst[a])) for a in range(a0, a1)]
        alive = np.flatnonzero(self.final < BIG * 0.5)
        f.finals = {int(s): float(self.final[s]) for s in alive}
        f.start = int(self.start)
        return f

    def relabel(self, imap: dict | None = None,
                omap: dict | None = None) -> "FlatFst":
        """Vectorized label remapping (Fst.relabel semantics)."""
        il, ol = self.il, self.ol

        def apply(labels, m):
            if not m:
                return labels
            keys = np.fromiter(m.keys(), np.int32, len(m))
            vals = np.fromiter(m.values(), np.int32, len(m))
            lut_size = max(int(labels.max(initial=0)),
                           int(keys.max(initial=0))) + 1
            lut = np.arange(lut_size, dtype=np.int32)
            lut[keys] = vals
            return lut[labels]

        return dataclasses.replace(self, il=apply(il, imap or {}),
                                    ol=apply(ol, omap or {}))


def remove_symbols_flat(f: FlatFst, symbols) -> FlatFst:
    """Replace the given input labels by epsilon (fstrmsymbols,
    ref: fstbin/fstrmsymbols.cc) — vectorized."""
    syms = np.asarray(sorted(int(s) for s in symbols), np.int32)
    if len(syms) == 0:
        return f
    il = np.where(np.isin(f.il, syms), 0, f.il)
    return dataclasses.replace(f, il=il)
