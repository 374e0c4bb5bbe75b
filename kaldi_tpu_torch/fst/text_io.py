"""OpenFst-compatible text FST serialization.

(ref: the `fstcompile`/`fstprint` text interchange the reference's whole
 graph tooling speaks — arc lines `src dst ilabel olabel [weight]`,
 final lines `state [weight]`, the first line's source is the start
 state; optional symbol-table files map `symbol<TAB>id` like
 fst/symbol-table.h. Lets graphs round-trip with reference tooling for
 differential testing.)

The port's copy of kaldi_tpu/fst/text_io.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests/test_torch_*.py hold the two
equal.
"""

from __future__ import annotations

from kaldi_tpu_torch.fst.fst import Fst, SymbolTable


def read_symbols(path: str) -> dict:
    """symbol-table file -> {symbol: id}."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out


def write_fst_text(f, fst: Fst, isym: dict | None = None,
                   osym: dict | None = None):
    inv_i = {v: k for k, v in isym.items()} if isym else None
    inv_o = {v: k for k, v in osym.items()} if osym else None

    def il(x):
        return inv_i.get(x, str(x)) if inv_i else str(x)

    def ol(x):
        return inv_o.get(x, str(x)) if inv_o else str(x)

    if fst.start < 0:
        return
    order = [fst.start] + [s for s in range(fst.num_states)
                           if s != fst.start]
    for s in order:
        for (i, o, w, d) in fst.arcs[s]:
            if w:
                f.write(f"{s}\t{d}\t{il(i)}\t{ol(o)}\t{w:.7g}\n")
            else:
                f.write(f"{s}\t{d}\t{il(i)}\t{ol(o)}\n")
    for s in order:
        if s in fst.finals:
            w = fst.finals[s]
            f.write(f"{s}\t{w:.7g}\n" if w else f"{s}\n")


def read_fst_text(f, isym: dict | None = None,
                  osym: dict | None = None) -> Fst:
    """Parse OpenFst text; the first line's source state is the start."""
    fst = Fst()

    def ensure(n):
        while fst.num_states <= n:
            fst.add_state()

    def lab(tok, table):
        if table is not None and tok in table:
            return table[tok]
        return int(tok)

    for raw in f:
        line = raw.strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) >= 4:
            s, d = int(parts[0]), int(parts[1])
            ensure(max(s, d))
            w = float(parts[4]) if len(parts) > 4 else 0.0
            fst.add_arc(s, lab(parts[2], isym), lab(parts[3], osym), w, d)
        elif len(parts) <= 2:
            s = int(parts[0])
            ensure(s)
            fst.set_final(s, float(parts[1]) if len(parts) > 1 else 0.0)
        else:
            raise ValueError(f"bad FST text line: {line}")
        if fst.start < 0:
            fst.start = int(parts[0])
    return fst


def load_fst(path: str, isymbols: str = "", osymbols: str = "") -> Fst:
    isym = read_symbols(isymbols) if isymbols else None
    osym = read_symbols(osymbols) if osymbols else None
    with open(path) as f:
        return read_fst_text(f, isym, osym)


def save_fst(path: str, fst: Fst):
    with open(path, "w") as f:
        write_fst_text(f, fst)
