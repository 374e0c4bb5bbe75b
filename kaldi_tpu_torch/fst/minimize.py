"""Weighted minimization over encoded labels ("fstminimizeencoded").

(ref: fstbin/fstminimizeencoded.cc — encodes (ilabel, olabel, weight) into a
single label so the weighted transducer becomes an unweighted acceptor, then
minimizes by partition refinement and decodes back.)

We implement Moore-style partition refinement (signature hashing to a
fixpoint), which handles cyclic automata and is simple; complexity is
O(V·E·iters) — fine at decoding-graph scales here, and replaceable by a
C++ Hopcroft later without API change.

The port's copy of kaldi_tpu/fst/minimize.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

from kaldi_tpu_torch.fst.fst import Fst, INF


def minimize_encoded(fst: Fst) -> Fst:
    n = fst.num_states
    if n == 0:
        return fst
    # encode arc labels
    enc: dict[tuple, int] = {}

    def code(i, o, w):
        key = (i, o, round(w, 6))
        c = enc.get(key)
        if c is None:
            c = len(enc)
            enc[key] = c
        return c

    enc_arcs = [
        [(code(i, o, w), d) for (i, o, w, d) in arcs] for arcs in fst.arcs
    ]
    # initial partition: by finality (and final weight)
    part = {}
    block = [0] * n
    for s in range(n):
        key = round(fst.final(s), 6) if s in fst.finals else None
        b = part.setdefault(key, len(part))
        block[s] = b

    while True:
        sig_map: dict = {}
        new_block = [0] * n
        for s in range(n):
            sig = (block[s], tuple(sorted((c, block[d]) for (c, d) in enc_arcs[s])))
            b = sig_map.setdefault(sig, len(sig_map))
            new_block[s] = b
        if len(sig_map) == len(set(block)):
            break
        block = new_block

    num_blocks = len(set(block))
    if num_blocks == n:
        return fst
    out = Fst()
    for _ in range(num_blocks):
        out.add_state()
    out.start = block[fst.start]
    rep_done = set()
    for s in range(n):
        b = block[s]
        if b in rep_done:
            continue
        rep_done.add(b)
        for (i, o, w, d) in fst.arcs[s]:
            out.add_arc(b, i, o, w, block[d])
        if s in fst.finals:
            out.set_final(b, fst.finals[s])
    out.connect()
    return out
