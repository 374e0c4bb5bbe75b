"""Factor an FST into chain symbols + a chain-expansion transducer.

(ref: fstext/factor.h Factor() — replace maximal linear chains of arcs
 with single arcs over fresh factor symbols, so big training graphs
 store compactly; the second output maps each factor symbol back to the
 original input-label sequence. Reconstruction contract:
 compose(expander, factored) == original (modulo state numbering).)

The port's copy of kaldi_tpu/fst/factor.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests/test_torch_*.py hold the two
equal.
"""

from __future__ import annotations

from kaldi_tpu_torch.fst.fst import Fst, INF


def factor(f: Fst):
    """-> (factored, expander). `factored` is f with every maximal
    linear chain collapsed to one arc whose ilabel indexes a chain;
    `expander` is a one-state transducer whose paths map each chain's
    original ilabel sequence to its factor symbol (ilabels original,
    olabel = factor symbol on the first arc), so
    compose(expander, factored) reproduces f. Chains keep their
    olabels only if epsilon-free chains aren't broken: arcs with
    nonzero olabels terminate a chain (olabels must survive factoring
    intact, ref: factor.h requirement that fst be olabel-free on
    factored arcs)."""
    n = f.num_states
    in_deg = [0] * n
    for s in range(n):
        for (_i, _o, _w, d) in f.arcs[s]:
            in_deg[d] += 1

    def chainable(s: int) -> bool:
        """Interior chain state: one in, one out, not final/start."""
        return (s != f.start and in_deg[s] == 1
                and len(f.arcs[s]) == 1 and f.final(s) >= INF
                and f.arcs[s][0][1] == 0)

    factored = Fst()
    for _ in range(n):
        factored.add_state()
    factored.start = f.start
    for s in range(n):
        fw = f.final(s)
        if fw < INF:
            factored.set_final(s, fw)

    seqs: dict[tuple, int] = {}
    next_sym = [1]

    def seq_sym(seq: tuple) -> int:
        k = seqs.get(seq)
        if k is None:
            k = next_sym[0]
            next_sym[0] += 1
            seqs[seq] = k
        return k

    visited_from = [False] * n
    for s in range(n):
        if chainable(s):
            continue
        if visited_from[s]:
            continue
        visited_from[s] = True
        for (il, ol, w, d) in f.arcs[s]:
            seq = [il]
            cost = w
            olab = ol
            cur = d
            while chainable(cur):
                (il2, _o2, w2, d2) = f.arcs[cur][0]
                seq.append(il2)
                cost += w2
                cur = d2
            factored.add_arc(s, seq_sym(tuple(seq)), olab, cost, cur)

    expander = Fst()
    root = expander.add_state()
    expander.start = root
    expander.set_final(root, 0.0)
    for seq, sym in seqs.items():
        src = root
        for i, il in enumerate(seq):
            dst = root if i == len(seq) - 1 else expander.add_state()
            expander.add_arc(src, il, sym if i == 0 else 0, 0.0, dst)
            src = dst
    factored.connect()
    return factored, expander
