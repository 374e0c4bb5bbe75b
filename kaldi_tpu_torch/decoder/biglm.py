"""Big-LM decoding: decode with a small-LM graph, swap in the big LM.

(ref: decoder/biglm-faster-decoder.h / lattice-biglm-faster-decoder.h —
 the reference composes HCLG(small G) with ΔG = G_small⁻¹ ∘ G_big as a
 DeterministicOnDemandFst during search. The TPU-native equivalent keeps
 the search program fixed-shape: decode against the small-LM HCLG to
 lattices, then exactly rescore (subtract the small G along lattice paths,
 add the big LM via the on-demand ConstArpaLm) — the steps/lmrescore*.sh
 pipeline fused into one call, mathematically the same posteriors over the
 retained lattice paths.)

The port's copy of kaldi_tpu/decoder/biglm.py. `decode_biglm` runs the
port's lattice-capable decoder (the padded `BeamSearchDecoder`) and
`decode_to_lattices` where that decoder runs, then the host rescoring of
JAX: the old G subtracted by `compose_lattice_with_lm(..., lm_scale=-1)`,
the new LM added by the scalar `lattice_lmrescore_const_arpa`.
`decode_biglm_exact` is JAX's unpruned host oracle, copied verbatim.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.lat.generate import decode_to_lattices
from kaldi_tpu_torch.lat.functions import (compose_lattice_with_lm,
                                           lattice_best_path)
from kaldi_tpu_torch.lm.const_arpa import (ConstArpaLm,
                                           lattice_lmrescore_const_arpa)


def decode_biglm(
    decoder,                 # BeamSearchDecoder (lattice-capable)
    loglikes, num_frames,
    old_g, backoff_label: int,
    new_lm: ConstArpaLm,
    lm_scale: float = 1.0,
    lattice_beam: float = 8.0,
):
    """-> list of (words, total_cost) per utterance, decoded under the big
    LM. old_g: the G FST the decoding graph was built with."""
    lats = decode_to_lattices(decoder, loglikes, num_frames,
                              lattice_beam=lattice_beam)
    out = []
    for lat in lats:
        if lat is None:
            out.append(None)
            continue
        # remove the small LM's scores, add the big LM's
        no_old = compose_lattice_with_lm(lat, old_g, backoff_label,
                                         lm_scale=-1.0)
        rescored = lattice_lmrescore_const_arpa(no_old, new_lm, lm_scale)
        res = lattice_best_path(rescored)
        out.append((res[0], res[2]) if res else None)
    return out


def decode_biglm_exact(
    graph,                   # PackedGraph built with old_g
    loglikes, num_frames,
    old_g, backoff_label: int,
    new_lm: ConstArpaLm,
    lm_scale: float = 1.0,
    acoustic_scale: float = 0.1,
):
    """Exact on-the-fly ΔG composition decode — the reference's
    BiglmFasterDecoder semantics (decoder/biglm-faster-decoder.h:38:
    tokens live in HCLG x ΔG where ΔG = old-G-negated ∘ new-LM as a
    DeterministicOnDemandFst). Host-side and unpruned: the correctness
    oracle that bounds decode_biglm's decode-then-rescore approximation
    (paths pruned under the small LM are unrecoverable there; here they
    are searched). -> list of (words, total_cost) per utterance."""
    import math

    # old-G deterministic stepper with backoff (phi) traversal
    old_arcs = []
    for s in range(old_g.num_states):
        d = {}
        backoff = None
        for (i, _o, w, dst) in old_g.arcs[s]:
            if i == backoff_label:
                backoff = (float(w), dst)
            else:
                d[i] = (float(w), dst)
        old_arcs.append((d, backoff))

    def old_step(s, word):
        """-> (next_state, cost) or None when the word is impossible
        under old G — the path then cannot exist in the HCLG and the
        token is dropped (NOT scored: subtracting a sentinel would make
        impossible paths infinitely good)."""
        cost = 0.0
        while True:
            d, backoff = old_arcs[s]
            if word in d:
                w, dst = d[word]
                return dst, cost + w
            if backoff is None:
                return None
            cost += backoff[0]
            s = backoff[1]

    def old_final(s):
        cost = 0.0
        while True:
            f = old_g.final(s)
            if math.isfinite(f):
                return cost + f
            backoff = old_arcs[s][1]
            if backoff is None:
                return None
            cost += backoff[0]
            s = backoff[1]

    if hasattr(loglikes, "cpu"):          # a tensor: the oracle is host code
        loglikes = loglikes.cpu().numpy()
    out = []
    B = loglikes.shape[0]
    nf = np.asarray(num_frames)
    for b in range(B):
        ll = loglikes[b, : nf[b]] * acoustic_scale
        T = ll.shape[0]
        # token key: (hclg_state, old_g_state, new_lm_state)
        tokens = {(graph.start, old_g.start, new_lm.start_state()):
                  (0.0, ())}

        def advance(key, cost, words, il_a, ol_a, w_arc, dst, am):
            """-> the improved token key, or None."""
            (s, go, gn) = key
            c = cost + w_arc + am
            ws = words
            if ol_a:
                stepped = old_step(go, ol_a)
                if stepped is None:
                    return None         # impossible under old G: drop
                go2, oldc = stepped
                gn2, newc = new_lm.step(gn, ol_a)
                c += lm_scale * newc - oldc
                ws = words + (ol_a,)
            else:
                go2, gn2 = go, gn
            nk = (dst, go2, gn2)
            cur = new_tokens.get(nk)
            if cur is None or c < cur[0] - 1e-12:
                new_tokens[nk] = (c, ws)
                return nk
            return None

        def eps_closure():
            agenda = list(new_tokens)
            while agenda:
                key = agenda.pop()
                cost, words = new_tokens[key]
                s = key[0]
                for a in range(graph.arc_start[s], graph.arc_start[s + 1]):
                    if graph.ilabel[a] != 0:
                        continue
                    nk = advance(key, cost, words, 0,
                                 int(graph.olabel[a]),
                                 float(graph.cost[a]),
                                 int(graph.nextstate[a]), 0.0)
                    if nk is not None:
                        agenda.append(nk)

        new_tokens = tokens
        eps_closure()
        tokens = new_tokens
        for t in range(T):
            new_tokens = {}
            for key, (cost, words) in tokens.items():
                s = key[0]
                for a in range(graph.arc_start[s],
                               graph.arc_start[s + 1]):
                    if graph.ilabel[a] == 0:
                        continue
                    am = -float(ll[t, int(graph.pdf[a])])
                    advance(key, cost, words, int(graph.ilabel[a]),
                            int(graph.olabel[a]), float(graph.cost[a]),
                            int(graph.nextstate[a]), am)
            eps_closure()
            tokens = new_tokens
            if not tokens:
                break
        best = None
        for (s, go, gn), (cost, words) in tokens.items():
            f = float(graph.final[s])
            if not math.isfinite(f):
                continue
            of = old_final(go)
            if of is None:
                continue               # final impossible under old G
            tot = cost + f + lm_scale * new_lm.final_cost(gn) - of
            if best is None or tot < best[1]:
                best = (list(words), tot)
        out.append(best)
    return out
