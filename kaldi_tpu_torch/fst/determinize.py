"""Determinization with epsilon-closure and output-string divisors
("determinize-star").

(ref: fstext/determinize-star.h:86 DeterminizeStar — subset construction
where each determinized state is a normalized set of
(state, residual-weight, residual-output-string); input-epsilons are closed
over; common weight divisors and longest-common-prefix output strings are
emitted eagerly. --use-log corresponds to summing weights in the log
semiring, which preserves stochasticity of the composed graphs.)

This is our own implementation of the algorithm's semantics; output strings
longer than one label are emitted through chains of input-epsilon arcs,
like the reference.

The port's copy of kaldi_tpu/fst/determinize.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

from collections import deque

from kaldi_tpu_torch.fst.fst import Fst, EPS, INF, log_plus

_ROUND = 1e-6


def _norm_weight(w: float) -> float:
    return round(w / _ROUND) * _ROUND


def determinize_star(ifst: Fst, use_log: bool = False,
                     max_states: int = 10_000_000) -> Fst:
    plus = log_plus if use_log else min
    arcs = ifst.arcs

    def eps_closure(elements):
        """elements: dict (state) -> (weight, ostring). Close over input-eps.

        Generic single-source shortest-distance (Mohri 2002): each state
        carries its accumulated total d and a not-yet-propagated residual r;
        only residuals are pushed along arcs. Propagating the full total on
        re-relaxation would double-count mass in the log semiring (every
        re-pop of a state re-adds the already-propagated part downstream).
        """
        d = dict(elements)
        r = {s: w for s, (w, _str) in elements.items()}
        agenda = deque(elements.keys())
        passes = 0
        limit = 100 * (len(arcs) + 10)
        while agenda:
            passes += 1
            if passes > limit:
                raise RuntimeError("epsilon cycle detected in determinize-star")
            s = agenda.popleft()
            rs = r.pop(s, None)
            if rs is None:
                continue
            ostr = d[s][1]
            for (i, o, aw, dst) in arcs[s]:
                if i != EPS:
                    continue
                nw = rs + aw
                nstr = ostr + ((o,) if o != EPS else ())
                if dst in d:
                    ow, ostr_d = d[dst]
                    if nstr != ostr_d and nw < INF and ow < INF:
                        raise RuntimeError(
                            "determinize-star: input FST is not functional "
                            f"(distinct output strings {ostr_d} and {nstr} "
                            f"reach state {dst} over the same input); add "
                            "disambiguation symbols")
                    cw = plus(ow, nw)
                    if cw < ow - 1e-12:
                        d[dst] = (cw, ostr_d)
                        r[dst] = plus(r.get(dst, INF), nw)
                        agenda.append(dst)
                else:
                    d[dst] = (nw, nstr)
                    r[dst] = nw
                    agenda.append(dst)
        return d

    def normalize(elements):
        """Subtract common divisor; strip common output prefix.

        -> (key, common_weight, common_prefix, residual dict)
        """
        if not elements:
            return None, INF, (), {}
        common_w = INF
        for (w, _s) in elements.values():
            common_w = plus(common_w, w)
        strings = [s for (_w, s) in elements.values()]
        prefix = strings[0]
        for s in strings[1:]:
            k = 0
            while k < len(prefix) and k < len(s) and prefix[k] == s[k]:
                k += 1
            prefix = prefix[:k]
        p = len(prefix)
        resid = {st: (_norm_weight(w - common_w), s[p:])
                 for st, (w, s) in elements.items()}
        key = tuple(sorted((st, w, s) for st, (w, s) in resid.items()))
        return key, common_w, prefix, resid

    out = Fst()
    subset_id: dict = {}
    subsets: dict[int, dict] = {}

    def get_subset(key, resid):
        sid = subset_id.get(key)
        if sid is None:
            sid = out.add_state()
            if sid > max_states:
                raise RuntimeError("determinize-star exceeded max states")
            subset_id[key] = sid
            subsets[sid] = resid
            agenda.append(sid)
        return sid

    def emit_chain(src, ilabel, ostring, w, dst):
        """Arc emitting possibly-multiple output labels via eps chain."""
        if len(ostring) == 0:
            out.add_arc(src, ilabel, EPS, w, dst)
            return
        cur = src
        for k, o in enumerate(ostring):
            last = k == len(ostring) - 1
            nxt = dst if last else out.add_state()
            out.add_arc(cur, ilabel if k == 0 else EPS, o,
                        w if k == 0 else 0.0, nxt)
            cur = nxt

    if ifst.start < 0:
        return out
    agenda: deque = deque()
    init = eps_closure({ifst.start: (0.0, ())})
    key, w0, prefix0, resid0 = normalize(init)
    # initial common weight/prefix must be empty for a well-formed start;
    # fold them into a dedicated start state if not.
    out.start = get_subset(key, resid0)
    if abs(w0) > 1e-9 or prefix0:
        real_start = out.add_state()
        emit_chain(real_start, EPS, prefix0, w0, out.start)
        out.start = real_start

    while agenda:
        sid = agenda.popleft()
        resid = subsets[sid]
        # final handling: emit residual strings through eps chains
        final_groups: dict[tuple, float] = {}
        for st, (w, s) in resid.items():
            fw = ifst.final(st)
            if fw < INF:
                tot = w + fw
                final_groups[s] = plus(final_groups.get(s, INF), tot)
        for s, w in final_groups.items():
            if not s:
                out.set_final(sid, w)
            else:
                tail = out.add_state()
                out.set_final(tail, 0.0)
                emit_chain(sid, EPS, s, w, tail)
        # gather outgoing non-eps labels
        by_label: dict[int, dict] = {}
        for st, (w, s) in resid.items():
            for (i, o, aw, d) in arcs[st]:
                if i == EPS:
                    continue
                elems = by_label.setdefault(i, {})
                nw = w + aw
                nstr = s + ((o,) if o != EPS else ())
                if d in elems:
                    ow, ostr = elems[d]
                    if nstr != ostr and nw < INF and ow < INF:
                        raise RuntimeError(
                            "determinize-star: input FST is not functional "
                            f"(distinct output strings {ostr} and {nstr} "
                            f"reach state {d} over the same input); add "
                            "disambiguation symbols")
                    elems[d] = (plus(ow, nw), ostr)
                else:
                    elems[d] = (nw, nstr)
        for ilabel in sorted(by_label):
            elems = eps_closure(by_label[ilabel])
            key, w, prefix, resid2 = normalize(elems)
            dst = get_subset(key, resid2)
            emit_chain(sid, ilabel, prefix, w, dst)

    return out
