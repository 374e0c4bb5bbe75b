"""Lattice/alignment surgery: phone & word time alignment, oracle WER,
confidence, weight pushing, minimization, union, interpolation.

(ref: lat/word-align-lattice.h, lat/phone-align-lattice.h,
 latbin/lattice-oracle.cc, lat/confidence.h, lat/push-lattice.h,
 lat/minimize-lattice.h, latbin/lattice-union.cc, latbin/lattice-interp.cc,
 bin/ali-to-phones.cc, latbin/nbest-to-ctm.cc.)

The port's copy of kaldi_tpu/lat/align.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.lat.lattice import Lattice, LatticeArc
from kaldi_tpu_torch.lat.functions import lattice_best_path
from kaldi_tpu_torch.lat.posteriors import lattice_state_times

INF = float("inf")


# ---------- path-level alignment (ali-to-phones / nbest-to-ctm) ----------

def ali_to_phones(tm, tids, frame_shift: float = 0.01,
                  per_frame: bool = False):
    """Transition-id alignment -> [(phone, t_begin, duration)] in frames
    (ref: bin/ali-to-phones.cc --write-lengths semantics). A new phone
    starts wherever the tid is not a self-loop and its hmm-state is 0."""
    segs = []
    cur_phone, start = None, 0
    for t, tid in enumerate(tids):
        tid = int(tid)
        ph = tm.transition_id_to_phone(tid)
        is_start = (tm.transition_id_to_hmm_state(tid) == 0
                    and not tm.is_self_loop(tid))
        if cur_phone is None:
            cur_phone, start = ph, t
        elif is_start or ph != cur_phone:
            segs.append((cur_phone, start, t - start))
            cur_phone, start = ph, t
    if cur_phone is not None:
        segs.append((cur_phone, start, len(tids) - start))
    if per_frame:
        out = []
        for (ph, s, d) in segs:
            out.extend([ph] * d)
        return out
    return segs


def words_to_ctm(tids, words, tm, lexicon_phones, silence_phones=frozenset(),
                 frame_shift: float = 0.01):
    """Best-path word timing: [(word, t_begin_frames, duration_frames)].

    Greedy left-to-right assignment of the path's phone segments to each
    word's pronunciation (ref: latbin/nbest-to-ctm.cc via word-aligned
    lattices; lexicon_phones: word -> list of possible phone tuples)."""
    phone_segs = ali_to_phones(tm, tids)
    out = []
    i = 0  # index into phone_segs
    for w in words:
        # skip leading silence
        while i < len(phone_segs) and phone_segs[i][0] in silence_phones:
            i += 1
        prons = lexicon_phones.get(w, [])
        matched = None
        for pron in prons:
            n = len(pron)
            got = tuple(p for (p, _s, _d) in phone_segs[i: i + n])
            if got == tuple(pron):
                matched = n
                break
        if matched is None:
            # fall back: consume one phone segment
            matched = 1 if i < len(phone_segs) else 0
        if matched == 0:
            continue
        t0 = phone_segs[i][1]
        t1 = phone_segs[i + matched - 1][1] + phone_segs[i + matched - 1][2]
        out.append((w, t0, t1 - t0))
        i += matched
    return out


# ---------- lattice word alignment ----------

def word_align_lattice(lat: Lattice, tm, lexicon_phones,
                       silence_phones=frozenset()):
    """Re-arc a (tid,word) lattice so every arc carries exactly one word
    spanning its true frames; eps arcs carry silence.

    (ref: lat/word-align-lattice.h WordAlignLattice. The reference splits
    states with word-boundary info; we re-derive the same output by
    expanding states with a (pending word) tag and emitting the word on
    the arc that completes its pronunciation.)
    """
    out = Lattice()
    # state key: (lat_state, pending_word or 0, consumed-phone tuple)
    key2id: dict = {}
    max_pron = max((len(p) for prons in lexicon_phones.values()
                    for p in prons), default=0)

    def get(key):
        s = key2id.get(key)
        if s is None:
            s = out.add_state()
            key2id[key] = s
        return s

    from collections import deque
    start_key = (lat.start, 0, ())
    out.start = get(start_key)
    seen = {start_key}
    q = deque([start_key])
    while q:
        key = q.popleft()
        ls, pending, nph = key
        cur = key2id[key]
        if ls in lat.finals and pending == 0:
            g, a = lat.finals[ls]
            out.set_final(get(key), g, a)
        for arc in lat.arcs[ls]:
            w = arc.olabel
            new_pending, new_nph = pending, nph
            emit = 0
            if w != 0:
                if pending != 0:
                    # shouldn't happen in well-formed lattices; emit old
                    emit = pending
                new_pending = w
                new_nph = ()
            if arc.ilabel != 0:
                tid = arc.ilabel
                is_final_of_phone = tm.is_final(tid)
                if is_final_of_phone and new_pending != 0:
                    ph = tm.transition_id_to_phone(tid)
                    if ph not in silence_phones:
                        new_nph = new_nph + (ph,)
                    prons = lexicon_phones.get(new_pending, [])
                    # emit only on an EXACT pronunciation match (identity,
                    # not count — words may have prons of several lengths)
                    if any(tuple(p) == new_nph for p in prons):
                        emit = new_pending
                        new_pending, new_nph = 0, ()
                    elif len(new_nph) >= max_pron:
                        continue    # dead path: no pron can match
            nkey = (arc.nextstate, new_pending, new_nph)
            dst = get(nkey)
            out.add_arc(cur, arc.ilabel, emit, arc.graph_cost,
                        arc.acoustic_cost, dst)
            if nkey not in seen:
                seen.add(nkey)
                q.append(nkey)
    return out.connect()


# ---------- oracle ----------

def lattice_oracle(lat: Lattice, ref_words):
    """Minimum word edit distance of any lattice path vs the reference
    (ref: latbin/lattice-oracle.cc — composes with an edit-distance FST;
    here the equivalent DP over (lattice state, ref position)).

    -> (min_edits, oracle_word_sequence)."""
    n = lat.num_states
    R = len(ref_words)
    order = lat.topological_order()
    # dp[s][j] = min edits to reach state s having consumed j ref words
    dp = np.full((n, R + 1), np.inf)
    back: dict = {}
    dp[lat.start, 0] = 0.0
    # allow deletions of ref words at any state: handled as we pop states
    for s in order:
        for j in range(R + 1):
            if not np.isfinite(dp[s, j]):
                continue
            # deletion (skip ref word): stay at s
            if j < R and dp[s, j] + 1 < dp[s, j + 1]:
                dp[s, j + 1] = dp[s, j] + 1
                back[(s, j + 1)] = (s, j, None, "del")
        for j in range(R + 1):
            if not np.isfinite(dp[s, j]):
                continue
            for a in lat.arcs[s]:
                t = a.nextstate
                if a.olabel == 0:
                    if dp[s, j] < dp[t, j]:
                        dp[t, j] = dp[s, j]
                        back[(t, j)] = (s, j, a, "eps")
                    continue
                # substitution-or-match against ref[j]
                if j < R:
                    c = 0.0 if a.olabel == ref_words[j] else 1.0
                    if dp[s, j] + c < dp[t, j + 1]:
                        dp[t, j + 1] = dp[s, j] + c
                        back[(t, j + 1)] = (s, j, a, "mat" if c == 0 else "sub")
                # insertion (hyp word with no ref)
                if dp[s, j] + 1 < dp[t, j]:
                    dp[t, j] = dp[s, j] + 1
                    back[(t, j)] = (s, j, a, "ins")
    best = (np.inf, None)
    for s in lat.finals:
        if dp[s, R] < best[0]:
            best = (dp[s, R], s)
    if best[1] is None:
        return np.inf, []
    # traceback for the oracle hypothesis
    words = []
    s, j = best[1], R
    while (s, j) != (lat.start, 0):
        if (s, j) not in back:
            break
        ps, pj, a, _op = back[(s, j)]
        if a is not None and a.olabel != 0:
            words.append(a.olabel)
        s, j = ps, pj
    return float(best[0]), words[::-1]


# ---------- confidence ----------

def lattice_confidence(lat: Lattice) -> float:
    """Cost difference between the best path and the best path with a
    DIFFERENT word sequence (ref: lat/confidence.h SentenceLevelConfidence).
    Returns +inf when only one word sequence exists.

    Computed over the word-level determinization (one path per word
    sequence) — enumerating raw alignments would miss the competitor when
    the best sequence has many alignments within the beam."""
    from kaldi_tpu_torch.lat.functions import (nbest, determinize_lattice,
                                         DeterminizeLatticeOverflow)
    try:
        det = determinize_lattice(lat)
        paths = nbest(det, 2)
    except DeterminizeLatticeOverflow:
        # blowup valve tripped: scan raw n-best for the first competitor
        # with a DIFFERENT word sequence (bounded approximation)
        raw = nbest(lat, 200)
        if not raw:
            return 0.0
        first = tuple(raw[0][0])
        for cand in raw[1:]:
            if tuple(cand[0]) != first:
                return float(cand[2] - raw[0][2])
        return INF
    if not paths:
        return 0.0
    if len(paths) == 1:
        return INF
    return float(paths[1][2] - paths[0][2])


# ---------- pushing / minimization / union / interpolation ----------

def push_lattice(lat: Lattice) -> Lattice:
    """Push weights toward the initial state (tropical reweighting:
    w'(s→t) = w + β(t) − β(s) with β = min cost-to-final; ref:
    lat/push-lattice.h PushCompactLatticeWeights)."""
    n = lat.num_states
    order = lat.topological_order()
    beta = np.full(n, INF)
    for s, (g, a) in lat.finals.items():
        beta[s] = g + a
    for s in reversed(order):
        for a in lat.arcs[s]:
            beta[s] = min(beta[s], a.cost + beta[a.nextstate])
    out = Lattice()
    for _ in range(n):
        out.add_state()
    out.start = lat.start
    for s in range(n):
        if not np.isfinite(beta[s]):
            continue
        for a in lat.arcs[s]:
            if not np.isfinite(beta[a.nextstate]):
                continue
            # reweight on the graph part; total path cost is preserved by
            # adding β(start) back onto arcs leaving the start state
            delta = beta[a.nextstate] - beta[s]
            if s == lat.start:
                delta += beta[lat.start]
            out.add_arc(s, a.ilabel, a.olabel, a.graph_cost + delta,
                        a.acoustic_cost, a.nextstate)
    # totals: g' + a = g + a − β(s) (+β(start) at the start); the
    # reweighting delta lives on the GRAPH part so the acoustic component
    # is preserved for downstream lattice_scale / forward-backward
    for s, (g, ac) in lat.finals.items():
        extra = beta[lat.start] if s == lat.start else 0.0
        out.set_final(s, g - beta[s] + extra, ac)
    return out


def minimize_lattice(lat: Lattice) -> Lattice:
    """Suffix-sharing state merge (ref: lat/minimize-lattice.h
    MinimizeCompactLattice): states with identical outgoing signatures
    (arcs + finality) merge, iterated to fixpoint bottom-up."""
    n = lat.num_states
    order = lat.topological_order()
    rep = np.arange(n)
    changed = True
    while changed:
        changed = False
        sig: dict = {}
        for s in reversed(order):
            key = (
                tuple(sorted((a.ilabel, a.olabel, round(a.graph_cost, 9),
                              round(a.acoustic_cost, 9),
                              int(rep[a.nextstate]))
                             for a in lat.arcs[s])),
                (round(lat.finals[s][0], 9), round(lat.finals[s][1], 9))
                if s in lat.finals else None,
            )
            if key in sig:
                if rep[s] != sig[key]:
                    rep[s] = sig[key]
                    changed = True
            else:
                sig[key] = int(rep[s])
    out = Lattice()
    remap: dict = {}

    def get(s):
        r = int(rep[s])
        if r not in remap:
            remap[r] = out.add_state()
        return remap[r]

    out.start = get(lat.start)
    done = set()
    for s in range(n):
        r = int(rep[s])
        if r in done or rep[s] != s and s != r:
            continue
        done.add(r)
        cur = get(s)
        for a in lat.arcs[s]:
            out.add_arc(cur, a.ilabel, a.olabel, a.graph_cost,
                        a.acoustic_cost, get(a.nextstate))
        if s in lat.finals:
            out.set_final(cur, *lat.finals[s])
    return out.connect()


def lattice_union(a: Lattice, b: Lattice) -> Lattice:
    """(ref: latbin/lattice-union.cc)"""
    out = Lattice()
    out.start = out.add_state()
    for src in (a, b):
        if src.start < 0 or src.num_states == 0:
            continue            # empty operand contributes nothing
        off = out.num_states
        for _ in range(src.num_states):
            out.add_state()
        out.add_arc(out.start, 0, 0, 0.0, 0.0, off + src.start)
        for s in range(src.num_states):
            for arc in src.arcs[s]:
                out.add_arc(off + s, arc.ilabel, arc.olabel, arc.graph_cost,
                            arc.acoustic_cost, off + arc.nextstate)
        for s, (g, ac) in src.finals.items():
            out.set_final(off + s, g, ac)
    return out


def lattice_interp(a: Lattice, b: Lattice, alpha: float = 0.5):
    """Score-level interpolation on common word sequences
    (ref: latbin/lattice-interp.cc — composes a with the word-level b;
    paths absent from b are dropped). Path costs become
    α·cost_a + (1−α)·cost_b, implemented on the word-sequence level."""
    from kaldi_tpu_torch.lat.functions import nbest
    pa = nbest(a, 128)
    pb = {tuple(w): c for (w, _t, c) in nbest(b, 1024)}
    out = Lattice()
    out.start = out.add_state()
    found = False
    for (w, tids, ca) in pa:
        key = tuple(w)
        if key not in pb:
            continue
        found = True
        cost = alpha * ca + (1 - alpha) * pb[key]
        cur = out.start
        for wd in w:
            ns = out.add_state()
            out.add_arc(cur, 0, wd, 0.0, 0.0, ns)
            cur = ns
        term = out.add_state()
        out.add_arc(cur, 0, 0, cost, 0.0, term)
        out.set_final(term)
    return out if found else None


def phone_align_lattice(lat: Lattice, tm, replace_output_symbols=False):
    """Re-arc a tid-level lattice so every arc spans exactly one phone
    instance (phone boundaries = arc boundaries).

    (ref: lat/phone-align-lattice.h PhoneAlignLattice — mid-phone lattice
    states are split away; each output arc carries one whole phone's tids
    with summed costs, the word olabel of the first merged arc — or the
    phone id with replace_output_symbols, like --replace-output-symbols.)

    Output states exist only at phone boundaries; a BFS item carries
    (lattice state, buffered arcs of the open phone, origin out-state).
    A phone is complete when its final transition-id has been buffered
    and (reordered convention) any trailing self-loops of that final
    transition state have been swallowed.
    """
    from collections import deque

    out = Lattice()
    key2id: dict = {}

    def get(ls):
        s = key2id.get(ls)
        if s is None:
            s = out.add_state()
            key2id[ls] = s
        return s

    def final_ts(buf):
        for (t, _o, _g, _a) in buf:
            if t and tm.is_final(t):
                return tm.transition_id_to_transition_state(t)
        return None

    emitted: set = set()

    def add_arc_once(src, il, ol, gc, ac, dst, tids=None):
        """Converging BFS items can ask for the same output arc (e.g.
        two items flushing the same completed phone at a multi-fanout
        state, or the same eps arc from a shared boundary state) —
        dedup so path multiplicity is preserved exactly."""
        key = (src, il, ol, round(gc, 9), round(ac, 9), dst, tids)
        if key in emitted:
            return
        emitted.add(key)
        out.add_arc(src, il, ol, gc, ac, dst)
        if tids is not None:
            out.arcs[src][-1].tids = tids

    def flush(origin, buf, dst_ls):
        # eps (tid 0) entries are graph arcs swallowed mid-phone; they
        # contribute weight/olabel but are not part of the phone's tids
        tids = tuple(t for (t, _o, _g, _a) in buf if t)
        gc = sum(g for (_t, _o, g, _a) in buf)
        ac = sum(a for (_t, _o, _g, a) in buf)
        ol = next((o for (_t, o, _g, _a) in buf if o != 0), 0)
        dst = get(dst_ls)
        if not tids:           # weight/word-only buffer: emit an eps arc
            add_arc_once(origin, 0, ol, gc, ac, dst)
            return dst
        if replace_output_symbols:
            ol = tm.transition_id_to_phone(tids[0])
        add_arc_once(origin, tids[0], ol, gc, ac, dst, tids)
        return dst

    out.start = get(lat.start)
    items = deque([(lat.start, (), get(lat.start))])
    seen = {(lat.start, (), get(lat.start))}

    def push(item):
        if item not in seen:
            seen.add(item)
            items.append(item)

    while items:
        ls, buf, origin = items.popleft()
        if ls in lat.finals and not buf:
            g, a = lat.finals[ls]
            out.set_final(key2id[ls], g, a)
        fts = final_ts(buf)
        for arc in lat.arcs[ls]:
            info = (arc.ilabel, arc.olabel, arc.graph_cost,
                    arc.acoustic_cost)
            if arc.ilabel == 0:
                if buf and fts is None:
                    # mid-phone graph eps (word arcs, HCLG back-arcs):
                    # swallow its weight/word into the open phone, like
                    # the reference aligner's ComputationState
                    push((arc.nextstate, buf + (info,), origin))
                    continue
                if buf:
                    origin2 = flush(origin, buf, ls)
                else:
                    origin2 = origin
                dst = get(arc.nextstate)
                add_arc_once(origin2, 0, arc.olabel, arc.graph_cost,
                             arc.acoustic_cost, dst)
                push((arc.nextstate, (), dst))
                continue
            tid = arc.ilabel
            if fts is not None:
                # open phone is complete; this tid either extends it
                # (trailing self-loop of the final transition state,
                # reordered convention) or starts the next phone
                if (tm.is_self_loop(tid)
                        and tm.transition_id_to_transition_state(tid)
                        == fts):
                    push((arc.nextstate, buf + (info,), origin))
                else:
                    origin2 = flush(origin, buf, ls)
                    push((arc.nextstate, (info,), origin2))
            else:
                push((arc.nextstate, buf + (info,), origin))
        # a phone ending at a final lattice state — complete, or truncated
        # by the end of the utterance (the reference emits partial phones
        # too, flagging error_state_; we keep them silently)
        if buf and ls in lat.finals:
            dst = flush(origin, buf, ls)
            g, a = lat.finals[ls]
            out.set_final(dst, g, a)
    return out.connect()
