"""Lattice → keyword index and search.

(ref: kwsbin/lattice-to-kws-index.cc + kws/kws-functions.h:89-97: the
 reference turns each utterance lattice into a timed factor transducer
 whose paths are all word-sequence factors, weighted in a lexicographic
 (−log posterior, t_start, t_end) semiring, then unions/optimizes indexes
 and searches by composing the keyword FST (kwsbin/kws-search.cc).

 Same capability, array-first design: we keep per-utterance CSR-style arc
 tables (word, t_begin, t_end, alpha-prefix, beta-suffix, next-state) with
 posteriors from the lattice forward-backward. A keyword search is a
 vectorized match on the first word's arc set followed by a short DP join
 for subsequent words — equivalent to composing with the factor
 transducer, without materializing all O(V²) factors.)

The port's copy of kaldi_tpu/kws/index.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from kaldi_tpu_torch.lat.lattice import Lattice
from kaldi_tpu_torch.lat.functions import lattice_forward_backward
from kaldi_tpu_torch.lat.posteriors import lattice_state_times

INF = float("inf")


@dataclasses.dataclass
class KwsIndex:
    """Per-utterance factor index. Word arcs flattened to parallel arrays."""
    utt_id: str
    num_frames: int
    # word arcs
    word: np.ndarray        # [A] word id
    t_begin: np.ndarray     # [A] start frame of the word arc
    t_end: np.ndarray       # [A] end frame
    src: np.ndarray         # [A] lattice state the arc leaves
    dst: np.ndarray         # [A] lattice state it enters
    logp: np.ndarray        # [A] -log posterior contribution of the arc path
    alpha: np.ndarray       # [S] forward log-prob per state
    beta: np.ndarray        # [S] backward log-prob per state
    tot: float              # total log-likelihood
    # eps-closure: for factor joining, dst -> states reachable via eps arcs
    eps_next: dict          # state -> list[(state, logp)]
    word_arcs_from: dict    # state -> list of arc indices starting there


def lattice_to_kws_index(lat: Lattice, utt_id: str,
                         word_times: bool = True) -> KwsIndex:
    """Build the factor index for one (word-level or tid-level) lattice.

    Arc time span: for a word-level lattice the arc's own frames; the
    reference first word-aligns lattices (lattice-align-words) so each
    word arc spans its true frames — we require state times only.
    """
    times, T = lattice_state_times(lat)
    _post, tot, alpha, beta = lattice_forward_backward(lat)

    word, tb, te, src, dst, logp = [], [], [], [], [], []
    eps_next: dict = {}
    word_arcs_from: dict = {}
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            if a.olabel == 0:
                eps_next.setdefault(s, []).append(
                    (a.nextstate, -a.cost))
                continue
            i = len(word)
            word.append(a.olabel)
            tb.append(int(times[s]))
            te.append(int(times[a.nextstate]))
            src.append(s)
            dst.append(a.nextstate)
            logp.append(-a.cost)
            word_arcs_from.setdefault(s, []).append(i)
    return KwsIndex(
        utt_id=utt_id, num_frames=T,
        word=np.asarray(word, np.int64),
        t_begin=np.asarray(tb, np.int64), t_end=np.asarray(te, np.int64),
        src=np.asarray(src, np.int64), dst=np.asarray(dst, np.int64),
        logp=np.asarray(logp), alpha=alpha, beta=beta, tot=tot,
        eps_next=eps_next, word_arcs_from=word_arcs_from)


def _eps_closure(index: KwsIndex, state: int):
    """[(state, logp)] reachable from `state` via eps arcs (incl. itself)."""
    out = {state: 0.0}
    stack = [(state, 0.0)]
    while stack:
        s, lp = stack.pop()
        for (ns, alp) in index.eps_next.get(s, ()):
            nl = lp + alp
            if ns not in out or nl > out[ns]:
                out[ns] = nl
                stack.append((ns, nl))
    return list(out.items())


def search_index(indexes, keyword, merge_tolerance: int = 50):
    """Search a multi-word keyword (list of word ids) over utterance
    indexes. -> [(utt_id, t_begin, t_end, posterior)] sorted by score
    (ref: kwsbin/kws-search.cc; posterior = sum over lattice paths
    containing the factor, clipped to 1).

    Overlapping hits of the same keyword within `merge_tolerance` frames
    are merged, keeping summed posterior (the reference's index
    optimization does the same via determinization in the log semiring).
    """
    hits = []
    for index in indexes:
        raw = []
        first = np.nonzero(index.word == keyword[0])[0]
        for i in first:
            # paths: log-sum over continuations matching the rest
            partials = [(float(index.logp[i]), int(index.dst[i]),
                         int(index.t_end[i]))]
            for w in keyword[1:]:
                nxt = []
                for (lp, s, _te) in partials:
                    for (es, elp) in _eps_closure(index, s):
                        for j in index.word_arcs_from.get(es, ()):
                            if index.word[j] != w:
                                continue
                            nxt.append((lp + elp + float(index.logp[j]),
                                        int(index.dst[j]),
                                        int(index.t_end[j])))
                partials = nxt
                if not partials:
                    break
            if not partials:
                continue
            # posterior of the factor: alpha(src) + path + beta(end) - tot
            s0 = int(index.src[i])
            t0 = int(index.t_begin[i])
            by_end: dict = {}
            for (lp, s_end, te) in partials:
                tot_lp = index.alpha[s0] + lp + index.beta[s_end] - index.tot
                key = te
                prev = by_end.get(key, -INF)
                by_end[key] = np.logaddexp(prev, tot_lp)
            for te, lp in by_end.items():
                raw.append((t0, te, math.exp(min(lp, 0.0))))
        # merge hits with close-by start times
        raw.sort()
        merged = []
        for (t0, te, p) in raw:
            if merged and t0 - merged[-1][0] <= merge_tolerance \
                    and merged[-1][1] >= t0:
                m0, m1, mp = merged[-1]
                merged[-1] = (m0, max(m1, te), min(mp + p, 1.0))
            else:
                merged.append((t0, te, p))
        hits.extend((index.utt_id, t0, te, p) for (t0, te, p) in merged)
    hits.sort(key=lambda h: -h[3])
    return hits


def save_kws_index(path: str, indexes) -> None:
    """Serialize a list of per-utterance KwsIndex objects (the artifact
    lattice-to-kws-index writes and kws-search/kws-index-union read;
    ref: kwsbin/lattice-to-kws-index.cc writes a fst archive — here the
    factor tables persist directly)."""
    import pickle
    payload = [dataclasses.asdict(ix) for ix in indexes]
    with open(path, "wb") as f:
        pickle.dump({"format": "kws_index_v1", "indexes": payload}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def load_kws_index(path: str):
    """-> list[KwsIndex]."""
    import pickle
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob.get("format") == "kws_index_v1", "not a kws index file"
    return [KwsIndex(**d) for d in blob["indexes"]]


def union_kws_indexes(index_lists):
    """Merge several index collections, keeping one entry per utterance
    (later files win on duplicate utt ids; ref: kwsbin/kws-index-union.cc
    unions the factor transducers — with per-utterance tables a union is
    key-level concatenation)."""
    by_utt = {}
    for lst in index_lists:
        for ix in lst:
            by_utt[ix.utt_id] = ix
    return [by_utt[k] for k in sorted(by_utt)]
