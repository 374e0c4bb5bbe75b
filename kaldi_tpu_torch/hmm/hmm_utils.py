"""Alignment conversion between systems (the convert-ali role).

(ref: hmm/hmm-utils.cc ConvertAlignment / ConvertAlignmentInternal and
 bin/convert-ali.cc — re-derived for the same-topology case that the GMM
 training ladder actually uses: mono alignments re-tied to a triphone
 tree, or one tree's alignments re-tied to a newer tree. Frame-shift /
 topology-change conversion is out of scope; the callers here never use
 it.)

The port's copy of kaldi_tpu/hmm/hmm_utils.py (host code), carried verbatim
so the port imports nothing of kaldi_tpu; tests/test_torch_*.py hold the two
equal.
"""

from __future__ import annotations

import numpy as np


def split_to_phones(ali: np.ndarray, tm) -> list[tuple[int, int]]:
    """[T] transition-ids -> list of (start, end) phone segments.

    A new segment starts when the phone changes or when a non-self-loop
    hmm-state-0 transition-id marks a new instance of the same phone
    (ref: hmm-utils.cc SplitToPhonesInternal).
    """
    T = len(ali)
    if T == 0:
        return []
    segs = [0]
    prev_phone = tm.transition_id_to_phone(int(ali[0]))
    for t in range(1, T):
        tid = int(ali[t])
        phone = tm.transition_id_to_phone(tid)
        restart = (phone == prev_phone
                   and tm.transition_id_to_hmm_state(tid) == 0
                   and not tm.is_self_loop(tid))
        if phone != prev_phone or restart:
            segs.append(t)
        prev_phone = phone
    segs.append(T)
    return [(segs[i], segs[i + 1]) for i in range(len(segs) - 1)]


def convert_alignment(ali: np.ndarray, old_tm, new_tm, new_ctx) -> np.ndarray:
    """Re-map a transition-id alignment onto a new (tree, transition
    model) pair with the same phone topology.

    Each frame keeps its (phone, hmm-state, transition-index); only the
    pdf is re-derived through `new_ctx` with the phone window read off
    the alignment itself (ref: hmm-utils.cc ConvertAlignmentInternal).
    """
    ali = np.asarray(ali)
    segs = split_to_phones(ali, old_tm)
    seg_phones = [old_tm.transition_id_to_phone(int(ali[s])) for (s, _e)
                  in segs]
    N = getattr(new_ctx, "context_width", 1)
    P = getattr(new_ctx, "central_position", 0)
    out = np.zeros_like(ali, dtype=np.int32)
    for si, (lo, hi) in enumerate(segs):
        window = []
        for pos in range(-P, N - P):
            j = si + pos
            window.append(seg_phones[j] if 0 <= j < len(seg_phones) else 0)
        phone = seg_phones[si]
        topo_entry = old_tm.topo.entry(phone)
        # pdf per hmm-state of this phone-in-context
        pdf_of_state: dict[int, int] = {}
        for t in range(lo, hi):
            tid = int(ali[t])
            hmm_state = old_tm.transition_id_to_hmm_state(tid)
            trans_index = old_tm.transition_id_to_transition_index(tid)
            pdf = pdf_of_state.get(hmm_state)
            if pdf is None:
                pdf_class = topo_entry[hmm_state].pdf_class
                pdf = new_ctx.compute(window, pdf_class)
                pdf_of_state[hmm_state] = pdf
            ts = new_tm.tuple_to_transition_state(phone, hmm_state, pdf)
            out[t] = new_tm.pair_to_transition_id(ts, trans_index)
    return out
