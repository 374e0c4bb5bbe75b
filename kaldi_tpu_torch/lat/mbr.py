"""Minimum Bayes Risk decoding, confusion networks ("sausages"),
word confidences.

(ref: lat/sausages.h:59-90 MinimumBayesRisk — iterative MBR decode per
 Xu et al. 2011 'Minimum Bayes Risk decoding and system combination based
 on a recursion for edit distance'; latbin/lattice-mbr-decode.cc,
 lattice-to-ctm-conf.)

Implementation: the expected-edit-distance recursion between the current
1-best R and the lattice's paths, iterated until the MBR hypothesis is
stable; produces per-position word posteriors (sausage bins) and
confidences.

The port's copy of kaldi_tpu/lat/mbr.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from kaldi_tpu_torch.lat.lattice import Lattice
from kaldi_tpu_torch.lat.functions import nbest


def mbr_decode(lat: Lattice, max_paths: int = 200, max_iters: int = 5):
    """-> (words, bins) where bins[i] = dict word->posterior (0 = eps).

    An n-best-approximated MBR: enumerate the top paths with posteriors,
    then iteratively re-estimate the minimum-expected-WER hypothesis by
    alignment voting (the n-best approximation of the sausage recursion;
    exact lattice recursion can replace it without API change).
    """
    paths = nbest(lat, max_paths)
    if not paths:
        return [], []
    # posteriors over paths
    costs = np.array([c for (_w, _t, c) in paths])
    p = np.exp(-(costs - costs.min()))
    p /= p.sum()
    hyp = list(paths[0][0])
    from kaldi_tpu_torch.utils.wer import levenshtein_alignment
    for _it in range(max_iters):
        # align every path to hyp; vote per position
        slots: list[dict] = [defaultdict(float) for _ in range(len(hyp))]
        ins_slots: list[dict] = [defaultdict(float)
                                 for _ in range(len(hyp) + 1)]
        for (words, _tids, _c), w in zip(paths, p):
            pairs, _ = levenshtein_alignment(hyp, list(words), eps=0)
            pos = 0
            for (r, h) in pairs:
                if r == 0:  # insertion relative to hyp
                    ins_slots[pos][h] += w
                else:
                    slots[pos][h] += w  # h may be 0 (deletion)
                    pos += 1
        new_hyp = []
        for i in range(len(hyp) + 1):
            if ins_slots[i]:
                iw, ip = max(ins_slots[i].items(), key=lambda kv: kv[1])
                if ip > 0.5:
                    new_hyp.append(iw)
            if i < len(hyp):
                ww, wp = max(slots[i].items(), key=lambda kv: kv[1])
                if ww != 0:
                    new_hyp.append(ww)
        if new_hyp == hyp:
            break
        hyp = new_hyp
    # final sausage bins + confidences for the settled hypothesis
    slots = [defaultdict(float) for _ in range(len(hyp))]
    for (words, _tids, _c), w in zip(paths, p):
        pairs, _ = levenshtein_alignment(hyp, list(words), eps=0)
        pos = 0
        for (r, h) in pairs:
            if r == 0:
                continue
            slots[pos][h] += w
            pos += 1
    bins = []
    for i, s in enumerate(slots):
        tot = sum(s.values())
        if tot < 1.0 - 1e-6:
            s[0] += 1.0 - tot
        bins.append(dict(s))
    return hyp, bins


def word_confidences(hyp, bins) -> list[float]:
    """Per-word posterior of the MBR hypothesis
    (ref: sausages.h GetOneBestConfidences)."""
    return [bins[i].get(w, 0.0) for i, w in enumerate(hyp)]


def expected_wer(lat: Lattice, hyp: list, max_paths: int = 200) -> float:
    """Expected edit distance of `hyp` under the lattice posterior.
    Returns +inf when the lattice has no complete path."""
    from kaldi_tpu_torch.utils.wer import levenshtein_alignment
    paths = nbest(lat, max_paths)
    if not paths:
        return float("inf")
    costs = np.array([c for (_w, _t, c) in paths])
    p = np.exp(-(costs - costs.min()))
    p /= p.sum()
    tot = 0.0
    for (words, _t, _c), w in zip(paths, p):
        _pairs, (s, i, d) = levenshtein_alignment(list(hyp), list(words))
        tot += w * (s + i + d)
    return tot
