"""Lattice scoring with LM-scale / word-insertion-penalty sweep.

(ref: egs/wsj/s5/local/score.sh + steps/decode.sh scoring stage — for each
 lmwt in a grid (and each word_ins_penalty), run lattice-best-path with
 that scale, compute WER, keep the best (utils/best_wer.sh).)

The port's copy of kaldi_tpu/steps/score.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import copy

from kaldi_tpu_torch.lat.functions import (lattice_scale,
                                           add_word_ins_penalty,
                                           lattice_best_path)
from kaldi_tpu_torch.utils.wer import compute_wer


def score_lattices(
    lattices: dict,            # utt -> Lattice (acoustic costs UNscaled by
                               # the sweep: stored at decode acoustic_scale)
    refs: dict,                # utt -> ref word-id list or symbol list
    words=None,                # SymbolTable to map hyp ids -> symbols
    lm_scales=(5, 7, 9, 11, 13, 15, 17),
    word_ins_penalties=(0.0, 0.5, 1.0),
    decode_acoustic_scale: float = 0.1,
):
    """-> (best_wer_stats, best (lmwt, wip), {(lmwt, wip): WerStats}).

    The decoder stored acoustic costs scaled by decode_acoustic_scale;
    sweeping lmwt is equivalent to acoustic scale 1/lmwt with graph scale
    1 (the reference's convention), implemented by rescaling both parts.
    """
    all_stats = {}
    best = None
    for lmwt in lm_scales:
        # scale ONCE per lmwt (the old per-(lmwt,wip) deepcopy dominated
        # sweep cost); word-insertion penalties are then applied as
        # cumulative deltas on the same copies
        scaled = {}
        for utt, lat0 in lattices.items():
            if utt not in refs:
                continue  # no reference to score against (mode=present)
            if lat0 is None:
                scaled[utt] = None  # failed decode: scores as deletions
                continue
            lat = copy.deepcopy(lat0)
            # graph*1, acoustic * 1/(lmwt*decode_scale)
            lattice_scale(lat, lm_scale=1.0,
                          acoustic_scale=1.0 / (lmwt *
                                                decode_acoustic_scale))
            scaled[utt] = lat
        prev_wip = 0.0
        for wip in word_ins_penalties:
            refs_sym, hyps_sym = {}, {}
            for utt, lat in scaled.items():
                hyp = []
                if lat is not None:
                    if wip != prev_wip:
                        add_word_ins_penalty(lat, wip - prev_wip)
                    res = lattice_best_path(lat)
                    hyp = res[0] if res else []
                hyps_sym[utt] = ([words.sym(w) for w in hyp]
                                 if words is not None else list(hyp))
                refs_sym[utt] = list(refs[utt])
            prev_wip = wip
            stats = compute_wer(refs_sym, hyps_sym)
            all_stats[(lmwt, wip)] = stats
            if best is None or stats.wer < all_stats[best].wer:
                best = (lmwt, wip)
    return all_stats[best], best, all_stats
