"""Term-weighted value (ATWV/STWV/MTWV) scoring for keyword search.

(ref: kws/kws-scoring.h:188-236 TwvMetricsOptions/TwvMetrics and
 kwsbin/compute-atwv.cc; definitions from the NIST KWS eval plans the
 reference cites: TWV(θ) = 1 − mean_kw[ P_miss(kw,θ) + β·P_fa(kw,θ) ],
 β = cost_fa/value_corr · (1/prior − 1) = 999.9 with the defaults.)

The port's copy of kaldi_tpu/kws/scoring.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TwvOptions:
    cost_fa: float = 0.1
    value_corr: float = 1.0
    prior_probability: float = 1e-4
    score_threshold: float = 0.5
    sweep_step: float = 0.05

    @property
    def beta(self) -> float:
        return (self.cost_fa / self.value_corr
                * (1.0 / self.prior_probability - 1.0))


def align_hits(refs, hits, max_distance: int = 50):
    """Greedy time alignment of hypothesis hits to reference occurrences
    (ref: kws/kws-scoring.h KwsTermsAligner; max_distance in frames).

    refs, hits: {kw_id: [(utt_id, t_begin, t_end[, score])]}.
    -> {kw_id: (n_correct, n_fa, n_ref)} counting each ref at most once.
    """
    out = {}
    all_kws = set(refs) | set(hits)
    for kw in all_kws:
        ref_list = list(refs.get(kw, []))
        hyp_list = sorted(hits.get(kw, []),
                          key=lambda h: -(h[3] if len(h) > 3 else 1.0))
        used = [False] * len(ref_list)
        n_corr = n_fa = 0
        for h in hyp_list:
            matched = -1
            for i, r in enumerate(ref_list):
                if used[i] or r[0] != h[0]:
                    continue
                if abs(r[1] - h[1]) <= max_distance:
                    matched = i
                    break
            if matched >= 0:
                used[matched] = True
                n_corr += 1
            else:
                n_fa += 1
        out[kw] = (n_corr, n_fa, len(ref_list))
    return out


def compute_twv(refs, hits, audio_duration_sec: float,
                opts: TwvOptions = TwvOptions()):
    """-> dict with atwv, stwv, per-kw TWV at the decision threshold.

    ATWV applies the score threshold to hits; STWV ignores false alarms
    (upper bound: 1 − mean P_miss over all hits regardless of score).
    """
    thresholded = {
        kw: [h for h in hs if (h[3] if len(h) > 3 else 1.0)
             >= opts.score_threshold]
        for kw, hs in hits.items()}
    counts = align_hits(refs, thresholded)
    counts_all = align_hits(refs, hits)

    # NIST/KWS convention: one false-alarm trial per SECOND of audio
    # (ref: kws/kws-scoring.cc TwvMetrics — beta=999.9 is calibrated for
    # 1-second trials; counting frames made P_fa ~100x too small and
    # inflated ATWV)
    n_trials = audio_duration_sec
    per_kw = {}
    atwv_terms, stwv_terms = [], []
    for kw, (n_corr, n_fa, n_ref) in counts.items():
        if n_ref == 0:
            continue  # keywords absent from the reference don't count
        p_miss = 1.0 - n_corr / n_ref
        p_fa = n_fa / max(n_trials - n_ref, 1.0)
        twv = 1.0 - p_miss - opts.beta * p_fa
        per_kw[kw] = twv
        atwv_terms.append(twv)
        c_all, _fa_all, _ = counts_all.get(kw, (0, 0, n_ref))
        stwv_terms.append(c_all / n_ref)
    atwv = sum(atwv_terms) / len(atwv_terms) if atwv_terms else 0.0
    stwv = sum(stwv_terms) / len(stwv_terms) if stwv_terms else 0.0
    return {"atwv": atwv, "stwv": stwv, "per_kw": per_kw}
