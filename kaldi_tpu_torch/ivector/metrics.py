"""Detection metrics: EER (ref: ivectorbin/compute-eer.cc).

The port's copy of kaldi_tpu/ivector/metrics.py (host numpy).
"""

from __future__ import annotations

import numpy as np


def compute_eer(target_scores, nontarget_scores) -> tuple[float, float]:
    """-> (EER in [0,1], threshold). Matches compute-eer's definition:
    the point where false-alarm rate crosses miss rate."""
    t = np.sort(np.asarray(target_scores, np.float64))
    n = np.sort(np.asarray(nontarget_scores, np.float64))[::-1]
    if len(t) == 0 or len(n) == 0:
        return 0.0, 0.0
    # for each candidate threshold = t[i]: miss rate = i/len(t);
    # false alarms = fraction of nontargets >= t[i]
    best_eer, best_thr = 1.0, t[0]
    for i, thr in enumerate(t):
        miss = i / len(t)
        fa = np.sum(n >= thr) / len(n)
        if fa <= miss:
            best_eer = max(miss, fa) if i == 0 else (miss + fa) / 2.0
            best_thr = thr
            return float(best_eer), float(best_thr)
    return 1.0, float(t[-1])
