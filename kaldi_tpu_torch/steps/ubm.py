"""UBM training steps: diagonal then full-covariance refinement.

(ref: steps/train_diag_ubm.sh (gmm-global-init-from-feats + EM over
 gmm-global-acc-stats/gmm-global-est) and sid/train_full_ubm.sh
 (fgmm-global-acc-stats / fgmm-global-est); the N-job accumulate +
 sum-accs filesystem reduce collapses into batched accumulation.)

The port's copy of the diagonal half of kaldi_tpu/steps/ubm.py (host
code: numpy posteriors and f64 statistics), carried verbatim so the port
imports nothing of kaldi_tpu; tests hold the two equal. fMMI trains its
posterior GMM with `train_diag_ubm`; the full-covariance refinement is
not copied (nothing in the port calls it yet).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.estimation import AccumDiagGmm, mle_diag_gmm_update

log = logging.getLogger("kaldi_tpu_torch.ubm")


@dataclasses.dataclass
class DiagUbmTrainOpts:
    num_gauss: int = 256
    num_iters: int = 4
    num_gselect: int = 0          # 0 = full posteriors (fine at this scale)
    initial_gauss_proportion: float = 0.5
    min_gaussian_weight: float = 1e-4
    subsample: int = 1            # take every k-th frame (train_diag_ubm.sh)


def train_diag_ubm(feats: np.ndarray, opts: DiagUbmTrainOpts
                   = DiagUbmTrainOpts()) -> DiagGmm:
    """feats [N, D] pooled (already subsampled per utterance upstream)."""
    x = feats[:: max(opts.subsample, 1)].astype(np.float32)
    ubm = DiagGmm.from_stats(x.mean(0), x.var(0) + 1e-5)
    # double mixture count up to the target, EM between doublings
    # (gmm-global-init-from-feats does kmeans-ish init; splitting + EM
    # reaches the same stationary points)
    target = opts.num_gauss
    cur = max(1, int(target * opts.initial_gauss_proportion) // 2)
    ubm = ubm.split(max(cur, 1))
    while True:
        for _ in range(opts.num_iters):
            acc = AccumDiagGmm(ubm.num_gauss, ubm.dim)
            acc.accumulate(ubm, x)
            ubm = mle_diag_gmm_update(
                ubm, acc, min_gaussian_weight=opts.min_gaussian_weight)
        if ubm.num_gauss >= target:
            break
        ubm = ubm.split(min(target, ubm.num_gauss * 2))
    log.info("diag UBM: %d gauss, dim %d", ubm.num_gauss, ubm.dim)
    return ubm
