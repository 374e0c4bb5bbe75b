"""UBM training steps: diagonal then full-covariance refinement.

(ref: steps/train_diag_ubm.sh (gmm-global-init-from-feats + EM over
 gmm-global-acc-stats/gmm-global-est) and sid/train_full_ubm.sh
 (fgmm-global-acc-stats / fgmm-global-est); the N-job accumulate +
 sum-accs filesystem reduce collapses into batched accumulation.)

The port's copy of kaldi_tpu/steps/ubm.py. `train_diag_ubm` accumulates
on its device (`AccumDiagGmm.accumulate_batch`), which a 2048-gaussian
UBM over hundreds of thousands of frames needs; the splits and updates
stay on the host. With `host_numpy` it is JAX's host code, numpy
posteriors and f64 statistics, equal to JAX's bit for bit (fMMI's
posterior GMM). `train_full_ubm` accumulates on its device
(`AccumFullGmm.accumulate_batch`) and floors each update's eigenvalues
there.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.estimation import AccumDiagGmm, mle_diag_gmm_update
from kaldi_tpu_torch.gmm.full_gmm import (AccumFullGmm, FullGmm,
                                          mle_full_gmm_update)

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
                   = DiagUbmTrainOpts(), device="cuda",
                   host_numpy: bool = False) -> DiagGmm:
    """feats [N, D] pooled (already subsampled per utterance upstream).
    Each EM pass accumulates on `device`; host_numpy runs JAX's host
    code instead and touches no device."""
    x = feats[:: max(opts.subsample, 1)].astype(np.float32)
    xd = (None if host_numpy
          else torch.as_tensor(x, device=resolve_device(device)))
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
            if xd is None:
                acc.accumulate(ubm, x)
            else:
                acc.accumulate_batch(ubm, xd)
            ubm = mle_diag_gmm_update(
                ubm, acc, min_gaussian_weight=opts.min_gaussian_weight)
        if ubm.num_gauss >= target:
            break
        ubm = ubm.split(min(target, ubm.num_gauss * 2))
    log.info("diag UBM: %d gauss, dim %d", ubm.num_gauss, ubm.dim)
    return ubm


@dataclasses.dataclass
class FullUbmTrainOpts:
    num_iters: int = 4
    min_gaussian_weight: float = 1e-4
    remove_low_count_gaussians: bool = False


def train_full_ubm(diag_ubm: DiagGmm, feats: np.ndarray,
                   opts: FullUbmTrainOpts = FullUbmTrainOpts(),
                   device="cuda", iter_stats: list | None = None) -> FullGmm:
    """Full-covariance refinement started from the diag UBM
    (ref: sid/train_full_ubm.sh), each iteration's statistics and
    eigenvalue floor on `device`. iter_stats, if given, gets one dict per
    iteration: "iter", "loglike" (the average log-likelihood per frame
    under the model the iteration starts from), "secs" ("accumulate" of
    them the statistics, the rest the update); then one more
    "loglike" of the final model ("iter" = num_iters)."""
    dev = resolve_device(device)
    fubm = FullGmm.from_diag(diag_ubm.weights, diag_ubm.means,
                             diag_ubm.vars)
    x = torch.as_tensor(np.asarray(feats, np.float64), device=dev)
    for it in range(opts.num_iters):
        t = time.perf_counter()
        acc = AccumFullGmm(fubm.num_gauss, fubm.dim)
        like = acc.accumulate_batch(fubm, x, device=dev)
        t_acc = time.perf_counter() - t
        fubm = mle_full_gmm_update(fubm, acc, device=dev)
        log.info("full UBM iter %d: loglike/frame %.6f", it, like / len(x))
        if iter_stats is not None:
            iter_stats.append(dict(iter=it, loglike=like / len(x),
                                   secs=time.perf_counter() - t,
                                   accumulate=t_acc))
    if iter_stats is not None:
        like = fubm.loglike_batch(x, dev).double().sum()
        iter_stats.append(dict(iter=opts.num_iters,
                               loglike=float(like) / len(x)))
    log.info("full UBM: %d gauss", fubm.num_gauss)
    return fubm
