"""Extended Baum-Welch (EBW) discriminative GMM updates.

(ref: gmm/ebw-diag-gmm.h:70-98 — UpdateEbwDiagGmm, UpdateEbwWeightsDiagGmm,
 IsmoothStatsDiagGmm; equations per Povey's thesis / the MMI-EBW literature,
 re-derived, vectorized over Gaussians in numpy; the D-search loop is
 per-Gaussian scalar work far off the hot path.)

The port's copy of kaldi_tpu/gmm/ebw.py (host code) over the port's
`DiagGmm`, `AmDiagGmm` and accumulators, carried verbatim so the port
imports nothing of kaldi_tpu; tests hold the two equal. The one change:
the updated `AmDiagGmm` keeps the input AM's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.estimation import AccumDiagGmm, AccumAmDiagGmm


@dataclasses.dataclass
class EbwOptions:
    """(ref: gmm/ebw-diag-gmm.h:34 EbwOptions)"""
    E: float = 2.0
    tau: float = 100.0          # I-smoothing to the numerator stats
    weight_tau: float = 10.0


def ismooth_stats_diag_gmm(acc: AccumDiagGmm, gmm: DiagGmm, tau: float
                           ) -> AccumDiagGmm:
    """I-smoothing: interpolate the stats toward the current model as if we
    had tau extra frames per Gaussian drawn from it
    (ref: gmm/ebw-diag-gmm.h IsmoothStatsDiagGmmFromModel)."""
    out = AccumDiagGmm(len(acc.occ), acc.mean_acc.shape[1])
    out.occ = acc.occ + tau
    out.mean_acc = acc.mean_acc + tau * gmm.means
    out.var_acc = acc.var_acc + tau * (gmm.vars + gmm.means ** 2)
    return out


def update_ebw_diag_gmm(
    gmm: DiagGmm,
    num: AccumDiagGmm,
    den: AccumDiagGmm,
    opts: EbwOptions = EbwOptions(),
    min_variance: float = 1e-10,
) -> tuple[DiagGmm, float, float]:
    """EBW mean/variance update. Returns (new_gmm, auxf_impr, count).

    mean' = (x_num - x_den + D m) / (occ_num - occ_den + D)
    var'  = (x2_num - x2_den + D (v + m^2)) / (occ_num - occ_den + D) - mean'^2
    with per-Gaussian D found by doubling from E*den_occ/2 until variances
    are positive, then doubled once more (the reference's safety factor).
    """
    M, Dim = gmm.means.shape
    if opts.tau > 0:
        num = ismooth_stats_diag_gmm(num, gmm, opts.tau)
    new_means = gmm.means.copy()
    new_vars = gmm.vars.copy()
    tot_count = 0.0
    for j in range(M):
        occ = num.occ[j] - den.occ[j]
        x = num.mean_acc[j] - den.mean_acc[j]
        x2 = num.var_acc[j] - den.var_acc[j]
        if num.occ[j] < 1e-3:       # no numerator data: leave unchanged
            continue
        D = 0.5 * opts.E * den.occ[j]
        ok = False
        for _ in range(64):
            denom = occ + D
            if denom > 1e-3:
                m = (x + D * gmm.means[j]) / denom
                v = (x2 + D * (gmm.vars[j] + gmm.means[j] ** 2)) / denom - m * m
                if np.all(v > min_variance):
                    ok = True
                    break
            D = max(D * 2.0, 1.0e-3)
        if not ok:
            continue
        D *= 2.0                    # safety doubling, per the reference
        denom = occ + D
        m = (x + D * gmm.means[j]) / denom
        v = (x2 + D * (gmm.vars[j] + gmm.means[j] ** 2)) / denom - m * m
        v = np.maximum(v, min_variance)
        new_means[j] = m
        new_vars[j] = v
        tot_count += num.occ[j]
    return DiagGmm(gmm.weights.copy(), new_means, new_vars), 0.0, tot_count


def update_ebw_weights_diag_gmm(
    gmm: DiagGmm,
    num: AccumDiagGmm,
    den: AccumDiagGmm,
    weight_tau: float = 10.0,
    min_weight: float = 1e-5,
) -> DiagGmm:
    """EBW weight update: w' ∝ num_occ - den_occ + C w, with C large enough
    to keep all weights positive (ref: ebw-diag-gmm.h:82
    UpdateEbwWeightsDiagGmm)."""
    w = gmm.weights
    lam = num.occ - den.occ
    # smallest C with lam + C w >= min margin everywhere, plus smoothing tau
    with np.errstate(divide="ignore", invalid="ignore"):
        need = np.where(w > 0, -lam / np.maximum(w, 1e-20), 0.0)
    C = max(float(np.max(need, initial=0.0)) * 2.0, weight_tau,
            float(num.occ.sum()) * 1e-3)
    new_w = lam + C * w
    new_w = np.maximum(new_w, min_weight)
    new_w /= new_w.sum()
    return DiagGmm(new_w, gmm.means.copy(), gmm.vars.copy())


def update_ebw_am_diag_gmm(
    am: AmDiagGmm,
    num: AccumAmDiagGmm,
    den: AccumAmDiagGmm,
    opts: EbwOptions = EbwOptions(),
    update_weights: bool = False,
) -> AmDiagGmm:
    """Per-pdf EBW update over the whole acoustic model
    (ref: gmmbin/gmm-est-gaussians-ebw.cc, gmm-est-weights-ebw.cc)."""
    new_pdfs = []
    for pdf, g in enumerate(am.pdfs):
        ng, _impr, _cnt = update_ebw_diag_gmm(
            g, num.accs[pdf], den.accs[pdf], opts)
        if update_weights:
            ng = update_ebw_weights_diag_gmm(
                ng, num.accs[pdf], den.accs[pdf], opts.weight_tau)
        new_pdfs.append(ng)
    return AmDiagGmm(new_pdfs, am.device)
