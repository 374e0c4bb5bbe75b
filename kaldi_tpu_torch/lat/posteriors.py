"""Lattice posteriors for discriminative training: MMI / MPE / sMBR.

(ref: lat/lattice-functions.h — LatticeStateTimes :44, LatticeForwardBackward
 :62, LatticeForwardBackwardMpeVariants :170, LatticeForwardBackwardMmi :192,
 LatticeBoost :152; the algorithms are re-derived from the published EBW /
 minimum-Bayes-risk training equations, computed over our tid-level lattices.)

Posterior convention matches the reference's `Posterior` type
(hmm/posterior.h:42): a list over frames of (id, weight) pairs, where id is
a transition-id (or pdf-id after mapping) and weights may be negative for
the denominator part of discriminative objectives.

The port's copy of kaldi_tpu/lat/posteriors.py (host code), carried verbatim
so the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import math

import numpy as np

from kaldi_tpu_torch.lat.lattice import Lattice
from kaldi_tpu_torch.lat.functions import lattice_forward_backward

INF = float("inf")


def lattice_state_times(lat: Lattice):
    """Frame index of every state (ref: lattice-functions.h:44
    LatticeStateTimes). Every arc with a nonzero ilabel consumes one frame.
    Returns (times [num_states], num_frames)."""
    times = np.full(lat.num_states, -1, np.int64)
    times[lat.start] = 0
    for s in lat.topological_order():
        if times[s] < 0:
            continue
        for a in lat.arcs[s]:
            t = times[s] + (1 if a.ilabel != 0 else 0)
            if times[a.nextstate] < 0:
                times[a.nextstate] = t
            elif times[a.nextstate] != t:
                raise ValueError("inconsistent lattice state times")
    return times, int(times.max(initial=0))


def lattice_to_post(lat: Lattice, min_post: float = 1e-8):
    """Per-frame transition-id posteriors from lattice forward-backward.

    -> (post, total_loglike) where post[t] = list of (tid, gamma).
    (ref: lattice-functions.h:62 LatticeForwardBackward.)
    """
    times, T = lattice_state_times(lat)
    gamma, tot, _a, _b = lattice_forward_backward(lat)
    post: list[list] = [[] for _ in range(T)]
    acc: list[dict] = [dict() for _ in range(T)]
    for s in range(lat.num_states):
        for i, a in enumerate(lat.arcs[s]):
            if a.ilabel == 0:
                continue
            t = int(times[s])
            g = gamma[(s, i)]
            if g > 0:
                acc[t][a.ilabel] = acc[t].get(a.ilabel, 0.0) + g
    for t in range(T):
        post[t] = [(tid, g) for tid, g in sorted(acc[t].items())
                   if g >= min_post]
    return post, tot


def rescore_lattice(lat: Lattice, loglikes: np.ndarray, tm,
                    acoustic_scale: float = 1.0) -> Lattice:
    """Replace every emitting arc's acoustic cost with
    -acoustic_scale * loglikes[t, pdf(tid)] from a (new) acoustic model
    (ref: lattice-functions.h:294 RescoreLattice). In-place."""
    times, T = lattice_state_times(lat)
    if T > loglikes.shape[0]:
        raise ValueError("loglikes shorter than lattice")
    for s in range(lat.num_states):
        t = int(times[s])
        for a in lat.arcs[s]:
            if a.ilabel == 0:
                continue
            pdf = tm.transition_id_to_pdf(a.ilabel)
            a.acoustic_cost = -acoustic_scale * float(loglikes[t, pdf])
    return lat


def alignment_to_post(tids, weight: float = 1.0):
    """Hard alignment -> Posterior (ref: hmm/posterior.h AlignmentToPosterior)."""
    return [[(int(tid), weight)] for tid in tids]


def posterior_to_pdf_post(post, tm):
    """Map tids -> pdf-ids, merging duplicates
    (ref: hmm/posterior.h ConvertPosteriorToPdfs)."""
    out = []
    for frame in post:
        d: dict = {}
        for tid, w in frame:
            pdf = tm.transition_id_to_pdf(tid)
            d[pdf] = d.get(pdf, 0.0) + w
        out.append(sorted(d.items()))
    return out


def _arc_phone(lat_arc, tm):
    return tm.transition_id_to_phone(lat_arc.ilabel)


def lattice_boost(lat: Lattice, num_ali, tm, b: float,
                  silence_phones=frozenset(),
                  max_silence_error: float = 0.0) -> Lattice:
    """Boosted MMI: subtract b * frame-accuracy from each arc's graph cost
    (ref: lattice-functions.h:152 LatticeBoost; Povey et al. 2008 bMMI).

    Accuracy of an emitting arc at frame t is 1 if its phone matches the
    numerator alignment's phone at t, else 0; silence arcs get
    (1 - max_silence_error) credit at most.
    """
    times, T = lattice_state_times(lat)
    ref_phones = np.array([tm.transition_id_to_phone(int(t)) for t in num_ali])
    if T > len(ref_phones):
        raise ValueError("alignment shorter than lattice")
    for s in range(lat.num_states):
        t = int(times[s])
        for a in lat.arcs[s]:
            if a.ilabel == 0:
                continue
            ph = _arc_phone(a, tm)
            if ph in silence_phones:
                acc = 1.0 - max_silence_error
            else:
                acc = 1.0 if ph == ref_phones[t] else 0.0
            a.graph_cost -= b * acc
    return lat


def lattice_forward_backward_mmi(lat: Lattice, num_ali, tm,
                                 drop_frames: bool = True,
                                 cancel: bool = True):
    """MMI posteriors: numerator (+1 at the alignment pdf) minus denominator
    (lattice gammas), per frame, at the *pdf* level.

    -> (post, mmi_objf_denominator_loglike) where post[t] = [(pdf, w)] with
    possibly negative w. (ref: lattice-functions.h:192
    LatticeForwardBackwardMmi; drop_frames/cancel per Vesely et al. 2013.)
    """
    den_post, den_like = lattice_to_post(lat)
    den_pdf = posterior_to_pdf_post(den_post, tm)
    T = len(den_pdf)
    out = []
    for t in range(T):
        num_pdf = tm.transition_id_to_pdf(int(num_ali[t]))
        d = {pdf: -w for pdf, w in den_pdf[t]}
        d[num_pdf] = d.get(num_pdf, 0.0) + 1.0
        if drop_frames and d.get(num_pdf, 0.0) >= 1.0 - 1e-4:
            # numerator pdf absent from the denominator lattice: the frame
            # is an outlier (num path pruned away); drop it.
            out.append([])
            continue
        if cancel:
            d = {p: w for p, w in d.items() if abs(w) > 1e-8}
        out.append(sorted(d.items()))
    return out, den_like


def lattice_forward_backward_mpe_variants(
    lat: Lattice, num_ali, tm, criterion: str = "smbr",
    silence_phones=frozenset(), one_silence_class: bool = True,
):
    """MPE/sMBR forward-backward (ref: lattice-functions.h:170
    LatticeForwardBackwardMpeVariants; Povey & Kingsbury 2007).

    criterion: 'smbr' (state/pdf-level accuracy) or 'mpfe' (phone-level).
    Returns (post, utt_expected_accuracy): post[t] = [(pdf, w)] where w>0
    means raising that pdf's likelihood raises expected accuracy.
    """
    assert criterion in ("smbr", "mpfe")
    times, T = lattice_state_times(lat)
    order = lat.topological_order()
    n = lat.num_states

    ref_pdf = np.array([tm.transition_id_to_pdf(int(t)) for t in num_ali])
    ref_phone = np.array([tm.transition_id_to_phone(int(t)) for t in num_ali])
    ref_is_sil = np.array([p in silence_phones for p in ref_phone])

    def arc_accuracy(a, t):
        ph = tm.transition_id_to_phone(a.ilabel)
        hyp_sil = ph in silence_phones
        if one_silence_class:
            # any silence phone matching any silence ref counts as correct
            if hyp_sil:
                return 1.0 if ref_is_sil[t] else 0.0
            if ref_is_sil[t]:
                return 0.0
        if criterion == "mpfe":
            return 1.0 if ph == ref_phone[t] else 0.0
        return 1.0 if tm.transition_id_to_pdf(a.ilabel) == ref_pdf[t] else 0.0

    # log-domain alpha/beta; linear-domain expected-accuracy companions
    from kaldi_tpu_torch.lat.functions import _log_add as logadd

    alpha = np.full(n, -INF)
    alpha[lat.start] = 0.0
    alpha_acc = np.zeros(n)
    for s in order:
        if alpha[s] == -INF:
            continue
        for a in lat.arcs[s]:
            j = a.nextstate
            lp = alpha[s] - a.cost
            acc = arc_accuracy(a, int(times[s])) if a.ilabel != 0 else 0.0
            # weighted-average accumulation of expected accuracy
            new_alpha = logadd(alpha[j], lp)
            if alpha[j] == -INF:
                alpha_acc[j] = alpha_acc[s] + acc
            else:
                w_old = math.exp(alpha[j] - new_alpha)
                w_new = math.exp(lp - new_alpha)
                alpha_acc[j] = (w_old * alpha_acc[j]
                                + w_new * (alpha_acc[s] + acc))
            alpha[j] = new_alpha

    beta = np.full(n, -INF)
    beta_acc = np.zeros(n)
    for s, (g, ac) in lat.finals.items():
        beta[s] = -(g + ac)
    for s in reversed(order):
        for a in lat.arcs[s]:
            j = a.nextstate
            if beta[j] == -INF:
                continue
            lp = -a.cost + beta[j]
            acc = arc_accuracy(a, int(times[s])) if a.ilabel != 0 else 0.0
            new_beta = logadd(beta[s], lp)
            if beta[s] == -INF:
                beta_acc[s] = beta_acc[j] + acc
            else:
                w_old = math.exp(beta[s] - new_beta)
                w_new = math.exp(lp - new_beta)
                beta_acc[s] = (w_old * beta_acc[s]
                               + w_new * (beta_acc[j] + acc))
            beta[s] = new_beta

    tot = beta[lat.start]
    if tot == -INF:
        return [[] for _ in range(T)], 0.0
    tot_acc = alpha_acc_final = 0.0
    # expected accuracy = weighted avg over final states
    wsum = 0.0
    for s, (g, ac) in lat.finals.items():
        if alpha[s] == -INF:
            continue
        w = math.exp(alpha[s] - (g + ac) - tot)
        wsum += w
        alpha_acc_final += w * alpha_acc[s]
    tot_acc = alpha_acc_final / max(wsum, 1e-20)

    acc_frames: list[dict] = [dict() for _ in range(T)]
    for s in range(n):
        if alpha[s] == -INF:
            continue
        t = int(times[s])
        for a in lat.arcs[s]:
            if a.ilabel == 0 or beta[a.nextstate] == -INF:
                continue
            gamma = math.exp(alpha[s] - a.cost + beta[a.nextstate] - tot)
            acc = arc_accuracy(a, t)
            # MPE "gamma": occupancy * (path-accuracy-through-arc − E[acc])
            mpe_g = gamma * (alpha_acc[s] + acc + beta_acc[a.nextstate]
                             - tot_acc)
            pdf = tm.transition_id_to_pdf(a.ilabel)
            acc_frames[t][pdf] = acc_frames[t].get(pdf, 0.0) + mpe_g
    post = [sorted((p, w) for p, w in d.items() if abs(w) > 1e-8)
            for d in acc_frames]
    return post, tot_acc
