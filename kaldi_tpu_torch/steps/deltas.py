"""Tied-triphone GMM training ("train_deltas"): tree building + EM.

Counterpart of kaldi_tpu/steps/deltas.py (ref: steps/train_deltas.sh and
the binaries it drives: acc-tree-stats, cluster-phones, compile-questions,
build-tree, gmm-init-model, convert-ali, compile-train-graphs,
gmm-align-compiled, gmm-acc-stats-ali, gmm-est). The tree is built on the
host by the port's copies of kaldi_tpu/tree/ (f64 statistics; the split
order is JAX's); the device work is what `train_mono` does, on the
alignment model's device: the GMM log-likelihoods, the Viterbi alignment
and each utterance's aligned posteriors.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.fst.lang import Lang
from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.steps.mono import (MonoModel, MonoTrainOpts, _PhaseClock,
                                        _accumulate, _update, compile_and_pad)
from kaldi_tpu_torch.steps.tdnn import align_with_gmm  # noqa: F401 (as JAX)
from kaldi_tpu_torch.tree.build_tree import (
    accumulate_tree_stats, obtain_questions, Questions, build_tree)
from kaldi_tpu_torch.tree.context_dep import TreeContextDependency
from kaldi_tpu_torch.tree.event_map import KPDF_CLASS

log = logging.getLogger("kaldi_tpu_torch.deltas")


@dataclasses.dataclass
class DeltasTrainOpts(MonoTrainOpts):
    num_iters: int = 25
    max_iter_inc: int = 15
    totgauss: int = 2000
    num_leaves: int = 500
    tree_thresh: float = 30.0
    cluster_thresh: float = -1.0  # <0: use smallest split
    realign_iters: tuple = (10, 20, 30)
    context_width: int = 3
    central_position: int = 1
    # silence tree-root convention:
    #  'shared_not_split'  one pdf for all states of each silence phone —
    #                      the robust small-corpus setting (one step past
    #                      prepare_lang --share-silence-phones), default;
    #  'shared_split'      prepare_lang.sh:229 default roots.txt — shared
    #                      root, splittable by pdf-class/context questions;
    #  'per_state'         'not-shared not-split': one unsplit pdf per
    #                      HMM state (prepare_lang --share-silence-phones
    #                      line-1 convention).
    sil_roots: str = "shared_not_split"


def build_triphone_tree(
    lang: Lang,
    ali_model: MonoModel,
    utts,
    opts: DeltasTrainOpts,
    stats_feats=None,
):
    """Accumulate tree stats from alignments with the previous system and
    build the tied-state tree. Returns (ctx_dep, trans_model, leaf_stats).

    stats_feats: optional per-utterance feature arrays (same order/lengths
    as utts) to accumulate the Gaussian tree stats in a DIFFERENT feature
    space than the alignment features — the train_lda_mllt.sh case where
    acc-tree-stats runs on spliced+LDA features with old-system alignments.
    """
    # transition-id-level alignments with the previous (mono) system
    batch, feats, nf = compile_and_pad(lang, ali_model.trans_model,
                                       ali_model.ctx_dep, utts)
    ll = ali_model.am.loglikes(feats)
    results = viterbi_align(batch, ll, nf, opts.acoustic_scale,
                            device=ali_model.am.device)

    sil_ids = [lang.phones[p] for p in lang.silence_phones]
    stats: dict = {}
    for b, res in enumerate(results):
        if res is None:
            continue
        tids, _w, _c = res
        sf = (stats_feats[b][: nf[b]] if stats_feats is not None
              else feats[b, : nf[b]])
        accumulate_tree_stats(
            sf, tids[: nf[b]], ali_model.trans_model,
            N=opts.context_width, P=opts.central_position,
            ci_phones=set(sil_ids), stats=stats)

    return tree_from_stats(lang, stats, opts)


def tree_from_stats(lang: Lang, stats: dict, opts: DeltasTrainOpts,
                    question_sets: list[list[int]] | None = None):
    """Questions + roots policy + tree build + transition model from
    pre-accumulated tree stats. Returns (ctx_dep, trans_model,
    leaf_stats) — the cluster-phones / compile-questions / build-tree /
    gmm-init-model chain fused.

    question_sets: phone-id sets to use as questions (the cluster-phones
    output); derived from the stats when None.
    """
    if question_sets is None:
        question_sets = obtain_questions(stats, opts.central_position)
    questions = Questions(
        question_sets,
        num_pdf_classes=max(lang.topo.num_pdf_classes(p)
                            for p in lang.topo.phones),
        N=opts.context_width, P=opts.central_position)
    # roots: real phones get "shared split" (ref: prepare_lang.sh:229
    # roots.txt); the silence convention is opts.sil_roots — see
    # DeltasTrainOpts (kaldi exposes the same policy space via
    # prepare_lang --share-silence-phones)
    phone_sets = [[p] for p in lang.topo.phones]
    is_sil = [lang.phones.sym(p) in lang.silence_phones
              for (p,) in phone_sets]
    if opts.sil_roots == "shared_split":
        share_roots = [True] * len(phone_sets)
        do_split = [True] * len(phone_sets)
    elif opts.sil_roots == "per_state":
        share_roots = [not s for s in is_sil]
        do_split = [not s for s in is_sil]
    elif opts.sil_roots == "shared_not_split":
        share_roots = [True] * len(phone_sets)
        do_split = [not s for s in is_sil]
    else:
        raise ValueError(f"unknown sil_roots {opts.sil_roots!r}")
    tree, num_leaves = build_tree(
        stats, questions, phone_sets,
        {p: lang.topo.num_pdf_classes(p) for p in lang.topo.phones},
        share_roots, do_split,
        max_leaves=opts.num_leaves, thresh=opts.tree_thresh,
        cluster_thresh=opts.cluster_thresh, P=opts.central_position)
    ctx = TreeContextDependency(opts.context_width, opts.central_position,
                                tree, num_leaves)
    tm = transition_model_from_tree(lang, ctx)
    leaf_stats = leaf_stats_from_tree_stats(stats, ctx)
    return ctx, tm, leaf_stats


def transition_model_from_tree(lang: Lang, ctx) -> TransitionModel:
    if not hasattr(ctx, "event_map"):
        # monophone context dependency: single deterministic pdf
        def pdfs_of(phone, pdf_class):
            return {ctx.compute([phone], pdf_class)}
    else:
        def pdfs_of(phone, pdf_class):
            return ctx.event_map.multi_map(
                {KPDF_CLASS: pdf_class, ctx.central_position: phone})

    return TransitionModel(lang.topo, pdfs_of)


def leaf_stats_from_tree_stats(stats: dict, ctx):
    """Per-leaf Gaussian stats for GMM init (the gmm-init-model input)."""
    leaf_stats = [None] * ctx.num_pdfs
    for ev, st in stats.items():
        leaf = ctx.event_map.map(dict(ev))
        if leaf is None:
            continue
        leaf_stats[leaf] = st if leaf_stats[leaf] is None \
            else leaf_stats[leaf].add(st)
    return leaf_stats


def init_am_from_leaf_stats(leaf_stats, dim: int, device="cuda") -> AmDiagGmm:
    """1-gauss-per-leaf init from tree stats (ref: gmm-init-model.cc), an
    AmDiagGmm on `device`."""
    pdfs = []
    global_mean = np.zeros(dim)
    global_var = np.ones(dim)
    tot = 0.0
    for st in leaf_stats:
        if st is not None and st.count > 0:
            global_mean += st.x
            global_var += st.x2
            tot += st.count
    global_mean /= max(tot, 1.0)
    global_var = np.maximum(global_var / max(tot, 1.0) - global_mean ** 2,
                            1e-3)
    for st in leaf_stats:
        if st is None or st.count < 3:
            pdfs.append(DiagGmm.from_stats(global_mean, global_var))
        else:
            mean = st.x / st.count
            var = np.maximum(st.x2 / st.count - mean * mean, 1e-3)
            pdfs.append(DiagGmm.from_stats(mean, var))
    return AmDiagGmm(pdfs, device)


def train_deltas(
    lang: Lang,
    utts,
    ali_model: MonoModel,
    opts: DeltasTrainOpts = DeltasTrainOpts(),
    iter_stats: list | None = None,
) -> MonoModel:
    """Tree from `ali_model`'s alignments, then EM on its device.

    iter_stats: as `train_mono`'s, with a "tree" entry (alignment with
    `ali_model`, statistics and tree build) in the first dict."""
    dev = ali_model.am.device
    clock = _PhaseClock(dev, iter_stats is not None)
    ctx, tm, leaf_stats = clock("tree", lambda: build_triphone_tree(
        lang, ali_model, utts, opts))
    dim = utts[0][1].shape[1]
    am = init_am_from_leaf_stats(leaf_stats, dim, dev)
    log.info("triphone tree: %d leaves, %d transition ids",
             am.num_pdfs, tm.num_transition_ids)
    model = MonoModel(am, tm, ctx, lang)

    batch, feats, nf = compile_and_pad(lang, tm, ctx, utts,
                                       opts.transition_scale,
                                       opts.self_loop_scale)
    B = len(utts)

    align = None
    cur_gauss = am.total_gauss
    inc = max(0, (opts.totgauss - cur_gauss) // max(opts.max_iter_inc, 1))
    for it in range(1, opts.num_iters):
        if align is None or it in opts.realign_iters:
            ll = clock("loglikes", lambda: model.am.loglikes(feats))
            align = clock("align", lambda: viterbi_align(
                batch, ll, nf, opts.acoustic_scale, device=dev))
        acc, tcounts, n_ok = clock(
            "accumulate", lambda: _accumulate(model, feats, nf, align))
        target = (min(opts.totgauss, cur_gauss + inc)
                  if it <= opts.max_iter_inc else None)
        clock("update", lambda: _update(model, acc, tcounts, opts, target))
        clock.close(iter_stats, it, n_ok, acc)
        cur_gauss = model.am.total_gauss
        if it % 5 == 0 or it == 1:
            log.info("tri iter %d: %d/%d aligned, loglike/frame %.4f, gauss %d",
                     it, n_ok, B, acc.tot_like / max(acc.tot_frames, 1),
                     cur_gauss)
    return model
