"""train_lda_mllt: splice → LDA → tied-triphone GMM with iterative MLLT.

Counterpart of kaldi_tpu/steps/lda_mllt.py (ref: egs/wsj/s5/steps/train_lda_mllt.sh
— splice ±3 raw MFCC, est-lda on alignment pdf classes, train triphones on
the projected features, periodically est-mllt + gmm-transform-means +
compose-transforms; the final feature transform is M_mllt · A_lda). LDA
and MLLT are estimated on the host in f64 by the port's copies of
kaldi_tpu/transform/lda.py and mllt.py, and the MLLT rotation of the
features and means stays on the host, as in JAX. The splice, the
projection, the alignments and the Gaussian posteriors behind the MLLT
statistics run on the alignment model's device; the statistics loop is
JAX's, one device call and one copy back per utterance.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.ops.delta import splice_frames
from kaldi_tpu_torch.steps.deltas import (DeltasTrainOpts, build_triphone_tree,
                                          init_am_from_leaf_stats)
from kaldi_tpu_torch.steps.mono import (MonoModel, _PhaseClock, _accumulate,
                                        _update, compile_and_pad)
from kaldi_tpu_torch.transform.fmllr import (_posteriors_np,
                                             apply_affine_transform)
from kaldi_tpu_torch.transform.lda import LdaStats, estimate_lda
from kaldi_tpu_torch.transform.mllt import MlltStats, update_mllt

log = logging.getLogger("kaldi_tpu_torch.lda_mllt")


@dataclasses.dataclass
class LdaMlltTrainOpts(DeltasTrainOpts):
    splice_left: int = 3
    splice_right: int = 3
    lda_dim: int = 40
    mllt_iters: tuple = (2, 4, 6, 12)


def _align(lang, model: MonoModel, utts, acoustic_scale: float):
    batch, feats, nf = compile_and_pad(lang, model.trans_model,
                                       model.ctx_dep, utts)
    ll = model.am.loglikes(feats)
    return viterbi_align(batch, ll, nf, acoustic_scale,
                         device=model.am.device)


def accumulate_mllt_from_alignment(am, feats, pdf_ids, stats: MlltStats):
    """Per-frame aligned-pdf component posteriors (on the AM's device, one
    copy back) → MLLT G stats (host f64)."""
    post = _posteriors_np(am, np.asarray(feats, np.float32),
                          np.asarray(pdf_ids),
                          np.ones(len(feats), np.float32))
    means = np.concatenate([p.means for p in am.pdfs], axis=0)
    variances = np.concatenate([p.vars for p in am.pdfs], axis=0)
    stats.accumulate(np.asarray(feats, np.float64), means, variances, post)


def _splice(raw_feats, opts: "LdaMlltTrainOpts", device) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(raw_feats, np.float32), device=device)
    return splice_frames(x, opts.splice_left, opts.splice_right)


@dataclasses.dataclass
class LdaMlltModel:
    model: MonoModel
    transform: np.ndarray      # [lda_dim, D_spliced + 1] — full feature map

    def transform_feats(self, raw_feats: np.ndarray,
                        opts: "LdaMlltTrainOpts") -> np.ndarray:
        """Splice and project on the model's device -> numpy f32."""
        spliced = _splice(raw_feats, opts, self.model.am.device)
        return apply_affine_transform(spliced, self.transform).cpu().numpy()


def train_lda_mllt(
    lang,
    utts_align,     # [(utt, feats_for_ali_model, words)]
    utts_raw,       # [(utt, raw_feats, words)] same order
    ali_model: MonoModel,
    opts: LdaMlltTrainOpts = LdaMlltTrainOpts(),
    iter_stats: list | None = None,
) -> LdaMlltModel:
    """iter_stats: as `train_deltas`'s, with "lda" (alignment, splice,
    statistics and estimation) in the first dict and "mllt" (statistics,
    estimation and rotation) in the MLLT iterations'."""
    dev = ali_model.am.device
    clock = _PhaseClock(dev, iter_stats is not None)

    def lda_stage():
        # 1. alignments with the previous system
        align = _align(lang, ali_model, utts_align, opts.acoustic_scale)
        tid2pdf = ali_model.trans_model.id2pdf_array
        # 2. LDA on spliced raw features, classes = aligned pdf ids
        spliced = [_splice(f, opts, dev).cpu().numpy()
                   for (_u, f, _w) in utts_raw]
        D_spl = spliced[0].shape[1]
        lda_stats = LdaStats(ali_model.am.num_pdfs, D_spl)
        for b, res in enumerate(align):
            if res is None:
                continue
            tids, _w, _c = res
            T = min(len(tids), spliced[b].shape[0])
            lda_stats.accumulate(spliced[b][:T], tid2pdf[tids[:T]])
        lda_dim = min(opts.lda_dim, D_spl)
        A, _evals = estimate_lda(lda_stats, lda_dim)      # [lda_dim, D+1]
        return spliced, lda_dim, np.asarray(A, np.float64)

    spliced, lda_dim, transform = clock("lda", lda_stage)

    def project(b):
        return apply_affine_transform(spliced[b], transform,
                                      device=dev).cpu().numpy()

    utts_t = [(u, project(b), w)
              for b, (u, _f, w) in enumerate(utts_raw)]

    # 3. tree on old-system alignments with projected-feature stats
    # (acc-tree-stats on the new feature space, train_lda_mllt.sh:~90)
    ctx, tm, leaf_stats = clock("tree", lambda: build_triphone_tree(
        lang, ali_model, utts_align, opts,
        stats_feats=[f for (_u, f, _w) in utts_t]))
    am = init_am_from_leaf_stats(leaf_stats, lda_dim, dev)
    model = MonoModel(am, tm, ctx, lang)

    # 4. EM with periodic MLLT
    batch, feats, nf = compile_and_pad(lang, tm, ctx, utts_t,
                                       opts.transition_scale,
                                       opts.self_loop_scale)
    B = len(utts_t)

    cur_align = None
    cur_gauss = am.total_gauss
    inc = max(0, (opts.totgauss - cur_gauss) // max(opts.max_iter_inc, 1))
    for it in range(1, opts.num_iters):
        if cur_align is None or it in opts.realign_iters:
            ll = clock("loglikes", lambda: model.am.loglikes(feats))
            cur_align = clock("align", lambda: viterbi_align(
                batch, ll, nf, opts.acoustic_scale, device=dev))
        if it in opts.mllt_iters:
            def mllt():
                mllt_stats = MlltStats(lda_dim)
                for b, res in enumerate(cur_align):
                    if res is None:
                        continue
                    tids = res[0]
                    accumulate_mllt_from_alignment(
                        model.am, feats[b, : nf[b]], tm.id2pdf_array[tids],
                        mllt_stats)
                M, impr = update_mllt(mllt_stats)
                log.info("MLLT iter %d: objf impr/frame %.4f", it,
                         impr / max(mllt_stats.beta, 1))
                return M

            M = clock("mllt", mllt)
            # compose into the global transform; rotate feats & means
            transform = M @ transform
            feats = np.einsum("de,bte->btd", M, feats).astype(np.float32)
            for g in model.am.pdfs:
                g.means = g.means @ M.T
            model.am.invalidate()
        acc, tcounts, n_ok = clock(
            "accumulate", lambda: _accumulate(model, feats, nf, cur_align))
        target = (min(opts.totgauss, cur_gauss + inc)
                  if it <= opts.max_iter_inc else None)
        clock("update", lambda: _update(model, acc, tcounts, opts, target))
        clock.close(iter_stats, it, n_ok, acc)
        cur_gauss = model.am.total_gauss
        if it % 5 == 0 or it == 1:
            log.info("lda_mllt iter %d: %d/%d aligned, ll/frame %.4f, "
                     "gauss %d", it, n_ok, B,
                     acc.tot_like / max(acc.tot_frames, 1), cur_gauss)
    return LdaMlltModel(model=model, transform=transform)
