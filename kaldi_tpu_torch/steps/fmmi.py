"""fMMI: discriminatively trained feature offsets (fMPE) interleaved with
EBW model updates.

Counterpart of kaldi_tpu/steps/fmmi.py (ref: steps/train_mmi_fmmi.sh —
gmm-est-fmmi alternates: odd iterations update the fMPE projection from
the MMI direct differential with the model fixed, even iterations do EBW
model updates on the fMPE-transformed features; denominator lattices
fixed, acoustics rescored per iteration). The structure is JAX's: the fMPE
posterior GMM (`steps/ubm.train_diag_ubm`), the offsets and the
differential are host numpy as in JAX; the GMM log-likelihoods, the
numerator alignment, the denominator lattices and the statistics run on
the AM's device as in `steps/mmi.py`.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.gmm.ebw import update_ebw_am_diag_gmm
from kaldi_tpu_torch.gmm.estimation import AccumAmDiagGmm
from kaldi_tpu_torch.lat.posteriors import (lattice_forward_backward_mmi,
                                            rescore_lattice)
from kaldi_tpu_torch.steps.mmi import MmiTrainOpts, make_denlats, split_post
from kaldi_tpu_torch.steps.mono import _PhaseClock, compile_and_pad
from kaldi_tpu_torch.steps.ubm import DiagUbmTrainOpts, train_diag_ubm
from kaldi_tpu_torch.transform.fmpe import Fmpe, FmpeOptions

log = logging.getLogger("kaldi_tpu_torch.fmmi")


@dataclasses.dataclass
class FmmiTrainOpts(MmiTrainOpts):
    num_iters: int = 6            # alternating fMPE / EBW
    fmpe: FmpeOptions = dataclasses.field(
        default_factory=lambda: FmpeOptions(learning_rate=0.002))
    fmpe_gauss: int = 16          # size of the fMPE posterior GMM


def train_fmmi(model, den_graph, utts, opts: FmmiTrainOpts = FmmiTrainOpts(),
               silence_phones=frozenset(), iter_stats: list | None = None):
    """-> (fmpe, new_am, objf_history). `model` is a MonoModel-like system;
    `utts` = [(utt, feats, words)]. iter_stats as in
    `train_discriminative` ("fmpe" times the offsets and the fMPE steps,
    "ubm" the posterior GMM in the first iteration)."""
    tm = model.trans_model
    am = model.am
    clock = _PhaseClock(am.device, iter_stats is not None)
    num_batch, feats_raw, nf = compile_and_pad(
        model.lang, tm, model.ctx_dep, utts, opts.transition_scale,
        opts.self_loop_scale)
    D = feats_raw.shape[2]

    def ubm():
        pooled = np.concatenate([f for (_u, f, _w) in utts])
        return train_diag_ubm(pooled.astype(np.float64),
                              DiagUbmTrainOpts(num_gauss=opts.fmpe_gauss,
                                               num_iters=2))

    fmpe = Fmpe(clock("ubm", ubm), D, opts.fmpe)
    _dec, denlats = clock("denlats", lambda: make_denlats(
        model, den_graph, feats_raw, nf, opts))

    hist = []
    for it in range(opts.num_iters):
        # current fMPE-transformed features
        def offsets():
            feats = feats_raw.copy()
            for b in range(len(utts)):
                feats[b, : nf[b]] = fmpe.apply(feats_raw[b, : nf[b]])
            return feats

        feats = clock("fmpe", offsets)
        ll = clock("loglikes", lambda: am.loglikes(feats))
        align = clock("align", lambda: viterbi_align(
            num_batch, ll, nf, opts.acoustic_scale, device=am.device))
        ll = clock("loglikes", lambda: ll.cpu().numpy())

        num_acc = AccumAmDiagGmm(am)
        den_acc = AccumAmDiagGmm(am)
        tot_objf, tot_frames = 0.0, 0
        update_features = (it % 2 == 0)
        for b, lat in enumerate(denlats):
            if lat is None or align[b] is None:
                continue
            tids, _w, num_cost = align[b]
            Tb = int(nf[b])

            def fb():
                rescore_lattice(lat, ll[b], tm, opts.acoustic_scale)
                return lattice_forward_backward_mmi(
                    lat, tids, tm, opts.drop_frames, opts.cancel)

            post, den_like = clock("rescore+fb", fb)
            tot_objf += (-num_cost) - den_like
            tot_frames += Tb
            if update_features:
                def fmpe_step():
                    diff = fmpe.direct_differential(am, feats[b, :Tb], post)
                    fmpe.train_step(feats_raw[b, :Tb], diff)
                clock("fmpe", fmpe_step)
            else:
                pos, neg = split_post(post)

                def accumulate():
                    num_acc.accumulate_from_posteriors(am, feats[b, :Tb],
                                                       pos)
                    den_acc.accumulate_from_posteriors(am, feats[b, :Tb],
                                                       neg)
                clock("accumulate", accumulate)
        if not update_features:
            am = clock("update", lambda: update_ebw_am_diag_gmm(
                am, num_acc, den_acc, opts.ebw))
        hist.append(tot_objf / max(tot_frames, 1))
        log.info("fMMI iter %d (%s): objf/frame %.6f", it,
                 "fMPE" if update_features else "EBW", hist[-1])
        clock.flush(iter_stats, iter=it, objf=hist[-1],
                    align_none=sum(a is None for a in align),
                    den_none=sum(lat is None for lat in denlats))
    return fmpe, am, hist
