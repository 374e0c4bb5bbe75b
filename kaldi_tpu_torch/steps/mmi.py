"""Discriminative GMM training: MMI / boosted-MMI / MPE / sMBR.

Counterpart of kaldi_tpu/steps/mmi.py (ref: egs/wsj/s5/steps/{make_denlats.sh,
train_mmi.sh,train_mpe.sh} and the binaries gmm-rescore-lattice,
lattice-boost-ali, lattice-to-post, lattice-to-mpe-post, gmm-acc-stats2,
gmm-est-gaussians-ebw). The structure is JAX's, kept for parity: the
denominator lattices are generated once by the padded `BeamSearchDecoder`
and rescored in place every iteration; per iteration the GMM
log-likelihoods of the padded batch and the numerator's Viterbi alignment
run on the AM's device (the card unless the model was built on the CPU),
the loglikes come to the host in one copy, and each utterance's lattice is
rescored and forward-backwarded on the host (the per-arc Python of
`lat/posteriors.py`), its num and den statistics accumulated from the
signed posteriors on the AM's device (`accumulate_from_posteriors`), and
the EBW update runs on the host.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.graph_pack import pack_graph
from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.gmm.ebw import EbwOptions, update_ebw_am_diag_gmm
from kaldi_tpu_torch.gmm.estimation import AccumAmDiagGmm
from kaldi_tpu_torch.lat.generate import decode_to_lattices
from kaldi_tpu_torch.lat.posteriors import (
    lattice_boost, lattice_forward_backward_mmi,
    lattice_forward_backward_mpe_variants, rescore_lattice)
from kaldi_tpu_torch.steps.mono import _PhaseClock, compile_and_pad

log = logging.getLogger("kaldi_tpu_torch.mmi")


@dataclasses.dataclass
class MmiTrainOpts:
    num_iters: int = 4
    acoustic_scale: float = 0.1
    beam: float = 16.0
    lattice_beam: float = 7.0
    max_active: int = 512
    boost: float = 0.0           # bMMI boosting factor b
    drop_frames: bool = True
    cancel: bool = True
    criterion: str = "mmi"       # 'mmi' | 'smbr' | 'mpfe'
    ebw: EbwOptions = dataclasses.field(default_factory=EbwOptions)
    transition_scale: float = 1.0
    self_loop_scale: float = 0.1


def make_denlats(model, den_graph, feats, num_frames, opts: MmiTrainOpts):
    """Decode the training data against the (weak-LM) denominator graph on
    the AM's device (ref: steps/make_denlats.sh — gmm-latgen-faster on the
    train set). -> (decoder, lattices; None where decoding failed)."""
    packed = pack_graph(den_graph.fst, model.trans_model.id2pdf_array)
    dec = BeamSearchDecoder(packed, BeamSearchOpts(
        beam=opts.beam, max_active=opts.max_active,
        acoustic_scale=opts.acoustic_scale), device=model.am.device)
    ll = model.am.loglikes_np(feats)
    return dec, decode_to_lattices(dec, ll, num_frames,
                                   lattice_beam=opts.lattice_beam)


def split_post(post):
    """Signed per-frame posteriors -> (positive part, negated negative
    part): the num and den statistics' weights."""
    pos = [[(p, w) for p, w in fr if w > 0] for fr in post]
    neg = [[(p, -w) for p, w in fr if w < 0] for fr in post]
    return pos, neg


def discriminative_stats(am, tm, denlats, align, loglikes, feats, num_frames,
                         opts: MmiTrainOpts, silence_phones=frozenset(),
                         clock=None):
    """One iteration's statistics (the loop body of JAX's
    `train_discriminative`): each lattice that has an alignment is
    rescored in place with `loglikes` [B, T, P] (numpy, unscaled),
    forward-backwarded for opts.criterion, and its signed posteriors
    accumulated into num and den statistics on the AM's device.
    -> (num_acc, den_acc, total objective, frames, lattices used)."""
    clock = clock or _PhaseClock(am.device, False)
    num_acc = AccumAmDiagGmm(am)
    den_acc = AccumAmDiagGmm(am)
    tot_objf, tot_frames, used = 0.0, 0, 0
    for b, lat in enumerate(denlats):
        if lat is None or align[b] is None:
            continue
        tids, _words, num_cost = align[b]
        Tb = int(num_frames[b])

        def fb():
            rescore_lattice(lat, loglikes[b], tm, opts.acoustic_scale)
            if opts.criterion == "mmi":
                post, den_like = lattice_forward_backward_mmi(
                    lat, tids, tm, opts.drop_frames, opts.cancel)
                return post, (-num_cost) - den_like
            return lattice_forward_backward_mpe_variants(
                lat, tids, tm, opts.criterion, silence_phones)

        post, objf = clock("rescore+fb", fb)
        pos, neg = split_post(post)

        def accumulate():
            num_acc.accumulate_from_posteriors(am, feats[b, :Tb], pos)
            den_acc.accumulate_from_posteriors(am, feats[b, :Tb], neg)

        clock("accumulate", accumulate)
        tot_objf += objf
        tot_frames += Tb
        used += 1
    return num_acc, den_acc, tot_objf, tot_frames, used


def train_discriminative(
    model,                       # MonoModel-like: am, trans_model, ctx_dep, lang
    den_graph,                   # HCLG built with a weakened (e.g. unigram) G
    utts,                        # [(utt_id, feats [T,D], words)]
    opts: MmiTrainOpts = MmiTrainOpts(),
    silence_phones=frozenset(),
    iter_stats: list | None = None,
):
    """EBW training loop on the AM's device. Returns (new_am,
    objf_history).

    Per iteration (all-in-memory analogue of steps/train_mmi.sh):
      1. numerator: Viterbi-align training graphs with the current model
      2. denominator: acoustically rescore the (fixed) denlats
      3. accumulate num/den stats, EBW update.

    Lattices or alignments that are None are skipped, as in JAX.

    iter_stats: if a list is given, one dict per iteration is appended
    with the seconds of its phases ("denlats" in the first, "loglikes",
    "align", "boost" in the first, "rescore+fb", "accumulate", "update";
    the device is synchronised after each), the objective per frame, the
    lattices used, the None lattices and alignments, and the lattices'
    mean arc count."""
    tm = model.trans_model
    am = model.am
    clock = _PhaseClock(am.device, iter_stats is not None)
    num_batch, feats, nf = compile_and_pad(
        model.lang, tm, model.ctx_dep, utts, opts.transition_scale,
        opts.self_loop_scale)
    _dec, denlats = clock("denlats", lambda: make_denlats(
        model, den_graph, feats, nf, opts))
    den_none = sum(lat is None for lat in denlats)
    arcs = [lat.num_arcs for lat in denlats if lat is not None]

    objf_hist = []
    boosted = False
    for it in range(opts.num_iters):
        ll = clock("loglikes", lambda: am.loglikes(feats))
        align = clock("align", lambda: viterbi_align(
            num_batch, ll, nf, opts.acoustic_scale, device=am.device))
        ll = clock("loglikes", lambda: ll.cpu().numpy())

        if opts.boost != 0.0 and not boosted:
            def boost():
                for b, lat in enumerate(denlats):
                    if lat is None or align[b] is None:
                        continue
                    lattice_boost(lat, align[b][0], tm, opts.boost,
                                  silence_phones)
            clock("boost", boost)
            boosted = True

        num_acc, den_acc, tot_objf, tot_frames, used = discriminative_stats(
            am, tm, denlats, align, ll, feats, nf, opts, silence_phones,
            clock)
        objf = tot_objf / max(tot_frames, 1)
        objf_hist.append(objf)
        log.info("iter %d: %s objf/frame %.6f", it, opts.criterion, objf)
        am = clock("update", lambda: update_ebw_am_diag_gmm(
            am, num_acc, den_acc, opts.ebw, update_weights=False))
        clock.flush(iter_stats, iter=it, objf=objf, lattices=used,
                    den_none=den_none,
                    align_none=sum(a is None for a in align),
                    mean_arcs=float(np.mean(arcs)) if arcs else 0.0)
    return am, objf_hist
