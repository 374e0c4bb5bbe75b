"""Flat-start monophone GMM-HMM training.

Counterpart of kaldi_tpu/steps/mono.py (ref: egs/wsj/s5/steps/train_mono.sh:72-126
and the binaries it drives: gmm-init-mono, compile-train-graphs,
align-equal-compiled, gmm-acc-stats-ali, gmm-est, gmm-align-compiled).
The structure is JAX's, kept for parity: equal alignment at iteration 0,
realignment on `realign_iters`, a per-utterance accumulation loop, the
M-step on the host, and `split_by_count` from the occupancies. The device
work is the GMM log-likelihoods of the padded batch, the Viterbi alignment
and each utterance's aligned posteriors, on the model's device (the card
unless the caller asks for "cpu").
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from kaldi_tpu_torch.decoder.graph_pack import pack_graphs
from kaldi_tpu_torch.decoder.viterbi import equal_align, viterbi_align
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.fst.graph import TrainingGraphCompiler
from kaldi_tpu_torch.fst.lang import Lang
from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.estimation import (AccumAmDiagGmm,
                                            mle_diag_gmm_update)
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.tree.context_dep import MonophoneContextDependency

log = logging.getLogger("kaldi_tpu_torch.mono")


@dataclasses.dataclass
class MonoTrainOpts:
    num_iters: int = 40
    max_iter_inc: int = 30       # last iter to increase gaussians on
    totgauss: int = 1000
    init_gauss_factor: float = 1.0  # initial = num_pdfs (1 per pdf)
    realign_iters: tuple = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18,
                            20, 23, 26, 29, 32, 35, 38)
    beam: float = 6.0            # (beam pruning is implicit in dense DP)
    acoustic_scale: float = 0.1  # --acoustic-scale in align (kaldi: 0.1)
    transition_scale: float = 1.0
    self_loop_scale: float = 0.1
    min_gaussian_occupancy: float = 3.0
    perturb_factor: float = 0.01
    power: float = 0.25


@dataclasses.dataclass
class MonoModel:
    am: AmDiagGmm
    trans_model: TransitionModel
    ctx_dep: MonophoneContextDependency
    lang: Lang


def flat_start(lang: Lang, feats_list, device="cuda") -> MonoModel:
    """gmm-init-mono: 1-gauss-per-pdf GMM from global feature moments."""
    ctx = MonophoneContextDependency.from_topo(lang.topo)
    tm = TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    allf = np.concatenate([np.asarray(f) for f in feats_list], axis=0)
    mean = allf.mean(axis=0)
    var = allf.var(axis=0) + 1e-5
    am = AmDiagGmm([DiagGmm.from_stats(mean, var)
                    for _ in range(ctx.num_pdfs)], device)
    return MonoModel(am, tm, ctx, lang)


def compile_and_pad(lang: Lang, trans_model: TransitionModel, ctx_dep, utts,
                    transition_scale: float = 1.0,
                    self_loop_scale: float = 1.0):
    """Training graphs of `utts` ((utt, feats, words, ...) tuples; one
    graph per distinct transcript) packed into one batch, and their
    features padded: -> (batch, feats [B, T, D] f32, num_frames [B])."""
    compiler = TrainingGraphCompiler(lang, trans_model, ctx_dep,
                                     transition_scale, self_loop_scale)
    cache: dict = {}
    graphs = []
    for (_u, _f, words, *_rest) in utts:
        key = tuple(words)
        if key not in cache:
            cache[key] = compiler.compile_transcript(list(words))
        graphs.append(cache[key])
    B = len(utts)
    T = max(u[1].shape[0] for u in utts)
    feats = np.zeros((B, T, utts[0][1].shape[1]), np.float32)
    nf = np.zeros(B, np.int32)
    for b, u in enumerate(utts):
        feats[b, : u[1].shape[0]] = u[1]
        nf[b] = u[1].shape[0]
    return pack_graphs(graphs, trans_model.id2pdf_array), feats, nf


def _accumulate(model: MonoModel, feats, num_frames, align_results):
    """E-step host driver: per-utterance GMM stats + transition counts."""
    am, tm = model.am, model.trans_model
    acc = AccumAmDiagGmm(am)
    trans_counts = np.zeros(tm.num_transition_ids + 1, np.float64)
    tid2pdf = tm.id2pdf_array
    num_aligned = 0
    for b, res in enumerate(align_results):
        if res is None:
            continue
        tids, _words, _cost = res
        Tb = int(num_frames[b])
        pdf_ids = tid2pdf[tids[:Tb]]
        acc.accumulate_from_alignment(am, feats[b, :Tb], pdf_ids)
        np.add.at(trans_counts, tids[:Tb], 1.0)
        num_aligned += 1
    return acc, trans_counts, num_aligned


def _update(model: MonoModel, acc: AccumAmDiagGmm, trans_counts,
            opts: MonoTrainOpts, target_gauss: int | None):
    am, tm = model.am, model.trans_model
    occs = np.array([a.occ.sum() for a in acc.accs])
    for i, a in enumerate(acc.accs):
        am.pdfs[i] = mle_diag_gmm_update(
            am.pdfs[i], a, min_gaussian_occupancy=opts.min_gaussian_occupancy)
    tm.mle_update(trans_counts)
    if target_gauss is not None and target_gauss > am.total_gauss:
        am.split_by_count(target_gauss, opts.perturb_factor, opts.power,
                          occs=occs)
    am.invalidate()


def train_mono(
    lang: Lang,
    utts: list[tuple[str, np.ndarray, list[str]]],  # (utt_id, feats [T,D], words)
    opts: MonoTrainOpts = MonoTrainOpts(),
    device="cuda",
    iter_stats: list | None = None,
) -> MonoModel:
    """Full flat-start EM on `device`. `utts` must fit in memory.

    iter_stats: if a list is given, one dict per iteration is appended
    with the seconds of its phases ("loglikes", "align", "accumulate",
    "update"; the device is synchronised after each, which costs a little
    time), the aligned count and the log-likelihood per frame."""
    dev = resolve_device(device)
    feats_list = [f for (_u, f, _w) in utts]
    model = flat_start(lang, feats_list, dev)
    batch, feats, num_frames = compile_and_pad(
        lang, model.trans_model, model.ctx_dep, utts,
        opts.transition_scale, opts.self_loop_scale)
    B = len(utts)
    clock = _PhaseClock(dev, iter_stats is not None)

    # iteration 0: equal alignment
    align = clock("align", lambda: equal_align(batch, num_frames, device=dev))
    acc, tcounts, n_ok = clock(
        "accumulate", lambda: _accumulate(model, feats, num_frames, align))
    log.info("iter 0 (equal-align): %d/%d aligned", n_ok, B)
    clock("update", lambda: _update(model, acc, tcounts, opts, None))
    clock.close(iter_stats, 0, n_ok, acc)

    cur_gauss = model.am.total_gauss
    inc = max(0, (opts.totgauss - cur_gauss) // max(opts.max_iter_inc, 1))
    for it in range(1, opts.num_iters):
        if it in opts.realign_iters or it == 1:
            ll = clock("loglikes", lambda: model.am.loglikes(feats))
            align = clock("align", lambda: viterbi_align(
                batch, ll, num_frames, opts.acoustic_scale, device=dev))
        acc, tcounts, n_ok = clock(
            "accumulate", lambda: _accumulate(model, feats, num_frames, align))
        target = min(opts.totgauss, cur_gauss + inc) if it <= opts.max_iter_inc else None
        clock("update", lambda: _update(model, acc, tcounts, opts, target))
        clock.close(iter_stats, it, n_ok, acc)
        cur_gauss = model.am.total_gauss
        if it % 5 == 0 or it == 1:
            log.info("iter %d: aligned %d/%d, loglike/frame %.4f, gauss %d",
                     it, n_ok, B,
                     acc.tot_like / max(acc.tot_frames, 1), cur_gauss)
    return model


class _PhaseClock:
    """Seconds per phase of one iteration, when asked for: the device is
    synchronised after each phase so that its work is counted there."""

    def __init__(self, dev: torch.device, on: bool):
        self.sync = on and dev.type == "cuda"
        self.on = on
        self.cur: dict = {}

    def __call__(self, name: str, fn):
        if not self.on:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        if self.sync:
            torch.cuda.synchronize()
        self.cur[name] = self.cur.get(name, 0.0) + time.perf_counter() - t0
        return out

    def close(self, stats: list | None, it: int, n_ok: int, acc):
        self.flush(stats, iter=it, aligned=n_ok,
                   loglike_per_frame=acc.tot_like / max(acc.tot_frames, 1))

    def flush(self, stats: list | None, **fields):
        """Append this iteration's phase seconds with `fields` to `stats`
        (if given) and start the next iteration."""
        if stats is not None:
            stats.append(dict(self.cur, **fields))
        self.cur = {}
