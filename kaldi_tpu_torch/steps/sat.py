"""train_sat: speaker-adapted training (fMLLR) + two-pass decoding.

Counterpart of kaldi_tpu/steps/sat.py (ref: egs/wsj/s5/steps/train_sat.sh
— triphone training where features are fMLLR-transformed per speaker,
transforms re-estimated at set iterations from the current alignments
(gmm-est-fmllr, `transform-feats --utt2spk`); steps/decode_fmllr.sh —
first pass with the SI model, fMLLR from first-pass alignments, second
pass with adapted features). The fMLLR statistics and solve are host f64
(the port's transform/fmllr.py); the Gaussian posteriors behind them, the
feature transforms, the log-likelihoods and the alignments run on the
model's device, with JAX's loop structure (one posterior call and one
copy back per utterance).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.steps.deltas import (DeltasTrainOpts, build_triphone_tree,
                                          init_am_from_leaf_stats)
from kaldi_tpu_torch.steps.mono import (MonoModel, _PhaseClock, _accumulate,
                                        _update, compile_and_pad)
from kaldi_tpu_torch.transform.fmllr import (FmllrStats, estimate_fmllr,
                                             apply_affine_transform)

log = logging.getLogger("kaldi_tpu_torch.sat")


@dataclasses.dataclass
class SatTrainOpts(DeltasTrainOpts):
    fmllr_iters: tuple = (2, 4, 6, 12)
    fmllr_min_count: float = 100.0


@dataclasses.dataclass
class SatModel:
    model: MonoModel
    transforms: dict             # spk -> [D, D+1]

    def transform(self, spk: str, feats: np.ndarray) -> np.ndarray:
        W = self.transforms.get(spk)
        if W is None:
            return feats
        return apply_affine_transform(feats, W,
                                      self.model.am.device).cpu().numpy()


def estimate_speaker_transforms(
    model: MonoModel, utts, align, min_count: float = 100.0,
    init: dict | None = None,
) -> dict:
    """utts: [(utt, feats, words, spk)] (feats in the CURRENT transformed
    space when called mid-SAT — the reference composes transforms the same
    way, estimating a delta on top and composing); align: per-utt
    (tids, words, cost) or None. -> {spk: [D, D+1]}."""
    tid2pdf = model.trans_model.id2pdf_array
    by_spk: dict = {}
    for (u, feats, _w, spk), res in zip(utts, align):
        if res is None:
            continue
        tids = res[0]
        T = min(len(tids), feats.shape[0])
        st = by_spk.setdefault(spk, FmllrStats(feats.shape[1]))
        st.accumulate_from_alignment(model.am, feats[:T], tid2pdf[tids[:T]])
    out = {}
    for spk, st in by_spk.items():
        W, _impr, count = estimate_fmllr(st, min_count=min_count,
                                         init=init.get(spk) if init else None)
        if count >= min_count:
            out[spk] = W
    return out


def train_sat(
    lang,
    utts,            # [(utt, feats, words, spk)]
    ali_model: MonoModel,
    opts: SatTrainOpts = SatTrainOpts(),
    iter_stats: list | None = None,
) -> SatModel:
    """iter_stats: as `train_deltas`'s, with "fmllr" (statistics,
    estimation, transforming the features and the realignment after it)
    in the fMLLR iterations' dicts."""
    from kaldi_tpu_torch.transform.fmpe import compose_transforms

    dev = ali_model.am.device
    clock = _PhaseClock(dev, iter_stats is not None)
    utts3 = [(u, f, w) for (u, f, w, _s) in utts]
    ctx, tm, leaf_stats = clock("tree", lambda: build_triphone_tree(
        lang, ali_model, utts3, opts))
    dim = utts[0][1].shape[1]
    am = init_am_from_leaf_stats(leaf_stats, dim, dev)
    model = MonoModel(am, tm, ctx, lang)

    batch, raw, nf = compile_and_pad(lang, tm, ctx, utts,
                                     opts.transition_scale,
                                     opts.self_loop_scale)
    B = len(utts)

    transforms: dict = {}

    def transformed():
        out = raw.copy()
        for b, (_u, _f, _w, spk) in enumerate(utts):
            W = transforms.get(spk)
            if W is not None:
                out[b, : nf[b]] = apply_affine_transform(
                    raw[b, : nf[b]], W, dev).cpu().numpy()
        return out

    feats = transformed()
    cur_align = None
    cur_gauss = am.total_gauss
    inc = max(0, (opts.totgauss - cur_gauss) // max(opts.max_iter_inc, 1))
    for it in range(1, opts.num_iters):
        if cur_align is None or it in opts.realign_iters:
            ll = clock("loglikes", lambda: model.am.loglikes(feats))
            cur_align = clock("align", lambda: viterbi_align(
                batch, ll, nf, opts.acoustic_scale, device=dev))
        if it in opts.fmllr_iters:
            def fmllr():
                nonlocal feats
                # estimate a delta transform on the current (already
                # transformed) features, compose with the existing one
                cur_utts = [(u, feats[b, : nf[b]], w, s)
                            for b, (u, _f, w, s) in enumerate(utts)]
                delta = estimate_speaker_transforms(
                    model, cur_utts, cur_align, opts.fmllr_min_count)
                for spk, Wd in delta.items():
                    W_old = transforms.get(spk)
                    transforms[spk] = (Wd if W_old is None
                                       else compose_transforms(Wd, W_old))
                feats = transformed()
                ll = model.am.loglikes(feats)
                return viterbi_align(batch, ll, nf, opts.acoustic_scale,
                                     device=dev)

            cur_align = clock("fmllr", fmllr)
            log.info("SAT iter %d: fMLLR for %d speakers", it,
                     len(transforms))
        acc, tcounts, n_ok = clock(
            "accumulate", lambda: _accumulate(model, feats, nf, cur_align))
        target = (min(opts.totgauss, cur_gauss + inc)
                  if it <= opts.max_iter_inc else None)
        clock("update", lambda: _update(model, acc, tcounts, opts, target))
        clock.close(iter_stats, it, n_ok, acc)
        cur_gauss = model.am.total_gauss
        if it % 5 == 0 or it == 1:
            log.info("SAT iter %d: %d/%d aligned, ll/frame %.4f, gauss %d",
                     it, n_ok, B,
                     acc.tot_like / max(acc.tot_frames, 1), cur_gauss)
    return SatModel(model=model, transforms=transforms)


def decode_fmllr(sat: SatModel, decoder, utts, lang,
                 acoustic_scale: float = 0.1,
                 fmllr_min_count: float = 100.0):
    """Two-pass decoding (ref: steps/decode_fmllr.sh): first pass with
    speaker-independent features; fMLLR estimated from first-pass best
    paths per speaker; second pass with adapted features.

    decoder: any of the port's decoders with `.decode(loglikes, nf)`
    (`BeamSearchDecoder`, `make_decoder`'s, `CsrBeamDecoder`); the
    loglikes are handed to it on the model's device.
    utts: [(utt, feats, spk)] (no transcripts). -> {utt: hyp word ids}.
    """
    model = sat.model
    dev = model.am.device
    tid2pdf = model.trans_model.id2pdf_array
    B = len(utts)
    T = max(f.shape[0] for (_u, f, _s) in utts)
    D = utts[0][1].shape[1]
    feats = np.zeros((B, T, D), np.float32)
    nf = np.zeros(B, np.int32)
    for b, (_u, f, _s) in enumerate(utts):
        feats[b, : f.shape[0]] = f
        nf[b] = f.shape[0]

    # pass 1
    res1 = decoder.decode(model.am.loglikes(feats), nf)
    # fMLLR per speaker from first-pass alignments
    by_spk: dict = {}
    for b, (u, f, spk) in enumerate(utts):
        r = res1[b]
        if r is None:
            continue
        words, tids, _c = r[0], r[1], r[2]
        Tb = min(len(tids), int(nf[b]))
        st = by_spk.setdefault(spk, FmllrStats(D))
        st.accumulate_from_alignment(model.am, feats[b, :Tb],
                                     tid2pdf[np.asarray(tids[:Tb])])
    spk_w = {}
    for spk, st in by_spk.items():
        W, _i, count = estimate_fmllr(st, min_count=fmllr_min_count)
        if count >= fmllr_min_count:
            spk_w[spk] = W
    # pass 2
    feats2 = feats.copy()
    for b, (_u, _f, spk) in enumerate(utts):
        W = spk_w.get(spk)
        if W is not None:
            feats2[b, : nf[b]] = apply_affine_transform(
                feats[b, : nf[b]], W, dev).cpu().numpy()
    res2 = decoder.decode(model.am.loglikes(feats2), nf)
    return {u: res2[b][0] if res2[b] else []
            for b, (u, _f, _s) in enumerate(utts)}
