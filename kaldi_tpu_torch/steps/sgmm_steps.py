"""SGMM2 system training on top of a GMM baseline, and its decode adapter.

Counterpart of kaldi_tpu/steps/sgmm_steps.py (ref: egs/rm/s5
steps/train_sgmm2.sh — UBM from the GMM system's features, SGMM
initialized from the full UBM over the GMM system's tree and transition
model, trained on GMM alignments, decoded with the same HCLG;
steps/train_mmi_sgmm2.sh for bMMI). The steps take no device: they run
where the GMM (or the SGMM) they are given is, the UBMs, the SGMM and all
its statistics on that device in f64. `SgmmAm` serves f32 loglikes as
tensors on the SGMM's device to the padded `BeamSearchDecoder` and to
`CsrBeamDecoder`. JAX accumulates utterance by utterance; here one call
takes all utterances' (frame, state, weight) entries at once (gselect is
per frame, so the statistics are the same sums).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from kaldi_tpu_torch.sgmm.estimate import Sgmm2Accs, train_sgmm2
from kaldi_tpu_torch.sgmm.model import AmSgmm2
from kaldi_tpu_torch.steps.tdnn import align_with_gmm
from kaldi_tpu_torch.steps.ubm import (DiagUbmTrainOpts, FullUbmTrainOpts,
                                       train_diag_ubm, train_full_ubm)

log = logging.getLogger("kaldi_tpu_torch.sgmm")


class SgmmAm:
    """Decoder-facing adapter: loglikes like AmDiagGmm / AmNnet."""

    def __init__(self, sgmm: AmSgmm2, num_gselect: int = 8):
        self.sgmm = sgmm
        self.num_gselect = num_gselect

    @property
    def num_pdfs(self) -> int:
        return self.sgmm.num_states

    @property
    def device(self) -> torch.device:
        return self.sgmm.device

    def loglikes(self, feats, scale: float = 1.0) -> torch.Tensor:
        """[B, T, D] -> [B, T, num_pdfs] f32 on the SGMM's device: the f64
        `loglikes_matrix` of every frame, cast to f32, times scale."""
        x = torch.as_tensor(np.asarray(feats) if not isinstance(
            feats, torch.Tensor) else feats)
        B, T, D = x.shape
        ll = self.sgmm.loglikes_matrix(x.reshape(B * T, D), self.num_gselect)
        return ll.to(torch.float32).view(B, T, -1) * scale

    def loglikes_np(self, feats, scale: float = 1.0) -> np.ndarray:
        return self.loglikes(feats, scale).cpu().numpy()


@dataclasses.dataclass
class SgmmTrainOpts:
    ubm_gauss: int = 16
    phn_dim: int = 10
    spk_dim: int = 0
    num_iters: int = 8
    num_gselect: int = 8
    total_substates: int | None = None


def _entries(pdf_lists) -> tuple:
    """Per-utterance pdf ids -> (frame, state, weight 1) arrays over the
    utterances' concatenated frames."""
    pdfs = np.concatenate([np.asarray(p, np.int64) for p in pdf_lists])
    return (np.arange(len(pdfs)), pdfs, np.ones(len(pdfs)))


def train_sgmm2_system(gmm_model, utts, opts: SgmmTrainOpts = SgmmTrainOpts(),
                       iter_stats: list | None = None,
                       stage_secs: dict | None = None, snapshot=None):
    """GMM system -> SGMM2 acoustic model over the same tree and
    transitions, on the GMM's device. utts: [(utt, feats, words)] in the
    GMM system's feature space. -> (SgmmAm, per-iteration loglikes).
    iter_stats gets `train_sgmm2`'s per-iteration dicts; stage_secs the
    seconds of "align", "diag_ubm", "full_ubm" and "sgmm"; snapshot goes
    to `train_sgmm2`."""
    dev = gmm_model.am.device
    secs = {} if stage_secs is None else stage_secs

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t = time.perf_counter()
    aligned = align_with_gmm(gmm_model, utts)
    secs["align"] = time.perf_counter() - t
    pooled = np.concatenate([f for (f, _p) in aligned])
    t = time.perf_counter()
    dubm = train_diag_ubm(pooled.astype(np.float64),
                          DiagUbmTrainOpts(num_gauss=opts.ubm_gauss,
                                           num_iters=3), device=dev)
    sync()
    secs["diag_ubm"] = time.perf_counter() - t
    t = time.perf_counter()
    fubm = train_full_ubm(dubm, pooled, FullUbmTrainOpts(num_iters=2),
                          device=dev)
    sync()
    secs["full_ubm"] = time.perf_counter() - t
    t = time.perf_counter()
    sgmm = AmSgmm2(fubm, num_states=gmm_model.am.num_pdfs,
                   phn_dim=opts.phn_dim, spk_dim=opts.spk_dim, device=dev)
    sgmm, likes = train_sgmm2(sgmm, pooled,
                              _entries([p for (_f, p) in aligned]),
                              num_iters=opts.num_iters,
                              num_gselect=opts.num_gselect,
                              split_substates_to=opts.total_substates,
                              iter_stats=iter_stats, snapshot=snapshot)
    secs["sgmm"] = time.perf_counter() - t
    log.info("SGMM2: loglike/frame %s", [round(x, 3) for x in likes])
    return SgmmAm(sgmm, opts.num_gselect), likes


@dataclasses.dataclass
class SgmmMmiOpts:
    """(ref: steps/train_mmi_sgmm2.sh defaults + EbwAmSgmm2Options)"""

    num_iters: int = 2
    acoustic_scale: float = 0.1
    beam: float = 16.0
    lattice_beam: float = 7.0
    max_active: int = 256
    boost: float = 0.1           # bMMI boosting factor b
    update_flags: str = "vMc"    # Sigma/w EBW optional (tau-heavy)


def _den_entries(lats, nf, num_tids, tm, boost, offsets):
    """Lattices -> (frame, state, weight) arrays of the den posteriors over
    the concatenated frames (JAX's boost, lattice_to_post and pdf
    posteriors per utterance); utterances without a lattice add none."""
    from kaldi_tpu_torch.lat.posteriors import (lattice_boost,
                                                lattice_to_post,
                                                posterior_to_pdf_post)
    t, j, w = [], [], []
    for b, lat in enumerate(lats):
        if lat is None:
            continue
        if boost > 0 and num_tids is not None:
            lat = lattice_boost(lat, num_tids[b], tm, b=boost)
        post, _tot = lattice_to_post(lat)
        for f, fr in enumerate(posterior_to_pdf_post(post, tm)[: nf[b]]):
            for p, ww in fr:
                t.append(offsets[b] + f)
                j.append(int(p))
                w.append(float(ww))
    return (np.asarray(t, np.int64), np.asarray(j, np.int64),
            np.asarray(w, np.float64))


def train_sgmm2_bmmi(gmm_model, sgmm_am: SgmmAm, den_graph, utts,
                     opts: SgmmMmiOpts = SgmmMmiOpts(),
                     iter_stats: list | None = None):
    """Boosted-MMI EBW training of an SGMM2 system on the SGMM's device
    (ref: steps/train_mmi_sgmm2.sh — numerator statistics from the GMM's
    forced alignments, denominator statistics from lattice posteriors of
    the SGMM's own decode of a weak-LM graph, boosted by phone accuracy).
    -> (SgmmAm, per-iteration MMI objective (num - den loglike / frame),
    the last after the final update). iter_stats gets one dict per
    iteration: seconds of "loglikes", "denlats", "post", "accumulate",
    "update", and the lattice count "none"."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.lat.generate import decode_to_lattices
    from kaldi_tpu_torch.sgmm.ebw import EbwSgmm2Options, update_sgmm2_ebw
    from kaldi_tpu_torch.steps.mono import compile_and_pad

    tm = gmm_model.trans_model
    sgmm = sgmm_am.sgmm
    dev = sgmm.device
    batch, feats, nf = compile_and_pad(gmm_model.lang, tm, gmm_model.ctx_dep,
                                       utts)
    ali = viterbi_align(batch, gmm_model.am.loglikes(feats), nf,
                        opts.acoustic_scale, device=gmm_model.am.device)
    assert all(r is not None for r in ali), "alignment failure in bMMI"
    tid2pdf = tm.id2pdf_array
    num_tids = [np.asarray(r[0], np.int64) for r in ali]
    offsets = np.concatenate([[0], np.cumsum(nf)]).astype(np.int64)
    x = np.concatenate([feats[b, :nf[b]].astype(np.float64)
                        for b in range(len(utts))])
    num_entries = _entries([tid2pdf[t] for t in num_tids])
    dec = BeamSearchDecoder(pack_graph(den_graph.fst, tid2pdf),
                            BeamSearchOpts(beam=opts.beam,
                                           max_active=opts.max_active,
                                           acoustic_scale=opts.acoustic_scale),
                            device=dev)

    def stats(boost):
        st = {}
        t = time.perf_counter()
        ll = sgmm_am.loglikes(feats)
        st["loglikes"] = time.perf_counter() - t
        t = time.perf_counter()
        lats = decode_to_lattices(dec, ll, nf, lattice_beam=opts.lattice_beam)
        st["denlats"] = time.perf_counter() - t
        t = time.perf_counter()
        den_entries = _den_entries(lats, nf, num_tids, tm, boost, offsets)
        st["post"] = time.perf_counter() - t
        st["none"] = sum(lat is None for lat in lats)
        t = time.perf_counter()
        num, den = Sgmm2Accs(sgmm), Sgmm2Accs(sgmm)
        num.accumulate(sgmm, x, num_entries, sgmm_am.num_gselect)
        den.accumulate(sgmm, x, den_entries, sgmm_am.num_gselect)
        obj = (num.tot_like - den.tot_like) / max(num.tot_frames, 1.0)
        st["accumulate"] = time.perf_counter() - t
        return num, den, obj, st

    objs = []
    for _it in range(opts.num_iters):
        num, den, obj, st = stats(opts.boost)
        objs.append(obj)
        t = time.perf_counter()
        update_sgmm2_ebw(sgmm, num, den, EbwSgmm2Options(),
                         update_flags=opts.update_flags)
        st["update"] = time.perf_counter() - t
        if iter_stats is not None:
            iter_stats.append(st)
    # the objective after the last update (den posteriors unboosted, as
    # JAX computes it)
    _num, _den, obj, _st = stats(0.0)
    objs.append(obj)
    return sgmm_am, objs
