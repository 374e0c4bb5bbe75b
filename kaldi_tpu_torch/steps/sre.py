"""Speaker-recognition pipelines (the fork's headline recipes).

(ref: egs/sre10/v1/run.sh — MFCC → energy VAD → diag+full UBM → T-matrix
 i-vector extractor → LDA/length-norm → PLDA scoring → EER; and
 egs/sre10/v2 — the DNN-UBM variant: senone posteriors from a supervised
 DNN replace the GMM posteriors in i-vector extraction, with the 'UBM'
 means/covariances computed FROM those posteriors
 (sid/init_full_ubm_from_dnn.sh, sid/extract_ivectors_dnn.sh).)

Counterpart of kaldi_tpu/steps/sre.py, which runs all of it as host numpy.
The port keeps JAX's functions and its f64, and puts the batch arithmetic
on `device`: the UBMs' accumulation, the posterior UBM's moments, the
i-vector stats, the extractor's EM and every i-vector extraction (one
batch path over many utterances; JAX extracts one utterance at a time,
rebuilding U each time). VAD, PLDA, scoring and the EER are host code, as
in JAX. As in JAX, the PLDA is trained on `SreSystem.ivectors` of the
training utterances' voiced frames, which runs the VAD on them a second
time when `use_vad` is set (and, for v2, calls `post_fn` again).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.gmm.full_gmm import (AccumFullGmm, FullGmm,
                                          floor_eigenvalues)
from kaldi_tpu_torch.ivector.extractor import (IvectorExtractor,
                                               train_ivector_extractor)
from kaldi_tpu_torch.ivector.metrics import compute_eer
from kaldi_tpu_torch.ivector.plda import Plda, PldaStats, length_normalize
from kaldi_tpu_torch.ivector.vad import (VadOpts, compute_vad,
                                         select_voiced_frames)
from kaldi_tpu_torch.steps.ubm import (DiagUbmTrainOpts, FullUbmTrainOpts,
                                       train_diag_ubm, train_full_ubm)

log = logging.getLogger("kaldi_tpu_torch.sre")


def full_ubm_from_posteriors(feats_list, post_list, num_classes: int,
                             var_floor: float = 1e-3,
                             device="cuda") -> FullGmm:
    """Weighted full-covariance 'UBM' whose components are the posterior
    classes (senones) of a supervised model
    (ref: sid/init_full_ubm_from_dnn.sh / fgmm-global-acc-stats-post).
    The moments are f64 GEMMs on `device`
    (`AccumFullGmm.accumulate_posteriors_batch`), the eigenvalue floor of
    every class one batched eigh there."""
    dev = resolve_device(device)
    acc = AccumFullGmm(num_classes, feats_list[0].shape[1])
    acc.accumulate_posteriors_batch(feats_list, post_list, dev)
    safe = np.maximum(acc.occ, 1e-8)
    means = acc.mean_acc / safe[:, None]
    covars = acc.cov_acc / safe[:, None, None] - np.einsum(
        "cd,ce->cde", means, means)
    # floor eigenvalues for stability
    covars = floor_eigenvalues(covars, var_floor, dev)
    weights = acc.occ / max(acc.occ.sum(), 1e-8)
    return FullGmm(np.maximum(weights, 1e-8), means, covars)


@dataclasses.dataclass
class SrePipelineOpts:
    num_gauss: int = 64
    ivector_dim: int = 32
    ubm_iters: int = 3
    ivector_iters: int = 4
    plda_iters: int = 8
    num_gselect: int = 10
    use_vad: bool = True
    vad: VadOpts = dataclasses.field(default_factory=VadOpts)


@dataclasses.dataclass
class SreSystem:
    ubm: FullGmm
    extractor: IvectorExtractor
    plda: Plda
    opts: SrePipelineOpts
    post_fn: object = None        # optional: feats -> [T, C] posteriors
    device: object = "cuda"       # where i-vectors are extracted

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def voiced(self, feats: np.ndarray) -> np.ndarray:
        return _voiced(feats, self.opts)

    def stats(self, feats_list) -> tuple[torch.Tensor, torch.Tensor]:
        """Voiced frames' stats of many utterances on the device."""
        fl = [self.voiced(f) for f in feats_list]
        posts = (None if self.post_fn is None
                 else [np.asarray(self.post_fn(f)) for f in fl])
        return self.extractor.batch_stats(fl, self.opts.num_gselect,
                                          posts=posts, device=self.device)

    def ivectors(self, feats_list) -> np.ndarray:
        """[N, K] i-vectors of many utterances, one device batch."""
        return self.extractor.extract_batch(self.stats(feats_list),
                                            self.device)

    def ivector(self, feats: np.ndarray) -> np.ndarray:
        return self.ivectors([feats])[0]


def train_sre_system(
    train_utts: dict,             # spk -> [feats [T, D]]
    opts: SrePipelineOpts = SrePipelineOpts(),
    post_fn=None,                 # DNN posteriors (v2 recipe); None = GMM
    num_post_classes: int | None = None,
    device="cuda",
    stage_stats: dict | None = None,
) -> SreSystem:
    """The egs/sre10 v1 (post_fn=None) / v2 (post_fn set) pipeline, its
    batch arithmetic on `device`. stage_stats, if given, gets "ubm_iters"
    (the full UBM's `train_full_ubm` iter_stats, v1), "diag_gmm" (v1's
    diag UBM, else None), "ivector_iters" (each extractor EM iteration's
    seconds), "ivectors" (the PLDA's training i-vectors) and the other
    stages' seconds ("stats" the extractor's training stats)."""
    dev = resolve_device(device)
    voiced = {spk: [_voiced(f, opts) for f in utts]
              for spk, utts in train_utts.items()}
    flat = [f for us in voiced.values() for f in us]
    ubm_iters: list = []
    t = time.perf_counter()
    if post_fn is None:
        pooled = np.concatenate(flat)
        dubm = train_diag_ubm(pooled, DiagUbmTrainOpts(
            num_gauss=opts.num_gauss, num_iters=opts.ubm_iters), device=dev)
        t_diag = time.perf_counter() - t
        ubm = train_full_ubm(dubm, pooled,
                             FullUbmTrainOpts(num_iters=opts.ubm_iters),
                             device=dev, iter_stats=ubm_iters)
        posts = None
    else:
        t_diag, dubm = 0.0, None
        posts = [np.asarray(post_fn(f)) for f in flat]
        ubm = full_ubm_from_posteriors(flat, posts, num_post_classes,
                                       device=dev)
        log.info("DNN-UBM: %d classes", ubm.num_gauss)
    t_ubm = time.perf_counter() - t

    # EM over the stats of every training utterance; with post_fn the
    # posteriors are the supplied ones (the v2 path)
    t = time.perf_counter()
    em_iters: list = []
    ext = train_ivector_extractor(ubm, flat, opts.ivector_dim,
                                  num_iters=opts.ivector_iters,
                                  num_gselect=opts.num_gselect, device=dev,
                                  posts=posts, iter_stats=em_iters)
    t_ext = time.perf_counter() - t

    system = SreSystem(ubm=ubm, extractor=ext, plda=None, opts=opts,
                       post_fn=post_fn, device=dev)
    t = time.perf_counter()
    ivs = system.ivectors(flat)
    t_iv = time.perf_counter() - t
    t = time.perf_counter()
    stats = PldaStats(opts.ivector_dim)
    i = 0
    for utts in voiced.values():
        stats.add_speaker(length_normalize(ivs[i:i + len(utts)]))
        i += len(utts)
    system.plda = Plda.train(stats, num_iters=opts.plda_iters)
    if stage_stats is not None:
        em_secs = [s["secs"] for s in em_iters]
        stage_stats.update(diag_ubm=t_diag, diag_gmm=dubm, ubm=t_ubm,
                           ubm_iters=ubm_iters, stats=t_ext - sum(em_secs),
                           ivector_iters=em_secs, train_ivectors=t_iv,
                           plda=time.perf_counter() - t, ivectors=ivs)
    return system


def _voiced(feats: np.ndarray, opts: SrePipelineOpts) -> np.ndarray:
    """The frames `compute_vad` keeps when `use_vad` (all of them if it
    keeps none), else all."""
    if opts.use_vad:
        vad = compute_vad(feats, opts.vad)
        if vad.any():
            feats = select_voiced_frames(feats, vad)
    return feats


def evaluate_sre(system: SreSystem, enroll: dict, test: dict, trials):
    """enroll/test: key -> feats; trials: [(enroll_key, test_key, bool)].
    -> (eer, scores dict) (ref: sre10 scoring + ivectorbin/compute-eer).
    The enroll and test i-vectors are one device batch."""
    ivs = system.ivectors(list(enroll.values()) + list(test.values()))
    ivs = [length_normalize(v[None])[0] for v in ivs]
    e_iv = dict(zip(enroll, ivs[:len(enroll)]))
    t_iv = dict(zip(test, ivs[len(enroll):]))
    scores = system.plda.score_trials(
        {k: v for k, v in e_iv.items()}, t_iv,
        n_enroll={k: 1 for k in e_iv})
    target, nontarget = [], []
    out = {}
    for (ek, tk, is_target) in trials:
        s = scores[(ek, tk)]
        out[(ek, tk)] = s
        (target if is_target else nontarget).append(s)
    eer, _th = compute_eer(target, nontarget)
    return eer, out
