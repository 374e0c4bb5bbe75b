"""Hybrid TDNN training from GMM alignments.

Counterpart of kaldi_tpu/steps/tdnn.py (ref: steps/nnet2/train_multisplice_accel2.sh
+ get_egs2.sh: align with the GMM system, dump frame egs with context,
parallel SGD, adjust priors). The alignment runs on the GMM's device and
the TDNN trains there too (the card unless the GMM was built on the
CPU). The init draws from a `torch.Generator` seeded with `seed`: the
port cannot reproduce JAX's PRNGKey stream, so only the init's stddevs
match JAX's, not its draws.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.nnet.train import NnetTrainOpts, make_egs, train_epochs
from kaldi_tpu_torch.steps.mono import MonoModel, compile_and_pad

log = logging.getLogger("kaldi_tpu_torch.tdnn")


@dataclasses.dataclass
class TdnnTrainResult:
    am: AmNnet
    history: list


def align_with_gmm(model: MonoModel, utts, acoustic_scale: float = 0.1):
    """GMM forced alignment -> list of (feats, pdf_ids) for egs."""
    batch, feats, nf = compile_and_pad(
        model.lang, model.trans_model, model.ctx_dep, utts)
    ll = model.am.loglikes(feats)
    results = viterbi_align(batch, ll, nf, acoustic_scale,
                            device=model.am.device)
    out = []
    tid2pdf = model.trans_model.id2pdf_array
    for b, res in enumerate(results):
        if res is None:
            log.warning("alignment failed for %s", utts[b][0])
            continue
        tids, _w, _c = res
        out.append((feats[b, : nf[b]], tid2pdf[tids]))
    return out


def train_tdnn(
    gmm_model: MonoModel,
    utts,
    config: TdnnConfig | None = None,
    train_opts: NnetTrainOpts = NnetTrainOpts(),
    mesh=None,
    chunk: int = 8,
    seed: int = 0,
) -> TdnnTrainResult:
    """Align with `gmm_model`, train a TDNN on its device, and set the
    priors from the alignment counts. With a mesh (parallel.mesh) every
    rank makes this call and the training is data/model parallel over it
    (`train_epochs`)."""
    dev = gmm_model.am.device
    aligned = align_with_gmm(gmm_model, utts)
    num_pdfs = gmm_model.am.num_pdfs
    feat_dim = utts[0][1].shape[1]
    if config is None:
        config = TdnnConfig(feat_dim=feat_dim, num_pdfs=num_pdfs,
                            hidden_dim=256, pnorm_output_dim=64,
                            splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    else:
        config = dataclasses.replace(config, feat_dim=feat_dim,
                                     num_pdfs=num_pdfs)
    egs = make_egs(aligned, config.left_context, config.right_context, chunk)
    model = Tdnn(config, device=dev)
    params = model.init(torch.Generator().manual_seed(seed))
    params, history = train_epochs(model, params, egs, train_opts,
                                   mesh=mesh, device=dev)
    model.load_state_dict(params)
    am = AmNnet(model)
    # priors from alignment counts (ref: nnet-adjust-priors uses avg post;
    # alignment counts are the classic fallback)
    counts = np.zeros(num_pdfs, np.float64)
    for (_f, pdfs) in aligned:
        np.add.at(counts, pdfs, 1.0)
    am.set_priors_from_alignment_counts(counts)
    return TdnnTrainResult(am=am, history=history)
