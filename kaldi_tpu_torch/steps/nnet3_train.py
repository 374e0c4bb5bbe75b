"""nnet3 TDNN and LSTM training over GMM alignments (the
steps/nnet3/tdnn/train.sh and steps/nnet3/lstm/train.sh roles).

Counterpart of kaldi_tpu/steps/nnet3_train.py: generate the config, get
egs from the GMM's alignments, train with the nnet3 trainer, set the
priors from the alignment counts. The alignment runs on the GMM's device
and the net trains there too (the card unless the GMM was built on the
CPU). The init draws from a `torch.Generator` seeded with `seed`, so only
its stddevs match JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.nnet.train import make_egs
from kaldi_tpu_torch.nnet3.configs import make_lstm_config, make_tdnn_config
from kaldi_tpu_torch.nnet3.network import Nnet3
from kaldi_tpu_torch.nnet3.training import AmNnet3, Nnet3TrainOpts, train_nnet3
from kaldi_tpu_torch.steps.tdnn import align_with_gmm


@dataclasses.dataclass
class Nnet3TrainResult:
    am: AmNnet3
    history: list


def _train_config_net(gmm_model, utts, make_config, train_opts, chunk: int,
                      seed: int) -> Nnet3TrainResult:
    """Align, build the net from make_config(feat_dim, num_pdfs) on the
    GMM's device, train it on chunked egs and set the priors."""
    aligned = align_with_gmm(gmm_model, utts)
    num_pdfs = gmm_model.am.num_pdfs
    net = Nnet3(make_config(utts[0][1].shape[1], num_pdfs),
                device=gmm_model.am.device)
    params = net.init(torch.Generator().manual_seed(seed))
    egs = make_egs(aligned, net.left_context, net.right_context, chunk)
    params, history = train_nnet3(net, params, egs, train_opts)
    net.load_state_dict(params)
    am = AmNnet3(net)
    counts = np.zeros(num_pdfs, np.float64)
    for (_f, pdfs) in aligned:
        np.add.at(counts, pdfs, 1.0)
    am.set_priors_from_alignment_counts(counts)
    return Nnet3TrainResult(am=am, history=history)


def train_tdnn3(
    gmm_model,
    utts,
    splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)),
    hidden_dim: int = 256,
    pnorm_output_dim: int | None = 64,
    train_opts: Nnet3TrainOpts = Nnet3TrainOpts(),
    chunk: int = 8,
    seed: int = 0,
) -> Nnet3TrainResult:
    """GMM-aligned frame CE training of a config-defined p-norm TDNN (the
    nnet3 twin of steps/tdnn.train_tdnn)."""
    return _train_config_net(
        gmm_model, utts, lambda feat_dim, num_pdfs: make_tdnn_config(
            feat_dim, num_pdfs, splice_indexes=splice_indexes,
            hidden_dim=hidden_dim, nonlinearity="PnormComponent",
            pnorm_output_dim=pnorm_output_dim),
        train_opts, chunk, seed)


def train_lstm3(
    gmm_model,
    utts,
    cell_dim: int = 128,
    proj_dim: int = 64,
    num_layers: int = 1,
    splice=(-2, -1, 0, 1, 2),
    train_opts: Nnet3TrainOpts = Nnet3TrainOpts(),
    chunk: int = 20,
    seed: int = 0,
) -> Nnet3TrainResult:
    """GMM-aligned frame CE training of a config-built projected LSTM,
    through the recurrent executor. Chunks are longer than the TDNN's so
    the recurrence sees useful history (the reference's --chunk-width)."""
    return _train_config_net(
        gmm_model, utts, lambda feat_dim, num_pdfs: make_lstm_config(
            feat_dim, num_pdfs, cell_dim=cell_dim, proj_dim=proj_dim,
            num_layers=num_layers, splice=splice),
        train_opts, chunk, seed)
