"""The port's entry points run on the card unless the caller asks for the
CPU: `Recognizer`, `CsrBeamDecoder`, `ChunkedCsrBeamDecoder`,
`AdaptiveCsrBeamDecoder`, `BeamSearchDecoder`, `build_tier_tables`,
`train_epochs`, `train_progressive`, `OnlineMfcc` and
`OnlineFeaturePipeline` default to "cuda", and with no card that default
raises instead of falling back. `FusedStreamingServer`,
`FusedOnlineDecoder`, `OnlineDecoder` and `SingleUtteranceNnet2Decoder`
take no device: they run where their decoder runs; nor does
`make_train_step`'s step, which runs where its tensors are. Inference
builds no autograd graph."""

import inspect

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.decoder.csr_beam import (AdaptiveCsrBeamDecoder,
                                              ChunkedCsrBeamDecoder,
                                              CsrBeamDecoder, CsrBeamOpts,
                                              build_tier_tables)
from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder
from kaldi_tpu_torch.decoder.graph_pack import PackedGraph, split_csr
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, train_epochs,
                                        train_progressive)
from kaldi_tpu_torch.online.decoder import OnlineDecoder
from kaldi_tpu_torch.online.features import OnlineFeaturePipeline, OnlineMfcc
from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
from kaldi_tpu_torch.online.nnet2_decoding import SingleUtteranceNnet2Decoder
from kaldi_tpu_torch.online.serving import FusedStreamingServer
from kaldi_tpu_torch.recognize import Recognizer

ENTRY_POINTS = {"Recognizer": Recognizer.__init__,
                "CsrBeamDecoder": CsrBeamDecoder.__init__,
                "ChunkedCsrBeamDecoder": ChunkedCsrBeamDecoder.__init__,
                "AdaptiveCsrBeamDecoder": AdaptiveCsrBeamDecoder.__init__,
                "BeamSearchDecoder": BeamSearchDecoder.__init__,
                "OnlineMfcc": OnlineMfcc.__init__,
                "OnlineFeaturePipeline": OnlineFeaturePipeline.__init__,
                "build_tier_tables": build_tier_tables,
                "train_epochs": train_epochs,
                "train_progressive": train_progressive}


def _graph():
    return PackedGraph(
        start=0, arc_start=np.array([0, 2, 3], np.int32),
        ilabel=np.array([1, 2, 1], np.int32),
        olabel=np.array([5, 0, 6], np.int32),
        cost=np.array([0.5, 0.25, 0.0], np.float32),
        nextstate=np.array([1, 0, 0], np.int32),
        final=np.array([0.0, np.inf], np.float32),
        pdf=np.array([0, 1, 0], np.int32))


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(name):
    default = inspect.signature(ENTRY_POINTS[name]).parameters["device"] \
        .default
    assert default == "cuda"


def test_server_takes_no_device():
    assert "device" not in inspect.signature(
        FusedStreamingServer.__init__).parameters


@pytest.mark.parametrize("cls", [FusedOnlineDecoder, OnlineDecoder,
                                 SingleUtteranceNnet2Decoder],
                         ids=lambda c: c.__name__)
def test_decoder_bound_classes_take_no_device(cls):
    assert "device" not in inspect.signature(cls.__init__).parameters


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    g = _graph()
    tdnn = Tdnn(TdnnConfig(feat_dim=4, num_pdfs=2, hidden_dim=8,
                           nonlinearity="relu", splice_indexes=((0,),)))
    x, t, w = np.zeros((1, 3, 4), np.float32), np.zeros((1, 3), np.int32), \
        np.ones((1, 3), np.float32)
    build = {"Recognizer": lambda: Recognizer(Tdnn(TdnnConfig(
                 feat_dim=40, num_pdfs=2, hidden_dim=8,
                 nonlinearity="relu")), g),
             "CsrBeamDecoder": lambda: CsrBeamDecoder(g, CsrBeamOpts()),
             "ChunkedCsrBeamDecoder": lambda: ChunkedCsrBeamDecoder(
                 g, CsrBeamOpts()),
             "AdaptiveCsrBeamDecoder": lambda: AdaptiveCsrBeamDecoder(
                 g, CsrBeamOpts()),
             "BeamSearchDecoder": lambda: BeamSearchDecoder(g),
             "OnlineMfcc": lambda: OnlineMfcc(),
             "OnlineFeaturePipeline": lambda: OnlineFeaturePipeline(),
             "build_tier_tables": lambda: build_tier_tables(split_csr(g),
                                                            1024),
             "train_epochs": lambda: train_epochs(
                 tdnn, tdnn.params(), {"feats": x, "targets": t,
                                       "weights": w}, NnetTrainOpts()),
             "train_progressive": lambda: train_progressive(
                 tdnn, tdnn.params(), x, t, w)}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_inference_builds_no_autograd_graph():
    """Even over weights that require gradients, Recognizer and AmNnet
    return tensors outside autograd."""
    tdnn = Tdnn(TdnnConfig(feat_dim=40, num_pdfs=2, hidden_dim=8,
                           nonlinearity="relu", splice_indexes=((0,),)))
    tdnn.init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in tdnn.parameters())
    for p in tdnn.parameters():
        p.requires_grad_(True)
    waves = np.random.default_rng(0).standard_normal((1, 4000)) \
        .astype(np.float32) * 1000
    rec = Recognizer(tdnn, _graph(), CsrBeamOpts(), device="cpu",
                     compute_dtype=None)
    for out in (rec.loglikes(waves),
                AmNnet(tdnn).loglikes(np.zeros((1, 5, 40), np.float32))):
        assert out.grad_fn is None and not out.requires_grad
