"""The port's entry points run on the card unless the caller asks for the
CPU: `Recognizer`, `CsrBeamDecoder`, `ChunkedCsrBeamDecoder`,
`AdaptiveCsrBeamDecoder` and `build_tier_tables` default to "cuda", and
with no card that default raises instead of falling back.
`FusedStreamingServer` takes no device: it runs where its decoder runs
(tests/test_torch_serving.py)."""

import inspect

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.decoder.csr_beam import (AdaptiveCsrBeamDecoder,
                                              ChunkedCsrBeamDecoder,
                                              CsrBeamDecoder, CsrBeamOpts,
                                              build_tier_tables)
from kaldi_tpu_torch.decoder.graph_pack import PackedGraph, split_csr
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.online.serving import FusedStreamingServer
from kaldi_tpu_torch.recognize import Recognizer

ENTRY_POINTS = {"Recognizer": Recognizer.__init__,
                "CsrBeamDecoder": CsrBeamDecoder.__init__,
                "ChunkedCsrBeamDecoder": ChunkedCsrBeamDecoder.__init__,
                "AdaptiveCsrBeamDecoder": AdaptiveCsrBeamDecoder.__init__,
                "build_tier_tables": build_tier_tables}


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


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    g = _graph()
    build = {"Recognizer": lambda: Recognizer(Tdnn(TdnnConfig(
                 feat_dim=40, num_pdfs=2, hidden_dim=8,
                 nonlinearity="relu")), g),
             "CsrBeamDecoder": lambda: CsrBeamDecoder(g, CsrBeamOpts()),
             "ChunkedCsrBeamDecoder": lambda: ChunkedCsrBeamDecoder(
                 g, CsrBeamOpts()),
             "AdaptiveCsrBeamDecoder": lambda: AdaptiveCsrBeamDecoder(
                 g, CsrBeamOpts()),
             "build_tier_tables": lambda: build_tier_tables(split_csr(g),
                                                            1024)}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
