"""The port's entry points run on the card unless the caller asks for the
CPU: `Recognizer`, `CsrBeamDecoder`, `ChunkedCsrBeamDecoder`,
`AdaptiveCsrBeamDecoder`, `BeamSearchDecoder`, `build_tier_tables`,
`train_epochs`, `train_progressive`, `OnlineMfcc`,
`OnlineFeaturePipeline` and the GMM path's `AmDiagGmm`, `viterbi_align`,
`equal_align`, `flat_start`, `train_mono`, `DenseViterbiDecoder`,
`make_decoder` and the triphone ladder's `init_am_from_leaf_stats` default
to "cuda", and with no card that default raises instead of falling back.
The ladder's steps (`build_triphone_tree`, `train_deltas`,
`train_lda_mllt`, `train_sat`, `decode_fmllr`, `align_with_gmm`,
`train_tdnn`) and the discriminative steps (`make_denlats`,
`train_discriminative`, `train_fmmi`, `train_nnet_discriminative`,
`update_ebw_am_diag_gmm`) take no device: they run where the model they
are given is, as a CPU run shows. `FusedStreamingServer`,
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
from kaldi_tpu_torch.decoder.dense import DenseViterbiDecoder, make_decoder
from kaldi_tpu_torch.decoder.graph_pack import (PackedGraph,
                                                PackedGraphBatch, split_csr)
from kaldi_tpu_torch.decoder.viterbi import equal_align, viterbi_align
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
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
from kaldi_tpu_torch.steps.deltas import (DeltasTrainOpts,
                                          build_triphone_tree,
                                          init_am_from_leaf_stats,
                                          train_deltas)
from kaldi_tpu_torch.steps.lda_mllt import train_lda_mllt
from kaldi_tpu_torch.steps.mono import MonoTrainOpts, flat_start, train_mono
from kaldi_tpu_torch.steps.sat import decode_fmllr, train_sat
from kaldi_tpu_torch.steps.tdnn import align_with_gmm, train_tdnn
from kaldi_tpu_torch.fst.graph import make_hclg
from kaldi_tpu_torch.gmm.ebw import update_ebw_am_diag_gmm
from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
from kaldi_tpu_torch.nnet.discriminative import train_nnet_discriminative
from kaldi_tpu_torch.steps.fmmi import train_fmmi
from kaldi_tpu_torch.steps.mmi import (MmiTrainOpts, make_denlats,
                                       train_discriminative)

ENTRY_POINTS = {"Recognizer": Recognizer.__init__,
                "CsrBeamDecoder": CsrBeamDecoder.__init__,
                "ChunkedCsrBeamDecoder": ChunkedCsrBeamDecoder.__init__,
                "AdaptiveCsrBeamDecoder": AdaptiveCsrBeamDecoder.__init__,
                "BeamSearchDecoder": BeamSearchDecoder.__init__,
                "OnlineMfcc": OnlineMfcc.__init__,
                "OnlineFeaturePipeline": OnlineFeaturePipeline.__init__,
                "build_tier_tables": build_tier_tables,
                "train_epochs": train_epochs,
                "train_progressive": train_progressive,
                "AmDiagGmm": AmDiagGmm.__init__,
                "viterbi_align": viterbi_align,
                "equal_align": equal_align,
                "flat_start": flat_start,
                "train_mono": train_mono,
                "DenseViterbiDecoder": DenseViterbiDecoder.__init__,
                "make_decoder": make_decoder,
                "init_am_from_leaf_stats": init_am_from_leaf_stats}
LADDER_STEPS = [build_triphone_tree, train_deltas, train_lda_mllt, train_sat,
                decode_fmllr, align_with_gmm, train_tdnn]
DISCRIMINATIVE_STEPS = [make_denlats, train_discriminative, train_fmmi,
                        train_nnet_discriminative, update_ebw_am_diag_gmm]


def _graph():
    return PackedGraph(
        start=0, arc_start=np.array([0, 2, 3], np.int32),
        ilabel=np.array([1, 2, 1], np.int32),
        olabel=np.array([5, 0, 6], np.int32),
        cost=np.array([0.5, 0.25, 0.0], np.float32),
        nextstate=np.array([1, 0, 0], np.int32),
        final=np.array([0.0, np.inf], np.float32),
        pdf=np.array([0, 1, 0], np.int32))


def _batch():
    """A one-graph alignment batch of _graph()."""
    g = _graph()
    return PackedGraphBatch(
        g.arc_start[None], g.ilabel[None], g.olabel[None], g.cost[None],
        g.nextstate[None], np.array([[0, 0, 1]], np.int32), g.pdf[None],
        g.final[None], np.zeros(1, np.int32), np.array([2]), np.array([3]))


def _lang():
    return prepare_lang(Lexicon.parse("A P1"), ["SIL"], "SIL")


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
                 tdnn, tdnn.params(), x, t, w),
             "AmDiagGmm": lambda: AmDiagGmm([DiagGmm.from_stats(
                 np.zeros(4), np.ones(4))]),
             "viterbi_align": lambda: viterbi_align(
                 _batch(), np.zeros((1, 3, 2), np.float32), np.array([3])),
             "equal_align": lambda: equal_align(_batch(), np.array([3])),
             "flat_start": lambda: flat_start(_lang(), [x[0]]),
             "train_mono": lambda: train_mono(_lang(), [("u", x[0], ["A"])]),
             "DenseViterbiDecoder": lambda: DenseViterbiDecoder(g),
             "make_decoder": lambda: make_decoder(g),
             "init_am_from_leaf_stats": lambda: init_am_from_leaf_stats(
                 [None], 4)}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


@pytest.mark.parametrize("fn", LADDER_STEPS, ids=lambda f: f.__name__)
def test_ladder_steps_take_no_device(fn):
    assert "device" not in inspect.signature(fn).parameters


def test_ladder_steps_run_where_their_model_is():
    """A CPU monophone gives a CPU triphone model, and a CPU TDNN."""
    rng = np.random.RandomState(0)
    utts = [(f"u{i}", rng.randn(30, 4).astype(np.float32), ["A"])
            for i in range(3)]
    mono = flat_start(_lang(), [f for _u, f, _w in utts], "cpu")
    tri = train_deltas(_lang(), utts, mono, DeltasTrainOpts(
        num_iters=2, totgauss=8, max_iter_inc=1, num_leaves=4,
        tree_thresh=0.0))
    assert tri.am.device.type == "cpu"
    res = train_tdnn(tri, utts, TdnnConfig(
        feat_dim=0, num_pdfs=0, hidden_dim=8, nonlinearity="relu",
        splice_indexes=((0,),)), NnetTrainOpts(num_epochs=1))
    assert res.am.device.type == "cpu"


@pytest.mark.parametrize("fn", DISCRIMINATIVE_STEPS, ids=lambda f: f.__name__)
def test_discriminative_steps_take_no_device(fn):
    assert "device" not in inspect.signature(fn).parameters


def test_discriminative_steps_run_where_their_model_is():
    """A CPU monophone gives CPU denominator lattices' decoder and a CPU
    bMMI model."""
    rng = np.random.RandomState(0)
    lang = _lang()
    utts = [(f"u{i}", rng.randn(30, 4).astype(np.float32), ["A"])
            for i in range(3)]
    mono = train_mono(lang, utts, MonoTrainOpts(num_iters=2, totgauss=4,
                                                max_iter_inc=1), device="cpu")
    arpa = ("\\data\\\nngram 1=3\n\n\\1-grams:\n-1\tA\n-99\t<s>\n"
            "-1\t</s>\n\n\\end\\\n")
    den = make_hclg(lang, arpa_to_g(ArpaLm.parse(arpa), lang.words),
                    mono.trans_model, mono.ctx_dep, self_loop_scale=0.1)
    am, hist = train_discriminative(mono, den, utts, MmiTrainOpts(
        num_iters=1, boost=0.1))
    assert am.device.type == "cpu" and len(hist) == 1


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
