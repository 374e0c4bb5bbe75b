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
are given is, as a CPU run shows. The neural families' `Nnet3`, `Nnet1`,
`load_nnet1`, `LstmProjected` and `Rbm` default to "cuda" too; their
trainers (`train_nnet3`, `train_tdnn3`, `train_lstm3`, `train_frmshuff`,
`train_lstm_streams`) take no device and run where their model or GMM
is. The speaker-recognition path's `train_diag_ubm` (unless asked for
JAX's host code by `host_numpy`), `train_full_ubm`,
`full_ubm_from_posteriors`, `train_sre_system`, `SreSystem`,
`sre_system_from_jax`, `LogisticRegression.train`,
`train_ivector_extractor`, `mle_full_gmm_update`, `floor_eigenvalues`,
the full GMM's batch path (`FullGmm.device_pack` / `loglikes_batch` /
`posteriors_batch` / `loglike_batch`, `AccumFullGmm.accumulate_batch` /
`accumulate_posteriors_batch`) and the extractor's
(`IvectorExtractor.on_device` / `batch_stats` / `extract_batch`,
`IvectorStats`) default to "cuda" too; `evaluate_sre` runs where its
system is, `IvectorStats.accumulate` / `update` where their statistics
are. The adaptation and SGMM2 path's `AmSgmm2`, `FmllrRawAccs`,
`BasisFmllrAccus`, `RegressionTree`, `MllrStats`, `LinearVtln`,
`HldaStats` and the converters `sgmm2_from_jax`,
`regression_tree_from_jax`, `linear_vtln_from_jax` and
`fmllr_raw_accs_from_jax` default to "cuda"; its steps and estimators
(`train_sgmm2_system`, `train_sgmm2_bmmi`, `train_sgmm2`, `update_sgmm2`,
`estimate_speaker_vector`, `update_sgmm2_ebw`, `estimate_sgmm2_fmllr`,
`compute_gpost`, `estimate_fmllr_raw`, `compute_basis_fmllr_transform`,
`estimate_hlda`) take no device and run where their model, statistics or
basis are. The rescoring and feature modules' device entry points
(`ConstArpaLm.device_tables` / `step_batch` / `final_cost_batch`,
`lattice_lmrescore_const_arpa_batch` / `_many`, `convolve_signals`,
`reverberate`, `LinearResample.resample`, `ArbitraryResample.resample`,
`resample_waveform`, `compute_kaldi_pitch`) default to "cuda" and run on
the CPU when asked; their host code (the scalar rescorer, lattice
alignment, MBR, scoring, KWS, `process_pitch`, `synth_trigram_arpa`,
`decode_biglm_exact`) takes no device, and `decode_biglm` runs where its
decoder runs. `FusedStreamingServer`,
`FusedOnlineDecoder`, `OnlineDecoder` and `SingleUtteranceNnet2Decoder`
take no device: they run where their decoder runs; nor does
`make_train_step`'s step, which runs where its tensors are. The file
layer's loaders of device objects (`load_gmm_system`, `load_am_nnet`,
`load_raw_nnet`, `load_am_nnet3`, `load_sgmm2`, `load_sgmm2_accs`) and
the server's `fused_session_factory` default to "cuda" too; the serving
classes (`DecodeSession`, `FusedDecodeSession`, `AudioServer`,
`ThreadedSingleUtteranceDecoder`, `SingleUtteranceGmmDecoder`) take no
device. Inference builds no autograd graph."""

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
from kaldi_tpu_torch.nnet1.lstm import LstmConfig, LstmProjected
from kaldi_tpu_torch.nnet1.nnet import Nnet1, load_nnet1, train_frmshuff
from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
from kaldi_tpu_torch.nnet1.train import StreamTrainOpts, train_lstm_streams
from kaldi_tpu_torch.nnet3.configs import make_lstm_config
from kaldi_tpu_torch.nnet3.network import Nnet3
from kaldi_tpu_torch.nnet3.training import Nnet3TrainOpts, train_nnet3
from kaldi_tpu_torch.steps.nnet3_train import train_lstm3, train_tdnn3
from kaldi_tpu_torch.gmm.full_gmm import (AccumFullGmm, FullGmm,
                                          floor_eigenvalues,
                                          mle_full_gmm_update)
from kaldi_tpu_torch.ivector.extractor import (IvectorExtractor,
                                               IvectorStats,
                                               train_ivector_extractor)
from kaldi_tpu_torch.ivector.logistic_regression import LogisticRegression
from kaldi_tpu_torch.params import sre_system_from_jax
from kaldi_tpu_torch.steps.sre import (SrePipelineOpts,
                                       SreSystem, full_ubm_from_posteriors,
                                       train_sre_system)
from kaldi_tpu_torch.steps.ubm import (DiagUbmTrainOpts, train_diag_ubm,
                                       train_full_ubm)
from kaldi_tpu_torch.params import (fmllr_raw_accs_from_jax,
                                    linear_vtln_from_jax,
                                    regression_tree_from_jax, sgmm2_from_jax)
from kaldi_tpu_torch.sgmm import (AmSgmm2, estimate_speaker_vector,
                                  train_sgmm2, update_sgmm2)
from kaldi_tpu_torch.sgmm.ebw import update_sgmm2_ebw
from kaldi_tpu_torch.sgmm.fmllr import estimate_sgmm2_fmllr
from kaldi_tpu_torch.sgmm.gpost import compute_gpost
from kaldi_tpu_torch.steps.sgmm_steps import (SgmmTrainOpts,
                                              train_sgmm2_bmmi,
                                              train_sgmm2_system)
from kaldi_tpu_torch.transform.basis_fmllr import (
    BasisFmllrAccus, compute_basis_fmllr_transform)
from kaldi_tpu_torch.transform.fmllr_raw import (FmllrRawAccs,
                                                 estimate_fmllr_raw)
from kaldi_tpu_torch.transform.hlda import HldaStats, estimate_hlda
from kaldi_tpu_torch.transform.lvtln import LinearVtln
from kaldi_tpu_torch.transform.regtree import (MllrStats, RegressionTree,
                                               RegtreeStats)
from kaldi_tpu_torch import kws
from kaldi_tpu_torch.decoder import biglm
from kaldi_tpu_torch.lat import align, mbr
from kaldi_tpu_torch.lm import const_arpa, synth
from kaldi_tpu_torch.ops import pitch, resample, signal
from kaldi_tpu_torch.steps import score

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
                "init_am_from_leaf_stats": init_am_from_leaf_stats,
                "Nnet3": Nnet3.__init__,
                "Nnet1": Nnet1.__init__,
                "Nnet1.from_proto": Nnet1.from_proto,
                "load_nnet1": load_nnet1,
                "LstmProjected": LstmProjected.__init__,
                "Rbm": Rbm.__init__,
                "train_full_ubm": train_full_ubm,
                "full_ubm_from_posteriors": full_ubm_from_posteriors,
                "train_sre_system": train_sre_system,
                "sre_system_from_jax": sre_system_from_jax,
                "LogisticRegression.train": LogisticRegression.train,
                "SreSystem": SreSystem.__init__,
                "FullGmm.device_pack": FullGmm.device_pack,
                "FullGmm.loglikes_batch": FullGmm.loglikes_batch,
                "FullGmm.posteriors_batch": FullGmm.posteriors_batch,
                "FullGmm.loglike_batch": FullGmm.loglike_batch,
                "AccumFullGmm.accumulate_batch": AccumFullGmm.accumulate_batch,
                "AccumFullGmm.accumulate_posteriors_batch":
                    AccumFullGmm.accumulate_posteriors_batch,
                "floor_eigenvalues": floor_eigenvalues,
                "IvectorExtractor.on_device": IvectorExtractor.on_device,
                "IvectorExtractor.batch_stats": IvectorExtractor.batch_stats,
                "IvectorExtractor.extract_batch":
                    IvectorExtractor.extract_batch,
                "IvectorStats": IvectorStats.__init__,
                "train_ivector_extractor": train_ivector_extractor,
                "train_diag_ubm": train_diag_ubm,
                "mle_full_gmm_update": mle_full_gmm_update,
                "AmSgmm2": AmSgmm2.__init__,
                "FmllrRawAccs": FmllrRawAccs.__init__,
                "BasisFmllrAccus": BasisFmllrAccus.__init__,
                "RegressionTree": RegressionTree.__init__,
                "MllrStats": MllrStats.__init__,
                "LinearVtln": LinearVtln.__init__,
                "HldaStats": HldaStats.__init__,
                "sgmm2_from_jax": sgmm2_from_jax,
                "regression_tree_from_jax": regression_tree_from_jax,
                "linear_vtln_from_jax": linear_vtln_from_jax,
                "fmllr_raw_accs_from_jax": fmllr_raw_accs_from_jax}
# the adaptation and SGMM2 steps run where their model, statistics or basis
# are (PR 13)
ADAPT_STEPS = [train_sgmm2_system, train_sgmm2_bmmi, train_sgmm2,
               update_sgmm2, estimate_speaker_vector, update_sgmm2_ebw,
               estimate_sgmm2_fmllr, compute_gpost, estimate_fmllr_raw,
               compute_basis_fmllr_transform, estimate_hlda]
LADDER_STEPS = [build_triphone_tree, train_deltas, train_lda_mllt, train_sat,
                decode_fmllr, align_with_gmm, train_tdnn]
DISCRIMINATIVE_STEPS = [make_denlats, train_discriminative, train_fmmi,
                        train_nnet_discriminative, update_ebw_am_diag_gmm]
NNET_STEPS = [train_nnet3, train_tdnn3, train_lstm3, train_frmshuff,
              train_lstm_streams]
PROTO = "<AffineTransform> <InputDim> 4 <OutputDim> 2\n<Softmax> " \
    "<InputDim> 2 <OutputDim> 2\n"


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


def _nnet1_file() -> str:
    """A saved nnet1 file (written from the CPU)."""
    import os
    import tempfile
    from kaldi_tpu_torch.nnet1.nnet import save_nnet1
    net = Nnet1.from_proto(PROTO, device="cpu")
    path = os.path.join(tempfile.mkdtemp(), "n.npz")
    save_nnet1(path, net, net.init())
    return path


def _full_gmm():
    return FullGmm(np.ones(2) / 2, np.zeros((2, 3)), np.stack([np.eye(3)] * 2))


def _full_acc():
    acc = AccumFullGmm(2, 3)
    acc.accumulate_from_posteriors(np.random.RandomState(0).randn(40, 3),
                                   np.full((40, 2), 0.5))
    return acc


def _jax_like_sre_system():
    """An object shaped as a kaldi_tpu SreSystem (numpy fields)."""
    import types
    g = _full_gmm()
    return types.SimpleNamespace(
        ubm=g, extractor=IvectorExtractor(g, 2), plda=types.SimpleNamespace(
            mean=np.zeros(2), transform=np.eye(2), psi=np.ones(2)),
        opts=SrePipelineOpts(), post_fn=None)


def _lang():
    return prepare_lang(Lexicon.parse("A P1"), ["SIL"], "SIL")


def _cpu_am():
    rng = np.random.RandomState(0)
    return AmDiagGmm([DiagGmm(np.ones(2) / 2, rng.randn(2, 3),
                              np.ones((2, 3))) for _ in range(2)], "cpu")


def _jax_like_sgmm():
    """An object shaped as a kaldi_tpu AmSgmm2 (numpy fields, lists)."""
    import types
    rng = np.random.RandomState(0)
    return types.SimpleNamespace(
        Sigma_inv=np.stack([np.eye(3)] * 2), M=rng.randn(2, 3, 2),
        w=np.zeros((2, 2)), N=None, v=[[np.eye(2)[0]], [np.eye(2)[0]]],
        c=[np.ones(1), np.ones(1)])


def _jax_like_raw_accs():
    import types
    return types.SimpleNamespace(d=3, L=1, R=1, windows=[np.zeros(9)],
                                 means=[np.zeros((1, 4))],
                                 inv_vars=[np.ones((1, 4))],
                                 gammas=[np.ones(1)])


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
                 [None], 4),
             "Nnet3": lambda: Nnet3(make_lstm_config(4, 2, 4, 2)),
             "Nnet1": lambda: Nnet1([]),
             "Nnet1.from_proto": lambda: Nnet1.from_proto(PROTO),
             "load_nnet1": lambda: load_nnet1(_nnet1_file()),
             "LstmProjected": lambda: LstmProjected(LstmConfig(4, 4, 2), 2),
             "Rbm": lambda: Rbm(RbmConfig(4, 3)),
             "train_full_ubm": lambda: train_full_ubm(
                 DiagGmm.from_stats(np.zeros(3), np.ones(3)),
                 np.zeros((4, 3))),
             "full_ubm_from_posteriors": lambda: full_ubm_from_posteriors(
                 [np.zeros((4, 3))], [np.ones((4, 1))], 1),
             "train_sre_system": lambda: train_sre_system(
                 {"s": [np.random.RandomState(0).randn(9, 3)]},
                 SrePipelineOpts(num_gauss=1, ivector_dim=2, use_vad=False)),
             "sre_system_from_jax": lambda: sre_system_from_jax(
                 _jax_like_sre_system()),
             "LogisticRegression.train": lambda: LogisticRegression().train(
                 np.zeros((2, 3)), np.array([0, 1])),
             "SreSystem": lambda: SreSystem(
                 _full_gmm(), IvectorExtractor(_full_gmm(), 2), None,
                 SrePipelineOpts()),
             "FullGmm.device_pack": lambda: _full_gmm().device_pack(),
             "FullGmm.loglikes_batch": lambda: _full_gmm().loglikes_batch(
                 np.zeros((4, 3))),
             "FullGmm.posteriors_batch": lambda: _full_gmm().posteriors_batch(
                 np.zeros((4, 3))),
             "FullGmm.loglike_batch": lambda: _full_gmm().loglike_batch(
                 np.zeros((4, 3))),
             "AccumFullGmm.accumulate_batch": lambda: AccumFullGmm(
                 2, 3).accumulate_batch(_full_gmm(), np.zeros((4, 3))),
             "AccumFullGmm.accumulate_posteriors_batch": lambda: AccumFullGmm(
                 2, 3).accumulate_posteriors_batch([np.zeros((4, 3))],
                                                   [np.ones((4, 2))]),
             "floor_eigenvalues": lambda: floor_eigenvalues(
                 np.stack([np.eye(3)]), 1e-3),
             "IvectorExtractor.on_device": lambda: IvectorExtractor(
                 _full_gmm(), 2).on_device(),
             "IvectorExtractor.batch_stats": lambda: IvectorExtractor(
                 _full_gmm(), 2).batch_stats([np.zeros((4, 3))]),
             "IvectorExtractor.extract_batch": lambda: IvectorExtractor(
                 _full_gmm(), 2).extract_batch([(np.ones(2),
                                                 np.zeros((2, 3)))]),
             "IvectorStats": lambda: IvectorStats(IvectorExtractor(
                 _full_gmm(), 2)),
             "train_ivector_extractor": lambda: train_ivector_extractor(
                 _full_gmm(), [np.zeros((4, 3))], 2, num_iters=1),
             "train_diag_ubm": lambda: train_diag_ubm(
                 np.random.RandomState(0).randn(9, 3), DiagUbmTrainOpts(
                     num_gauss=2, num_iters=1)),
             "mle_full_gmm_update": lambda: mle_full_gmm_update(
                 _full_gmm(), _full_acc()),
             "AmSgmm2": lambda: AmSgmm2(_full_gmm(), 2, 2),
             "FmllrRawAccs": lambda: FmllrRawAccs(3, 1, 1),
             "BasisFmllrAccus": lambda: BasisFmllrAccus(3),
             "RegressionTree": lambda: RegressionTree(_cpu_am(), 2),
             "MllrStats": lambda: MllrStats(3),
             "LinearVtln": lambda: LinearVtln(3, [1.0]),
             "HldaStats": lambda: HldaStats(3),
             "sgmm2_from_jax": lambda: sgmm2_from_jax(_jax_like_sgmm()),
             "regression_tree_from_jax": lambda: regression_tree_from_jax(
                 RegressionTree(_cpu_am(), 2, device="cpu")),
             "linear_vtln_from_jax": lambda: linear_vtln_from_jax(
                 LinearVtln(3, [1.0], "cpu")),
             "fmllr_raw_accs_from_jax": lambda: fmllr_raw_accs_from_jax(
                 _jax_like_raw_accs())}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


@pytest.mark.parametrize("fn", ADAPT_STEPS, ids=lambda f: f.__name__)
def test_adaptation_steps_take_no_device(fn):
    assert "device" not in inspect.signature(fn).parameters


def test_adaptation_objects_run_where_their_tensors_are():
    """A CPU SGMM2, its statistics, updates, speaker vector, gpost and
    fMLLR stay on the CPU; a CPU regression tree's loglikes, a CPU LVTLN's
    classes, CPU HLDA, basis and raw-fMLLR work too."""
    from kaldi_tpu_torch.sgmm import Sgmm2Accs
    from kaldi_tpu_torch.sgmm.fmllr import FmllrSgmm2Accs
    from kaldi_tpu_torch.transform.basis_fmllr import estimate_fmllr_basis
    from kaldi_tpu_torch.transform.fmllr import FmllrStats
    from kaldi_tpu_torch.transform.regtree import regtree_fmllr_loglikes
    m = AmSgmm2(_full_gmm(), 2, 2, spk_dim=1, device="cpu")
    x = np.random.RandomState(1).randn(12, 3)
    post = [[(t % 2, 1.0)] for t in range(12)]
    acc = Sgmm2Accs(m)
    acc.accumulate(m, x, post, 2)
    assert acc.gamma.device.type == "cpu"
    update_sgmm2(m, acc, "vMwSc")
    assert m.V.device.type == m.M.device.type == "cpu"
    assert estimate_speaker_vector(m, x, post, 2).v.device.type == "cpu"
    assert compute_gpost(m, x, post, 2)[0][0][2].dtype == np.float32
    fa = FmllrSgmm2Accs(m)
    fa.accumulate(m, x, post, 2)
    assert estimate_sgmm2_fmllr(fa, m, min_count=1.0)[0].device.type == "cpu"
    am = _cpu_am()
    tree = RegressionTree(am, 2, device="cpu")
    ll = regtree_fmllr_loglikes(am, tree, {}, x)
    assert ll.device.type == "cpu" and ll.shape == (12, 2)
    st = FmllrStats(3)
    st.accumulate(x, am.pdfs[0].means, am.pdfs[0].vars, np.full((12, 2), .5))
    acc_b = BasisFmllrAccus(3, "cpu")
    acc_b.accumulate_from_speaker(st)
    basis = estimate_fmllr_basis(acc_b, 2)
    assert compute_basis_fmllr_transform(st, basis)[0].device.type == "cpu"
    hs = HldaStats(3, "cpu")
    hs.accumulate(x, np.arange(12) % 2, 2)
    assert estimate_hlda(hs, 2)[0].shape == (2, 3)
    assert LinearVtln(3, [1.0], "cpu").select_class(st)[0] == 0


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


@pytest.mark.parametrize("fn", NNET_STEPS, ids=lambda f: f.__name__)
def test_nnet_trainers_take_no_device(fn):
    assert "device" not in inspect.signature(fn).parameters


def test_nnet_trainers_run_where_their_model_is():
    """A CPU monophone gives CPU nnet3 TDNN and LSTM hybrids; CPU params
    train on the CPU in every trainer."""
    rng = np.random.RandomState(0)
    utts = [(f"u{i}", rng.randn(30, 4).astype(np.float32), ["A"])
            for i in range(3)]
    mono = flat_start(_lang(), [f for _u, f, _w in utts], "cpu")
    one = Nnet3TrainOpts(num_epochs=1)
    tdnn = train_tdnn3(mono, utts, hidden_dim=8, pnorm_output_dim=2,
                       train_opts=one)
    lstm = train_lstm3(mono, utts, cell_dim=4, proj_dim=2, train_opts=one)
    for res in (tdnn, lstm):
        assert res.am.device.type == "cpu"
        assert all(v.device.type == "cpu"
                   for v in res.am.model.state_dict().values())
    net = Nnet1.from_proto(PROTO, device="cpu")
    p, _h = train_frmshuff(net, net.init(), rng.randn(9, 4).astype(
        np.float32), rng.randint(0, 2, 9), minibatch=4)
    assert all(v.device.type == "cpu" for v in p.values())
    model = LstmProjected(LstmConfig(4, 4, 2), 2, device="cpu")
    p, _h = train_lstm_streams(model, model.init(), [
        (rng.randn(7, 4).astype(np.float32), rng.randint(0, 2, 7))],
        StreamTrainOpts(num_streams=2, bptt_chunk=3))
    assert all(v.device.type == "cpu" for v in p.values())
    net3 = Nnet3(make_lstm_config(4, 2, 4, 2, splice=(0,)), device="cpu")
    p, _h = train_nnet3(net3, net3.init(), {
        "feats": rng.randn(3, 5, 4).astype(np.float32),
        "targets": np.zeros((3, 5), np.int32),
        "weights": np.ones((3, 5), np.float32)}, one)
    assert all(v.device.type == "cpu" for v in p.values())


# the rescoring and feature modules: name -> call with `device`
def _plain_lm():
    import chip_smoke as cs
    return cs.shape_lm("plain")


def _toy_lattice():
    from kaldi_tpu_torch.lat.lattice import Lattice
    lat = Lattice()
    s0, s1 = lat.add_state(), lat.add_state()
    lat.start = s0
    lat.add_arc(s0, 1, 1, 0.5, 0.25, s1)
    lat.set_final(s1)
    return lat


def _wave():
    return np.random.RandomState(0).randn(4000).astype(np.float32) * 100


RESCORE_ENTRY_POINTS = {
    "ConstArpaLm.device_tables": lambda **kw: _plain_lm().device_tables(
        **kw),
    "ConstArpaLm.step_batch": lambda **kw: _plain_lm().step_batch(
        [0, 1], [1, 2], **kw),
    "ConstArpaLm.final_cost_batch": lambda **kw:
        _plain_lm().final_cost_batch([0, 1], **kw),
    "lattice_lmrescore_const_arpa_batch": lambda **kw:
        const_arpa.lattice_lmrescore_const_arpa_batch(
            _toy_lattice(), _plain_lm(), 0.5, **kw),
    "lattice_lmrescore_const_arpa_many": lambda **kw:
        const_arpa.lattice_lmrescore_const_arpa_many(
            [_toy_lattice()], _plain_lm(), 0.5, **kw),
    "convolve_signals": lambda **kw: signal.convolve_signals(
        _wave(), np.ones(3, np.float32), **kw),
    "reverberate": lambda **kw: signal.reverberate(
        _wave(), np.ones(3, np.float32), snr_db=10.0,
        rng=np.random.RandomState(0), **kw),
    "LinearResample.resample": lambda **kw: resample.LinearResample(
        16000, 8000).resample(_wave(), **kw),
    "ArbitraryResample.resample": lambda **kw: resample.ArbitraryResample(
        4000, 16000.0, 4000.0, np.array([0.01, 0.1])).resample(_wave(),
                                                                **kw),
    "resample_waveform": lambda **kw: resample.resample_waveform(
        _wave(), 16000, 8000, **kw),
    "compute_kaldi_pitch": lambda **kw: pitch.compute_kaldi_pitch(
        _wave(), **kw)}
RESCORE_FUNCTIONS = {
    "ConstArpaLm.device_tables": const_arpa.ConstArpaLm.device_tables,
    "ConstArpaLm.step_batch": const_arpa.ConstArpaLm.step_batch,
    "ConstArpaLm.final_cost_batch": const_arpa.ConstArpaLm.final_cost_batch,
    "lattice_lmrescore_const_arpa_batch":
        const_arpa.lattice_lmrescore_const_arpa_batch,
    "lattice_lmrescore_const_arpa_many":
        const_arpa.lattice_lmrescore_const_arpa_many,
    "convolve_signals": signal.convolve_signals,
    "reverberate": signal.reverberate,
    "LinearResample.resample": resample.LinearResample.resample,
    "ArbitraryResample.resample": resample.ArbitraryResample.resample,
    "resample_waveform": resample.resample_waveform,
    "compute_kaldi_pitch": pitch.compute_kaldi_pitch}
# host code: it takes no device (decode_biglm runs where its decoder runs)
HOST_FUNCTIONS = [biglm.decode_biglm, biglm.decode_biglm_exact,
                  const_arpa.lattice_lmrescore_const_arpa,
                  align.word_align_lattice, align.lattice_oracle,
                  mbr.mbr_decode, score.score_lattices, kws.search_index,
                  kws.lattice_to_kws_index, pitch.process_pitch,
                  synth.synth_trigram_arpa]


@pytest.mark.parametrize("name", sorted(RESCORE_FUNCTIONS))
def test_rescoring_entry_point_defaults_to_cuda(name):
    default = inspect.signature(RESCORE_FUNCTIONS[name]).parameters[
        "device"].default
    assert default == "cuda"


@pytest.mark.parametrize("name", sorted(RESCORE_ENTRY_POINTS))
def test_rescoring_default_raises_without_a_card_and_cpu_runs(name):
    call = RESCORE_ENTRY_POINTS[name]
    assert call(device="cpu") is not None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("fn", HOST_FUNCTIONS, ids=lambda f: f.__name__)
def test_rescoring_host_functions_take_no_device(fn):
    assert "device" not in inspect.signature(fn).parameters


def test_decode_biglm_runs_where_its_decoder_runs():
    import chip_smoke as cs
    b = cs.biglm_vs_exact(card="cpu")
    assert b["n"] == 3 and not b["words"] and b["cost gap"] <= 1e-3


# --- the file layer and network serving ---

def _model_files(tmp_path) -> dict:
    """One small file of each kind whose load builds a device object,
    written by the port on the CPU."""
    import chip_smoke as cs
    from kaldi_tpu_torch.io import model_io
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet3.network import Nnet3
    from kaldi_tpu_torch.nnet3.training import AmNnet3
    from kaldi_tpu_torch.sgmm.estimate import Sgmm2Accs
    from kaldi_tpu_torch.params import sgmm2_from_jax
    from kaldi_tpu_torch.steps.mono import MonoModel
    from kaldi_tpu_torch.steps.sgmm_steps import SgmmAm
    lang, ctx, tm, _g = cs.gmm_stack(cs.YESNO_LEXICON, cs.YESNO_ARPA)
    tdnn = Tdnn(TdnnConfig(feat_dim=4, num_pdfs=2, hidden_dim=8,
                           nonlinearity="relu", splice_indexes=((0,),)),
                device="cpu")
    net = Nnet3(cs.nnet3_small_config("tdnn"), device="cpu")
    sgmm = sgmm2_from_jax(_jax_like_sgmm(), "cpu")
    objs = {"gmm_system": MonoModel(cs.random_am([1] * tm.num_pdfs, 3, 0,
                                                 "cpu"), tm, ctx, lang),
            "am_nnet": AmNnet(tdnn), "raw_nnet": tdnn,
            "am_nnet3": AmNnet3(net), "sgmm2": SgmmAm(sgmm, 2),
            "sgmm2_accs": Sgmm2Accs(sgmm)}
    paths = {}
    for kind, obj in objs.items():
        paths[kind] = str(tmp_path / kind)
        getattr(model_io, f"save_{kind}")(paths[kind], obj)
    return paths


LOADERS = ["gmm_system", "am_nnet", "raw_nnet", "am_nnet3", "sgmm2",
           "sgmm2_accs"]


@pytest.mark.parametrize("kind", LOADERS)
def test_device_loaders_default_to_cuda_and_raise_without_a_card(kind,
                                                                 tmp_path):
    from kaldi_tpu_torch.io import model_io
    load = getattr(model_io, f"load_{kind}")
    assert inspect.signature(load).parameters["device"].default == "cuda"
    path = _model_files(tmp_path)[kind]
    assert load(path, device="cpu") is not None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load(path)


def test_fused_session_factory_defaults_to_cuda():
    from kaldi_tpu_torch.online.server import fused_session_factory
    assert inspect.signature(fused_session_factory).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_session_factory(None, _graph(), CsrBeamOpts(), None, None)


def _serving_classes():
    from kaldi_tpu_torch.online.gmm_decoding import SingleUtteranceGmmDecoder
    from kaldi_tpu_torch.online.server import (AudioServer, DecodeSession,
                                               FusedDecodeSession)
    from kaldi_tpu_torch.online.threaded import \
        ThreadedSingleUtteranceDecoder
    return [DecodeSession, FusedDecodeSession, AudioServer,
            ThreadedSingleUtteranceDecoder, SingleUtteranceGmmDecoder]


@pytest.mark.parametrize("cls", _serving_classes(),
                         ids=lambda c: c.__name__)
def test_serving_classes_take_no_device(cls):
    """They run where the decoder or model they are given runs."""
    assert "device" not in inspect.signature(cls.__init__).parameters


# --- decoder tools, graph helpers and recipe utilities ---

def test_decode_batched_defaults_to_cuda_and_raises_without_a_card():
    from kaldi_tpu_torch.decoder.batching import decode_batched
    assert inspect.signature(decode_batched).parameters[
        "device"].default == "cuda"
    dec = CsrBeamDecoder(_graph(), CsrBeamOpts(beam=1e9, max_active=8,
                                               expand_budget=64),
                         device="cpu")
    utts = [("a", np.zeros((3, 2), np.float32))]

    def score(x):
        return torch.zeros(x.shape[0], x.shape[1], 4, device=x.device)
    assert decode_batched(dec, utts, score, batch_size=2,
                          device="cpu")["a"] is not None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_batched(dec, utts, score)


def _tool_host_functions():
    from kaldi_tpu_torch.decoder.simple import simple_decode
    from kaldi_tpu_torch.decoder.verify import (check_packed_graph,
                                                check_tier_tables)
    from kaldi_tpu_torch.hmm.hmm_utils import (convert_alignment,
                                               split_to_phones)
    from kaldi_tpu_torch.scripts.mkgraph_scale import build
    from kaldi_tpu_torch.steps.egs import dump_egs, egs_minibatches
    from kaldi_tpu_torch.tree.synth import synth_triphone_tree
    from kaldi_tpu_torch.utils.jobs import run_jobs
    from kaldi_tpu_torch.utils.optimization import est_pca, lbfgs, linear_cgd
    return [simple_decode, check_packed_graph, check_tier_tables,
            convert_alignment, split_to_phones, build, dump_egs,
            egs_minibatches, synth_triphone_tree, run_jobs, est_pca, lbfgs,
            linear_cgd]


@pytest.mark.parametrize("fn", _tool_host_functions(),
                         ids=lambda f: f.__name__)
def test_tool_host_functions_take_no_device(fn):
    """Host code, or (check_tier_tables) reads the tables where they are."""
    assert "device" not in inspect.signature(fn).parameters


def test_check_tier_tables_reads_the_tables_where_they_are():
    from kaldi_tpu_torch.decoder.verify import check_tier_tables
    dec = CsrBeamDecoder(_graph(), CsrBeamOpts(max_active=8,
                                               expand_budget=64),
                         device="cpu")
    assert dec.tabs.srow.device.type == "cpu"
    check_tier_tables(dec.graph, dec.tabs, dec.opts.hub_threshold)
