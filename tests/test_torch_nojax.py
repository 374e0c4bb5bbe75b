"""The port runs where jax is not installed.

In a fresh interpreter whose import system refuses `jax` and `jaxlib`,
every kaldi_tpu_torch module (the int8 path, AmNnet, the streaming
server, the lattice modules, the training modules and the online path
among them), chip_smoke.py's helpers and chip_probes.py import, and a
small decode, a record decode and its lattices (native and numpy), two
train steps of a tiny TDNN with clipping, momentum and NG-SGD, the
online path (MFCC
and deltas, the padded decoder, both fused engines, the nnet2 decoder
with i-vectors), the dense decoder on the yesno HCLG, the port's
`recipe-yesno` (the GMM path end to end), its `recipe-yesno-files` (the
CLI's first slice over files) and one subcommand of each other group of
that slice and of the second (FSTs, GMMs, cli_fst, cli_gmm_extra), the
third slice's lattice decode with a lattice and a posterior subcommand
and `kws-search` on its lattices, the fourth slice's egs, nnet2 init and
SGD, an nnet diagnostic, nnet3 LDA statistics and an MCE scale, the
fifth slice's extractor init, i-vectors and global MLLT statistics
(cli_adapt), its fMLLR, global fMLLR, fMPE and SGMM2 commands with a
legacy alias (cli, cli_adapt, cli_sgmm), and a small triphone run
(train_deltas from a monophone, its HCLG through the flat pipeline on the
port's native graph ops, a decode) and two bMMI and two fMMI iterations
from that triphone model run on the CPU; then two NG-SGD steps of a tiny
config-built nnet3 LSTM and one `train_frmshuff` pass of a tiny nnet1
net; then a tiny SRE v1 and v2 system trained and scored, and a
logistic regression; then a tiny SGMM2 trained from the triphone model
with one bMMI iteration, and chip_smoke's adaptation checks (raw, basis
and regression-tree fMLLR, MLLR, LVTLN, HLDA) with the CPU on both sides;
then a small const-ARPA rescoring, an MBR decode, a KWS search and a
pitch track; then the file layer (a triphone GMM system with its tree and
an AmNnet through model files, an ark by the native reader), the codecs,
a localhost `AudioServer` over the fused CSR session, the threaded
decoder and the online GMM decoder; then the multi-device modules
(`host_shard`, a one-process `init_distributed`, a frontier-sharded
decode on a one-rank mesh). (kaldi_tpu/decoder/__init__.py imports the
jax decoders, so reaching into kaldi_tpu.decoder from the port would fail
here.)
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, BlockJax())
import numpy as np
import torch
torch.set_num_threads(2)
import kaldi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kaldi_tpu_torch.__path__,
                                               "kaldi_tpu_torch.")]
for n in names:
    importlib.import_module(n)
for n in ("kaldi_tpu_torch.cuda_build", "kaldi_tpu_torch.nnet.quantized",
          "kaldi_tpu_torch.nnet.am_nnet", "kaldi_tpu_torch.nnet.combine",
          "kaldi_tpu_torch.online.serving", "kaldi_tpu_torch.lat.lattice",
          "kaldi_tpu_torch.lat.functions", "kaldi_tpu_torch.lat.io",
          "kaldi_tpu_torch.lat.native_gen", "kaldi_tpu_torch.lat.generate",
          "kaldi_tpu_torch.nnet.optim", "kaldi_tpu_torch.nnet.train",
          "kaldi_tpu_torch.nnet.natural_gradient",
          "kaldi_tpu_torch.nnet.surgery", "kaldi_tpu_torch.utils.checkpoint",
          "kaldi_tpu_torch.ops.dct", "kaldi_tpu_torch.ops.delta",
          "kaldi_tpu_torch.transform.cmvn", "kaldi_tpu_torch.online.features",
          "kaldi_tpu_torch.online.endpoint", "kaldi_tpu_torch.online.timing",
          "kaldi_tpu_torch.decoder.beam_search",
          "kaldi_tpu_torch.online.decoder", "kaldi_tpu_torch.online.fused",
          "kaldi_tpu_torch.gmm.diag_gmm", "kaldi_tpu_torch.gmm.full_gmm",
          "kaldi_tpu_torch.ivector.extractor",
          "kaldi_tpu_torch.online.ivector",
          "kaldi_tpu_torch.online.nnet2_decoding",
          "kaldi_tpu_torch.fst.fst", "kaldi_tpu_torch.fst.compose",
          "kaldi_tpu_torch.fst.determinize", "kaldi_tpu_torch.fst.minimize",
          "kaldi_tpu_torch.fst.epsilon", "kaldi_tpu_torch.fst.hmm_graph",
          "kaldi_tpu_torch.fst.lang", "kaldi_tpu_torch.fst.graph",
          "kaldi_tpu_torch.hmm.topology",
          "kaldi_tpu_torch.hmm.transition_model",
          "kaldi_tpu_torch.tree.context_dep", "kaldi_tpu_torch.lm.arpa",
          "kaldi_tpu_torch.utils.wer", "kaldi_tpu_torch.gmm.am_gmm",
          "kaldi_tpu_torch.gmm.estimation",
          "kaldi_tpu_torch.decoder.decodable",
          "kaldi_tpu_torch.decoder.viterbi", "kaldi_tpu_torch.decoder.dense",
          "kaldi_tpu_torch.steps.mono", "kaldi_tpu_torch.cli",
          "kaldi_tpu_torch.tree.event_map", "kaldi_tpu_torch.tree.clustering",
          "kaldi_tpu_torch.tree.build_tree", "kaldi_tpu_torch.fst.context",
          "kaldi_tpu_torch.fst.flat", "kaldi_tpu_torch.fst.native_ops",
          "kaldi_tpu_torch.fst.mkgraph_flat",
          "kaldi_tpu_torch.transform.lda", "kaldi_tpu_torch.transform.mllt",
          "kaldi_tpu_torch.transform.fmllr", "kaldi_tpu_torch.transform.fmpe",
          "kaldi_tpu_torch.steps.deltas", "kaldi_tpu_torch.steps.lda_mllt",
          "kaldi_tpu_torch.steps.sat", "kaldi_tpu_torch.steps.tdnn",
          "kaldi_tpu_torch.params", "kaldi_tpu_torch.hmm.posterior",
          "kaldi_tpu_torch.lat.posteriors", "kaldi_tpu_torch.gmm.ebw",
          "kaldi_tpu_torch.steps.mmi", "kaldi_tpu_torch.steps.ubm",
          "kaldi_tpu_torch.steps.fmmi",
          "kaldi_tpu_torch.nnet.discriminative",
          "kaldi_tpu_torch.nnet.components_extra",
          "kaldi_tpu_torch.nnet3.descriptors", "kaldi_tpu_torch.nnet3.components",
          "kaldi_tpu_torch.nnet3.network", "kaldi_tpu_torch.nnet3.configs",
          "kaldi_tpu_torch.nnet3.training", "kaldi_tpu_torch.steps.nnet3_train",
          "kaldi_tpu_torch.nnet1.nnet", "kaldi_tpu_torch.nnet1.train",
          "kaldi_tpu_torch.nnet1.lstm", "kaldi_tpu_torch.nnet1.rbm",
          "kaldi_tpu_torch.nnet1.conv", "kaldi_tpu_torch.nnet1.kl_hmm",
          "kaldi_tpu_torch.ivector.vad", "kaldi_tpu_torch.ivector.metrics",
          "kaldi_tpu_torch.ivector.plda",
          "kaldi_tpu_torch.ivector.logistic_regression",
          "kaldi_tpu_torch.steps.sre", "kaldi_tpu_torch.steps.ubm",
          "kaldi_tpu_torch.gmm.full_gmm", "kaldi_tpu_torch.ivector.extractor",
          "kaldi_tpu_torch.transform.fmllr_raw",
          "kaldi_tpu_torch.transform.basis_fmllr",
          "kaldi_tpu_torch.transform.regtree", "kaldi_tpu_torch.transform.lvtln",
          "kaldi_tpu_torch.transform.hlda", "kaldi_tpu_torch.sgmm",
          "kaldi_tpu_torch.sgmm.model", "kaldi_tpu_torch.sgmm.estimate",
          "kaldi_tpu_torch.sgmm.gpost", "kaldi_tpu_torch.sgmm.fmllr",
          "kaldi_tpu_torch.sgmm.prexform", "kaldi_tpu_torch.sgmm.ebw",
          "kaldi_tpu_torch.steps.sgmm_steps", "kaldi_tpu_torch.lm.synth",
          "kaldi_tpu_torch.lm.const_arpa", "kaldi_tpu_torch.lat.align",
          "kaldi_tpu_torch.lat.mbr", "kaldi_tpu_torch.steps.score",
          "kaldi_tpu_torch.decoder.biglm", "kaldi_tpu_torch.kws",
          "kaldi_tpu_torch.kws.index", "kaldi_tpu_torch.kws.scoring",
          "kaldi_tpu_torch.kws.proxy", "kaldi_tpu_torch.ops.signal",
          "kaldi_tpu_torch.ops.resample", "kaldi_tpu_torch.ops.pitch",
          "kaldi_tpu_torch.ops.sinusoid", "kaldi_tpu_torch.io",
          "kaldi_tpu_torch.io.wave", "kaldi_tpu_torch.io.htk",
          "kaldi_tpu_torch.io.kaldi_io", "kaldi_tpu_torch.io.compressed",
          "kaldi_tpu_torch.io.native", "kaldi_tpu_torch.io.model_io",
          "kaldi_tpu_torch.online.server", "kaldi_tpu_torch.online.threaded",
          "kaldi_tpu_torch.online.compress",
          "kaldi_tpu_torch.online.gmm_decoding",
          "kaldi_tpu_torch.cli_online_extra", "kaldi_tpu_torch.cli_misc",
          "kaldi_tpu_torch.cli_nnet", "kaldi_tpu_torch.cli_fst",
          "kaldi_tpu_torch.cli_gmm_extra", "kaldi_tpu_torch.cli_tail",
          "kaldi_tpu_torch.cli_adapt", "kaldi_tpu_torch.cli_sgmm",
          "kaldi_tpu_torch.fst.text_io", "kaldi_tpu_torch.fst.special",
          "kaldi_tpu_torch.fst.factor", "kaldi_tpu_torch.hmm.hmm_utils",
          "kaldi_tpu_torch.tree.synth", "kaldi_tpu_torch.decoder.simple",
          "kaldi_tpu_torch.decoder.batching", "kaldi_tpu_torch.decoder.verify",
          "kaldi_tpu_torch.steps.egs", "kaldi_tpu_torch.utils.optimization",
          "kaldi_tpu_torch.utils.gpsr", "kaldi_tpu_torch.utils.data_dir",
          "kaldi_tpu_torch.utils.jobs", "kaldi_tpu_torch.utils.experiment",
          "kaldi_tpu_torch.utils.profiling",
          "kaldi_tpu_torch.scripts.mkgraph_scale",
          "kaldi_tpu_torch.parallel", "kaldi_tpu_torch.parallel.mesh",
          "kaldi_tpu_torch.parallel.launch",
          "kaldi_tpu_torch.parallel.frontier_decode"):
    assert n in names, n
import chip_smoke
import chip_probes  # noqa: F401
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
g = chip_smoke.star_hub_graph(40)
dec = CsrBeamDecoder(g, CsrBeamOpts(beam=1e9, max_active=32,
                                    expand_budget=256, hub_threshold=8),
                     device="cpu")
ll = np.random.RandomState(0).randn(2, 10, 41).astype(np.float32)
res = dec.decode(ll, np.array([10, 6], np.int32))
assert all(r is not None and r[1] for r in res), res
from kaldi_tpu_torch.lat.functions import lattice_best_path
from kaldi_tpu_torch.lat.generate import raw_lattice_from_decode
ldec = CsrBeamDecoder(g, CsrBeamOpts(beam=1e9, max_active=32,
                                     expand_budget=256, hub_threshold=8,
                                     rec_cap=16, rec_f16=True),
                      device="cpu")
nf = np.array([10, 6], np.int32)
raw = ldec.decode_raw(ll, nf)
for b in range(2):
    lats = [raw_lattice_from_decode(ldec, raw, nf, b, 6.0, use_native=n)
            for n in (True, False)]
    assert lattice_best_path(lats[0])[:2] == lattice_best_path(lats[1])[:2]
assert chip_smoke.wer([[1, 2, 3]], [[1, 3]]) == 100.0 / 3
from kaldi_tpu_torch.nnet import train
from kaldi_tpu_torch.nnet.natural_gradient import ng_sgd
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
model = Tdnn(TdnnConfig(feat_dim=4, num_pdfs=3, hidden_dim=8,
                        nonlinearity="relu", splice_indexes=((-1, 0, 1), (0,))))
g = torch.Generator().manual_seed(0)
batch = (torch.randn(2, 7, 4, generator=g), torch.tensor([[0, 1, 2, 0, 1]] * 2),
         torch.ones(2, 5))
for opt in (train.make_optimizer(train.NnetTrainOpts(momentum=0.9), 2),
            ng_sgd(0.01, update_period=2)):
    params = model.init(g)
    state = opt.init(params)
    step = train.make_train_step(model, opt, compute_dtype=torch.bfloat16)
    for _ in range(2):
        params, state, loss, acc = step(params, state, *batch)
    assert bool(torch.isfinite(loss)), loss
from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.online.features import OnlineFeaturePipeline, OnlineMfcc
from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
from kaldi_tpu_torch.online.ivector import OnlineIvectorFeature
from kaldi_tpu_torch.online.nnet2_decoding import (
    OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
from kaldi_tpu_torch.ops.features import FbankOpts, MfccOpts, fbank
from kaldi_tpu_torch.ops.mel import MelOpts
from kaldi_tpu_torch.ops.window import FrameOpts
wave = np.random.RandomState(1).randn(6000).astype(np.float32) * 1000
fo = FrameOpts(dither=0.0)
pipe = OnlineFeaturePipeline(MfccOpts(frame_opts=fo), device="cpu")
pipe.accept_waveform(wave)
pipe.input_finished()
assert pipe.get_features().shape == (36, 39), pipe.get_features().shape
fb = FbankOpts(frame_opts=fo, mel_opts=MelOpts(num_bins=41))
hub = chip_smoke.star_hub_graph(40)
cfg = TdnnConfig(feat_dim=41, num_pdfs=41, hidden_dim=8, nonlinearity="relu",
                 splice_indexes=((-1, 0, 1), (0,)))
am = AmNnet(Tdnn(cfg))
am.model.init(torch.Generator().manual_seed(1))
for d in (BeamSearchDecoder(hub, BeamSearchOpts(beam=1e9, max_active=32),
                            device="cpu"),
          CsrBeamDecoder(hub, CsrBeamOpts(beam=1e9, max_active=32,
                                          expand_budget=256, hub_threshold=8),
                         device="cpu")):
    f = FusedOnlineDecoder(am, d, fb, chunk_samples=1600, t_max=64)
    f.accept_waveform(wave)
    f.input_finished()
    assert f.best_path() is not None
mf = OnlineMfcc(fb, computer=fbank, device="cpu")
feats = fbank(torch.from_numpy(wave), fb).numpy()
ubm = DiagGmm(np.ones(2) / 2, feats[:2].astype(np.float64), np.ones((2, 41)))
ext = IvectorExtractor(ubm, 3)
cfg2 = TdnnConfig(feat_dim=44, num_pdfs=41, hidden_dim=8, nonlinearity="relu",
                  splice_indexes=((-1, 0, 1), (0,)))
am2 = AmNnet(Tdnn(cfg2))
am2.model.init(torch.Generator().manual_seed(2))
class Tm:
    transition_id_to_phone = staticmethod(lambda tid: 1)
dec = SingleUtteranceNnet2Decoder(
    am2, Tm, BeamSearchDecoder(hub, BeamSearchOpts(beam=1e9, max_active=32),
                                 device="cpu"),
    OnlineNnet2FeaturePipeline(mf, OnlineIvectorFeature(ext)))
dec.pipeline.accept_waveform(wave)
dec.finalize_decoding()
assert dec.best_path() is not None
from kaldi_tpu_torch import cli
from kaldi_tpu_torch.decoder.dense import DenseDecoderOpts, make_decoder
_lang, _ctx, tm, yes = chip_smoke.gmm_stack(chip_smoke.YESNO_LEXICON,
                                            chip_smoke.YESNO_ARPA)
llg = np.random.RandomState(2).randn(2, 30, tm.num_pdfs).astype(np.float32)
d = make_decoder(yes, device="cpu")
assert d.opts == DenseDecoderOpts(eps_expansions=1), d.opts
assert all(r is not None for r in d.decode(llg, np.array([30, 20])))
assert cli.main(["recipe-yesno", "--device", "cpu"]) == 0
import contextlib, io, tempfile
with tempfile.TemporaryDirectory() as w, \
        contextlib.redirect_stdout(io.StringIO()):
    # features, training, graph and decoding through files (CLI slice 1)
    assert cli.main(["recipe-yesno-files", w, "--device", "cpu"]) == 0
    for argv in (
            ["copy-feats", f"ark:{w}/test/feats.ark", f"ark:{w}/c.ark",
             "--compress"],                                   # tables
            ["matrix-sum", f"ark:{w}/s.ark", f"ark:{w}/test/mfcc.ark",
             f"ark:{w}/test/mfcc.ark"],                       # matrices
            ["compute-cmvn-stats", f"ark:{w}/test/mfcc.ark",
             f"ark:{w}/cmvn.ark"],                            # CMVN
            ["dot-weights", f"ark:{w}/s.ark", f"ark:{w}/s.ark",
             f"ark:{w}/d.ark"],                               # cli_misc
            ["nnet-am-compute", f"{w}/tdnn.npz", f"ark:{w}/test/feats.ark",
             f"ark:{w}/ll.ark", "--device", "cpu"],           # cli_nnet
            ["split-scp", f"{w}/test/wav.scp", "2", f"{w}/JOB.scp"],
            ["info"],                                         # data, probes
            ["fstrand", f"{w}/r.fst", "--seed", "3"],         # cli_fst
            ["fst-determinize-star", f"{w}/r.fst", f"{w}/d.fst"],  # FSTs
            ["gmm-acc-stats-ali", f"{w}/mono.npz",
             f"ark:{w}/train/feats.ark", f"ark:{w}/ali.ark",
             f"{w}/acc.npz", "--device", "cpu"],              # GMMs
            ["gmm-est", f"{w}/mono.npz", f"{w}/acc.npz",
             f"{w}/mono1.npz"],
            ["init-ubm", f"{w}/mono.npz", f"{w}/acc.npz",
             f"{w}/ubm.npz", "--ubm-num-gauss", "4"],         # gmm_extra
            ["gmm-latgen-faster", f"{w}/mono.npz", f"{w}/hclg.npz",
             f"ark:{w}/test/feats.ark", "--lattice-out", f"{w}/lat.ark",
             "--max-active", "64", "--device", "cpu"],        # CLI slice 3
            ["lattice-best-path", f"{w}/lat.ark",
             "--acoustic-scale", "0.1"],                      # lattices
            ["lattice-to-post", f"{w}/lat.ark", f"{w}/post.txt"],
            ["post-to-weights", f"{w}/post.txt",
             f"ark:{w}/pw.ark"]):                             # posteriors
        assert cli.main(argv) == 0, argv
    with open(f"{w}/kw.txt", "w") as f:
        f.write("KW1 1\nKW2 2 1\n")
    assert cli.main(["kws-search", f"{w}/lat.ark", f"{w}/kw.txt"]) == 0
    # the fourth slice: nnet2 egs, init and SGD (cli), cli_nnet, nnet3,
    # nnet1 (cli_tail) and cli_misc
    tf = f"ark:{w}/train/feats.ark"
    for argv in (
            ["gmm-align", f"{w}/mono.npz", f"{w}/train/text", tf,
             f"ark:{w}/nali.ark", "--device", "cpu"],
            ["nnet-get-egs", f"{w}/mono.npz", tf, f"ark:{w}/nali.ark",
             f"{w}/egs", "--left-context", "1", "--right-context", "1"],
            ["nnet-am-init", f"{w}/mono.npz", tf, f"{w}/nn.npz",
             "--splice-indexes=-1,0,1", "--hidden-dim", "16",
             "--pnorm-output-dim", "4"],
            ["nnet-train-simple", f"{w}/nn.npz", f"{w}/egs", f"{w}/nn1.npz",
             "--num-epochs", "1", "--device", "cpu"],
            ["nnet-am-info", f"{w}/nn1.npz"],
            ["nnet-compute-prob", f"{w}/nn1.npz", f"{w}/egs", "--device",
             "cpu"],                                          # cli_nnet
            ["nnet3-acc-lda-stats", f"{w}/egs", f"{w}/lda.npz"],  # cli_tail
            ["compute-mce-scale", f"ark:{w}/s.ark", f"ark:{w}/s.ark",
             f"ark:{w}/mce.ark"]):                            # cli_misc
        assert cli.main(argv) == 0, argv
    # the fifth slice (5a): the extractor and i-vectors (cli), the
    # global MLLT statistics (cli_adapt)
    for argv in (
            ["ivector-extractor-init", f"{w}/ubm.npz", f"{w}/ext.npz",
             "--ivector-dim", "4"],
            ["ivector-extract", f"{w}/ext.npz", tf, f"ark:{w}/iv.ark",
             "--num-gselect", "2", "--device", "cpu"],
            ["gmm-acc-mllt-global", f"{w}/ubm.npz", tf, f"{w}/macc.npz"]):
        assert cli.main(argv) == 0, argv
    # the fifth slice (5b): fMLLR from posteriors (cli), global fMLLR
    # (cli_adapt), fMPE, an SGMM2's init, statistics and update, and a
    # legacy alias (cli_sgmm)
    cpu = ["--device", "cpu"]
    for argv in (
            ["ali-to-post", f"ark:{w}/nali.ark", f"{w}/apost.txt"],
            ["gmm-est-fmllr", f"{w}/mono.npz", tf, f"{w}/apost.txt",
             f"ark:{w}/fm.ark", *cpu],
            ["gmm-est-fmllr-global", f"{w}/ubm.npz", tf, f"ark:{w}/fg.ark"],
            ["init-ubm", f"{w}/mono.npz", f"{w}/acc.npz", f"{w}/dubm.npz",
             "--ubm-num-gauss", "4", "--fullcov-ubm", "false"],
            ["fmpe-init", f"{w}/dubm.npz", f"{w}/fmpe.npz"],
            ["fmpe-apply-transform", f"{w}/fmpe.npz", tf,
             f"ark:{w}/fmpe.ark"],
            ["sgmm2-init", f"{w}/mono.npz", f"{w}/ubm.npz", f"{w}/sgmm.npz",
             "--phn-dim", "4", "--num-gselect", "2", *cpu],
            ["sgmm2-acc-stats", f"{w}/sgmm.npz", f"{w}/mono.npz", tf,
             f"{w}/apost.txt", f"{w}/sacc.npz", *cpu],
            ["sgmm2-est", f"{w}/sgmm.npz", f"{w}/sacc.npz",
             f"{w}/sgmm1.npz", *cpu],
            ["sgmm-info", f"{w}/sgmm1.npz"]):
        assert cli.main(argv) == 0, argv
from kaldi_tpu_torch.decoder.graph_pack import pack_graphs
from kaldi_tpu_torch.fst.graph import TrainingGraphCompiler
from kaldi_tpu_torch.fst.mkgraph_flat import make_hclg_flat, pack_graph_flat
from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
from kaldi_tpu_torch.steps.deltas import DeltasTrainOpts, train_deltas
from kaldi_tpu_torch.steps.mono import MonoTrainOpts, train_mono
lang = chip_smoke.gmm_stack(chip_smoke.TRI_LEXICON, chip_smoke.TRI_ARPA)[0]
rng = np.random.RandomState(11)
utts = chip_smoke.tri_corpus(rng, 8, lambda w: chip_smoke.mfcc_deltas(w, "cpu"))
mono = train_mono(lang, utts, MonoTrainOpts(num_iters=4, totgauss=20,
                                            max_iter_inc=3), device="cpu")
tri = train_deltas(lang, utts, mono, DeltasTrainOpts(
    num_iters=3, totgauss=40, max_iter_inc=2, num_leaves=12, tree_thresh=5.0))
assert tri.ctx_dep.context_width == 3
flat, _st = make_hclg_flat(lang, arpa_to_g(ArpaLm.parse(chip_smoke.TRI_ARPA),
                                           lang.words),
                           tri.trans_model, tri.ctx_dep)
g = pack_graph_flat(flat, tri.trans_model.id2pdf_array)
res = BeamSearchDecoder(g, BeamSearchOpts(beam=200.0, max_active=512,
                                          acoustic_scale=0.1),
                        device="cpu").decode(
    tri.am.loglikes(chip_smoke.pad_batch([f for _u, f, _w in utts])[0]),
    np.array([f.shape[0] for _u, f, _w in utts]))
assert all(r is not None for r in res)
from kaldi_tpu_torch.fst.graph import make_hclg
from kaldi_tpu_torch.steps.fmmi import FmmiTrainOpts, train_fmmi
from kaldi_tpu_torch.steps.mmi import MmiTrainOpts, train_discriminative
den = make_hclg(lang, arpa_to_g(ArpaLm.parse(chip_smoke.TRI_ARPA), lang.words),
                tri.trans_model, tri.ctx_dep, self_loop_scale=0.1)
sil = {lang.phones["SIL"]}
_am, hist = train_discriminative(tri, den, utts, MmiTrainOpts(
    num_iters=2, boost=0.1), silence_phones=sil)
assert len(hist) == 2 and np.isfinite(hist).all(), hist
_f, _am, hist = train_fmmi(tri, den, utts[:4], FmmiTrainOpts(
    num_iters=2, fmpe_gauss=4), silence_phones=sil)
assert len(hist) == 2 and np.isfinite(hist).all(), hist
from kaldi_tpu_torch.nnet3.configs import make_lstm_config
from kaldi_tpu_torch.nnet3.network import Nnet3
from kaldi_tpu_torch.nnet3.training import (Nnet3TrainOpts,
                                            make_nnet3_optimizer,
                                            make_nnet3_train_step)
net3 = Nnet3(make_lstm_config(4, 3, cell_dim=6, proj_dim=4, splice=(-1, 0, 1)),
             device="cpu")
p3 = net3.init(torch.Generator().manual_seed(0))
opt3 = make_nnet3_optimizer(net3, Nnet3TrainOpts(ng_update_period=2), 2)
st3 = opt3.init(p3)
step3 = make_nnet3_train_step(net3, opt3)
b3 = (torch.randn(2, 9, 4, generator=torch.Generator().manual_seed(1)),
      torch.zeros(2, 7, dtype=torch.int32),
      torch.ones(2, 7))
for _ in range(2):
    p3, st3, loss3, _acc = step3(p3, st3, *b3)
assert bool(torch.isfinite(loss3)) and st3[0].step == 2, loss3
from kaldi_tpu_torch.nnet1.nnet import Nnet1, train_frmshuff
net1 = Nnet1.from_proto("<AffineTransform> <InputDim> 4 <OutputDim> 3\n"
                        "<Softmax> <InputDim> 3 <OutputDim> 3\n", device="cpu")
_p1, hist1 = train_frmshuff(net1, net1.init(torch.Generator().manual_seed(0)),
                            np.random.RandomState(3).randn(20, 4)
                            .astype(np.float32), np.arange(20) % 3,
                            minibatch=8)
assert len(hist1) == 1 and np.isfinite(hist1[0][0]), hist1
from kaldi_tpu_torch.ivector.logistic_regression import LogisticRegression
from kaldi_tpu_torch.steps.sre import (SrePipelineOpts, evaluate_sre,
                                       train_sre_system)
rng = np.random.RandomState(4)
spk = {f"s{k}": [rng.randn(60, 5) + k for _ in range(3)] for k in range(4)}
sre_trials = [(a, b + "t", a == b) for a in spk for b in spk]
for kw in ({}, dict(post_fn=chip_smoke.sre_oracle_post_fn(
        np.array([[0.0] * 5, [3.0] * 5])), num_post_classes=2)):
    sre = train_sre_system({k: v[:2] for k, v in spk.items()},
                           SrePipelineOpts(num_gauss=4, ivector_dim=3,
                                           use_vad=False), device="cpu", **kw)
    eer, sc = evaluate_sre(sre, {k: v[2] for k, v in spk.items()},
                           {k + "t": v[2] for k, v in spk.items()}, sre_trials)
    assert len(sc) == 16 and 0.0 <= eer <= 1.0, (eer, sc)
lr = LogisticRegression()
assert lr.train(rng.randn(20, 3), np.arange(20) % 2, device="cpu") < np.log(2)
from kaldi_tpu_torch.steps.sgmm_steps import (SgmmMmiOpts, SgmmTrainOpts,
                                              train_sgmm2_bmmi,
                                              train_sgmm2_system)
sam, likes = train_sgmm2_system(tri, utts, SgmmTrainOpts(
    ubm_gauss=4, phn_dim=4, num_iters=2))
assert len(likes) == 2 and np.isfinite(likes).all(), likes
_sam, objs = train_sgmm2_bmmi(tri, sam, den, utts[:4], SgmmMmiOpts(num_iters=1))
assert len(objs) == 2 and np.isfinite(objs).all(), objs
assert chip_smoke.adapt_card_vs_cpu(card="cpu")["LVTLN class equal"] == 0.0
from kaldi_tpu_torch.kws import lattice_to_kws_index, search_index
from kaldi_tpu_torch.lat.mbr import mbr_decode
from kaldi_tpu_torch.lm.const_arpa import (ConstArpaLm,
                                           lattice_lmrescore_const_arpa_many)
from kaldi_tpu_torch.lm.synth import synth_trigram_arpa
from kaldi_tpu_torch.ops.pitch import compute_kaldi_pitch, process_pitch
hw, hl = chip_smoke.hub_lattices()
clm = ConstArpaLm(synth_trigram_arpa(hw, 200, 200,
                                     rng=np.random.default_rng(1)),
                  chip_smoke.symbol_table(hw))
resc = lattice_lmrescore_const_arpa_many(hl, clm, 0.5, device="cpu")
assert all(lattice_best_path(x) is not None for x in resc)
hyp, bins = mbr_decode(resc[0], max_paths=20)
assert hyp and len(bins) == len(hyp)
assert search_index([lattice_to_kws_index(resc[0], "u")], hyp[:1])
pt = process_pitch(compute_kaldi_pitch(chip_smoke.pitch_signals()[0],
                                       device="cpu"))
assert pt.shape[1] == 3 and np.isfinite(pt).all()
import tempfile
from kaldi_tpu_torch.io import kaldi_io, model_io, native
from kaldi_tpu_torch.online import compress
from kaldi_tpu_torch.online.gmm_decoding import SingleUtteranceGmmDecoder
from kaldi_tpu_torch.online.server import (AudioServer, FusedDecodeSession,
                                           fused_session_factory,
                                           stream_wave)
from kaldi_tpu_torch.online.threaded import ThreadedSingleUtteranceDecoder
tmp = tempfile.mkdtemp()
model_io.save_gmm_system(tmp + "/tri.mdl", tri)
tri2 = model_io.load_gmm_system(tmp + "/tri.mdl", device="cpu")
assert chip_smoke.trees_equal(tri2.ctx_dep.event_map, tri.ctx_dep.event_map)
np.testing.assert_array_equal(tri2.trans_model.id2pdf_array,
                              tri.trans_model.id2pdf_array)
model_io.save_am_nnet(tmp + "/am", am)
assert model_io.load_am_nnet(tmp + "/am", device="cpu").num_pdfs == 41
kaldi_io.write_ark(tmp + "/a.ark", [("a", feats)])
assert native.available()
assert np.array_equal(next(iter(kaldi_io.read_ark(tmp + "/a.ark")))[1], feats)
codes, _st = compress.adpcm_encode(wave)
assert len(compress.adpcm_decode(codes)[0]) == len(wave)
copts = CsrBeamOpts(beam=1e9, max_active=32, expand_budget=256,
                    hub_threshold=8)
words = chip_smoke.symbol_table([f"w{k}" for k in range(1, 41)])
srv = AudioServer("127.0.0.1", 0, fused_session_factory(
    am, hub, copts, fb, words, device="cpu", chunk_samples=1600, t_max=64))
srv.serve_in_background()
try:
    lines = stream_wave("127.0.0.1", srv.port, wave, chunk_samples=1001)
finally:
    srv.shutdown()
assert lines and lines[-1].startswith("FINAL "), lines
tdec = ThreadedSingleUtteranceDecoder(SingleUtteranceNnet2Decoder(
    am2, Tm, BeamSearchDecoder(hub, BeamSearchOpts(beam=1e9, max_active=32),
                               device="cpu"),
    OnlineNnet2FeaturePipeline(OnlineMfcc(fb, computer=fbank, device="cpu"),
                               OnlineIvectorFeature(ext))))
tdec.accept_waveform(wave)
tdec.input_finished()
assert tdec.wait(60.0) and tdec.best_path() is not None
gdec = SingleUtteranceGmmDecoder(
    tri.am, tri.trans_model, BeamSearchDecoder(g, BeamSearchOpts(
        beam=200.0, max_active=512), device="cpu"),
    OnlineFeaturePipeline(MfccOpts(frame_opts=FrameOpts(
        samp_freq=8000.0, dither=0.0)), device="cpu"))
gwave = chip_smoke.tri_synth(["AB", "CA"], np.random.RandomState(5))
gdec.pipeline.accept_waveform(gwave)
gdec.finalize_decoding()
assert gdec.best_path() is not None
from kaldi_tpu_torch.decoder.batching import decode_batched
from kaldi_tpu_torch.decoder.simple import simple_decode
from kaldi_tpu_torch.decoder.verify import (check_packed_graph,
                                            check_tier_tables)
from kaldi_tpu_torch.utils.profiling import (PROFILER, RECORDER,
                                             SpanRecorder, check_finite,
                                             dropped, span, spans)
hub40 = chip_smoke.star_hub_graph(40)
cdec = CsrBeamDecoder(hub40, CsrBeamOpts(beam=1e9, max_active=32,
                                         expand_budget=256, hub_threshold=8),
                      device="cpu")
check_packed_graph(cdec.graph)
check_tier_tables(cdec.graph, cdec.tabs, 8)
ll = np.random.RandomState(0).randn(2, 10, 41).astype(np.float32)
res = cdec.decode(ll, np.array([10, 6], np.int32))
utts = [("a", ll[0]), ("b", ll[1, :6])]
bat = decode_batched(cdec, utts, lambda x: x, batch_size=2, device="cpu")
assert bat["a"][0] == res[0][0] and bat["b"][0] == res[1][0], (bat, res)
assert simple_decode(cdec.graph, ll[0])[0] == list(res[0][0])
check_finite({"w": torch.ones(2)})
root = [s for s in spans() if s.name == "batching.decode_batched"][-1]
loops = [s for s in spans() if s.name == "csr_beam.frame_loop"
         and s.request == root.id]
assert len(loops) == 1 and loops[0].counts["frames"] >= 10, loops
with span("nojax.check", n=1):
    pass
assert spans()[-1].name == "nojax.check" and dropped() == 0
assert PROFILER.counts["csr_beam.frame_loop"] >= 2
assert isinstance(RECORDER, SpanRecorder)
import torch.distributed as dist
from kaldi_tpu_torch.parallel import (decode_frontier_sharded, host_shard,
                                      init_distributed, make_mesh)
assert init_distributed(num_processes=1, device="cpu") == (0, 1)
assert not dist.is_initialized()
assert host_shard(["u2", "u0", "u1"], 1, 2) == ["u1"]
mesh = make_mesh(1, 1, device="cpu")
fs = decode_frontier_sharded(cdec, ll, np.array([10, 6], np.int32), mesh)
assert [r[0] for r in fs] == [r[0] for r in res], (fs, res)
dist.destroy_process_group()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
       or m.startswith("kaldi_tpu.")]
assert not bad, bad
print("modules", len(names))
"""


def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split("modules")[-1]) >= 60, r.stdout
