"""The port runs where jax is not installed.

In a fresh interpreter whose import system refuses `jax` and `jaxlib`,
every kaldi_tpu_torch module (the int8 path, AmNnet, the streaming
server, the lattice modules, the training modules and the online path
among them) and chip_smoke.py's helpers import, and a small decode, a
record decode and its lattices (native and numpy), two train steps of a
tiny TDNN with clipping, momentum and NG-SGD, and the online path (MFCC
and deltas, the padded decoder, both fused engines, the nnet2 decoder
with i-vectors) run on the CPU. (kaldi_tpu/decoder/__init__.py imports the
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
          "kaldi_tpu_torch.online.nnet2_decoding"):
    assert n in names, n
import chip_smoke
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
    assert int(r.stdout.split("modules")[-1]) >= 34, r.stdout
