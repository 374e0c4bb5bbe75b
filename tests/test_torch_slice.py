"""Port parity for the whole serving slice at a small size.

`kaldi_tpu_torch.recognize.Recognizer` against the JAX composition that
bench.py decodes with (fbank -> per-utterance CMVN -> Tdnn.apply ->
CsrBeamDecoder.decode), with the same numpy weights and waveforms: a relu
TDNN of width 64 over 64 pdfs, the 300-word synthetic HCLG, 2 x 2 s of
synthesized audio. f32 must give identical words; bf16 identical words on
this fixture, i.e. a WER difference of 0 (test_bf16_parity.py's bar).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.decoder.biggraph import (BigGraphConfig as JBigGraphConfig,
                                        make_big_hclg as j_make_big_hclg)
from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder as JDecoder,
                                        CsrBeamOpts as JOpts)
from kaldi_tpu.decoder.simulate import make_corpus
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu.ops import FbankOpts, FrameOpts, MelOpts, fbank
from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamOpts
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.params import random_tdnn_params
from kaldi_tpu_torch.recognize import Recognizer

torch.set_num_threads(2)

GRAPH = dict(vocab=300, avg_bigram_succ=20, num_pdfs=64, seed=1)
TDNN = dict(feat_dim=40, num_pdfs=64, hidden_dim=64, pnorm_output_dim=256,
            nonlinearity="relu")
DECODE = dict(beam=13.0, max_active=512, acoustic_scale=0.1,
              expand_budget=4096, eps_budget=1024)


@pytest.fixture(scope="module")
def fixture():
    jgraph, _ = j_make_big_hclg(JBigGraphConfig(**GRAPH))
    waves, _segs, words = make_corpus(jgraph, 2, 200,
                                      np.random.default_rng(0), noise=0.25)
    params = random_tdnn_params(TdnnConfig(**TDNN), np.random.default_rng(0))
    jparams = {"layers": [{k: jnp.asarray(v) for k, v in l.items()}
                          for l in params["layers"]],
               "final": {k: jnp.asarray(v) for k, v in params["final"].items()}}
    fb = FbankOpts(frame_opts=FrameOpts(samp_freq=16000.0, dither=0.0),
                   mel_opts=MelOpts(num_bins=40))
    f = fbank(jnp.asarray(waves), fb)
    feats = (f - jnp.mean(f, axis=1, keepdims=True)) / (
        jnp.std(f, axis=1, keepdims=True) + 1e-5)
    jdec = JDecoder(jgraph, JOpts(**DECODE))
    tgraph, _ = make_big_hclg(BigGraphConfig(**GRAPH))
    tdnn = Tdnn(TdnnConfig(**TDNN)).load_jax_params(params)
    return dict(waves=waves, words=words, feats=feats, jparams=jparams,
                jdec=jdec, tgraph=tgraph, tdnn=tdnn)


def _jax_decode(fx, dtype):
    post = JTdnn(JTdnnConfig(**TDNN)).apply(
        fx["jparams"], fx["feats"], pad_context=True, compute_dtype=dtype)
    post = np.asarray(post)
    B, T, _P = post.shape
    return post, fx["jdec"].decode(post, np.full(B, T, np.int32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_recognizer_matches_jax_composition(fixture, dtype):
    fx = fixture
    jdtype = None if dtype == "f32" else jnp.bfloat16
    tdtype = None if dtype == "f32" else torch.bfloat16
    post, want = _jax_decode(fx, jdtype)
    rec = Recognizer(fx["tdnn"], fx["tgraph"], CsrBeamOpts(**DECODE),
                     device="cpu", compute_dtype=tdtype)
    ll = rec.loglikes(fx["waves"]).numpy()
    assert ll.shape == post.shape and np.isfinite(ll).all()
    if dtype == "f32":
        np.testing.assert_allclose(ll, post, atol=1e-4, rtol=1e-4)
    got = rec.recognize(fx["waves"])
    for b in range(len(want)):
        assert got[b] is not None and want[b] is not None
        assert got[b][0] == want[b][0], b
        if dtype == "f32":
            assert got[b][1] == want[b][1], b
            assert abs(got[b][2] - want[b][2]) < 1e-2, b
    np.testing.assert_array_equal(rec.decoder.last_overflow,
                                  fx["jdec"].last_overflow)
