"""The plain references against the port at tiny sizes on the CPU (the
references import nothing of the port; these tests bring the two
together)."""

import numpy as np
import pytest
import torch

import tiny
from inputs.corpus import make_utterances
from inputs.graph import BigGraphConfig, make_big_hclg
from reference import features as rf
from reference import ivector as riv
from reference import search as rs
from reference import tdnn as rt
from reference import train as rtr

SPLICE = ((-2, -1, 0, 1, 2), (-1, 2), (-3, 3), (-7, 2), (0,))


def test_fbank_cmvn_and_mfcc_deltas():
    from kaldi_tpu_torch.ops.delta import add_deltas
    from kaldi_tpu_torch.ops.features import MfccOpts, cmvn, fbank, mfcc
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts
    from kaldi_tpu_torch.recognize import SERVING_FBANK
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16000 * 2, generator=g) * 3000
    a = cmvn(fbank(w, SERVING_FBANK)).double()
    b = rf.cmvn(rf.fbank(w.double()))
    assert (a - b).abs().max() < 1e-3
    o = MfccOpts(frame_opts=FrameOpts(samp_freq=8000.0, dither=0.0),
                 mel_opts=MelOpts(low_freq=20.0, high_freq=3700.0),
                 num_ceps=20)
    w8 = torch.randn(8000 * 2, generator=g) * 3000
    a = add_deltas(mfcc(w8, o)).double()
    b = rf.add_deltas(rf.mfcc(w8.double(), 8000.0, 23, 20.0, 3700.0, 20,
                              22.0))
    assert (a - b).abs().max() < 1e-3 * b.abs().max()


def test_tdnn_log_posteriors():
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from inputs.am import init_weights
    p = init_weights(40, 64, 32, SPLICE, 3, "cpu")
    p["final.w"] = torch.randn(p["final.w"].shape) * 0.1
    m = Tdnn(TdnnConfig(feat_dim=40, num_pdfs=32, hidden_dim=64,
                        splice_indexes=SPLICE, nonlinearity="relu"))
    m.load_state_dict(p)
    x = torch.randn(50, 40)
    a = m(x, pad_context=True).double()
    b = rt.log_posteriors(x, p, SPLICE)
    assert (a - b).abs().max() < 1e-4
    c = rt.log_posteriors(x, p, SPLICE, precision="fp8")
    assert (c - b).abs().max() > 10 * (a - b).abs().max()


def peaky(segs, P, rng):
    out = []
    for sg in segs:
        x = rng.normal(0, 1, (len(sg), P)) - 6.0
        x[np.arange(len(sg)), sg] += 8.0
        out.append(x - np.log(np.exp(x).sum(1, keepdims=True)))
    return out


def test_beam_search_and_path_cost():
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
    g, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                        num_pdfs=64, seed=1))
    rng = np.random.default_rng(0)
    _w, segs, _ = make_utterances(g, [120, 80, 100], rng)
    lls = peaky(segs, 64, rng)
    dec = CsrBeamDecoder(PackedGraph(**g), CsrBeamOpts(
        beam=13.0, max_active=512, expand_budget=4096), device="cpu")
    T = max(len(x) for x in lls)
    L = np.zeros((3, T, 64), np.float32)
    for i, x in enumerate(lls):
        L[i, : len(x)] = x
    port = dec.decode(torch.from_numpy(L), np.array([len(x) for x in lls]))
    ref = rs.beam_search(rs.DeviceGraph(g, "cpu"),
                         [torch.from_numpy(x) for x in lls], 13.0, 512, 0.1)
    for (pw, pt, pc), (rw, rtd, rc), x in zip(port, ref, lls):
        assert pw == rw and pt == rtd
        assert pc == pytest.approx(rc, abs=1e-3)
        assert rs.path_cost(g, x, pt, pw, 0.1) == pytest.approx(rc)
        bad = list(pw)
        bad[0] = bad[0] % 300 + 1
        assert rs.path_cost(g, x, pt, bad, 0.1) == float("inf")


def test_ivector_stats_and_extraction():
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    gen = torch.Generator().manual_seed(1)
    I, D, K = 8, 6, 5
    means = torch.randn(I, D, generator=gen, dtype=torch.float64)
    A = torch.randn(I, D, D, generator=gen, dtype=torch.float64)
    cov = A @ A.transpose(1, 2) / D + torch.eye(D, dtype=torch.float64)
    ic = torch.linalg.inv(cov)
    w = torch.softmax(torch.randn(I, generator=gen, dtype=torch.float64), 0)
    M = 0.3 * torch.randn(I, D, K, generator=gen, dtype=torch.float64)
    ext = IvectorExtractor.from_arrays(means.numpy(), ic.numpy(), w.numpy(),
                                       M.numpy(), 100.0)
    feats = [torch.randn(200, D, generator=gen, dtype=torch.float64) * 2
             for _ in range(3)]
    gamma, X = ext.batch_stats([f.numpy() for f in feats], 4, device="cpu")
    ivs = ext.extract_batch((gamma, X), "cpu")
    for n, f in enumerate(feats):
        post = riv.gselect_posteriors(f, means, ic, w, 4, 0.025)
        g, Xr = riv.stats(post, f)
        assert (gamma[n] - g).abs().max() < 1e-4 * g.max()
        assert (X[n] - Xr).abs().max() < 1e-4 * Xr.abs().max()
        r = riv.ivector(g, Xr, means, ic, M, 100.0)
        assert np.abs(ivs[n] - r.numpy()).max() < 1e-4 * r.abs().max()


def test_train_steps():
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                            make_train_step)
    from inputs.am import init_weights
    p0 = init_weights(40, 32, 16, SPLICE, 4, "cpu")
    gen = torch.Generator().manual_seed(2)
    batches = [(torch.randn(2, 60, 40, generator=gen),
                torch.randint(0, 16, (2, 38), generator=gen),
                torch.ones(2, 38)) for _ in range(3)]
    model = Tdnn(TdnnConfig(feat_dim=40, num_pdfs=16, hidden_dim=32,
                            splice_indexes=SPLICE, nonlinearity="relu"))
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.1, final_lr=0.02,
                                       max_grad_norm=5.0), 400)
    step = make_train_step(model, opt)
    params, st = dict(p0), opt.init(p0)
    losses = []
    for b in batches:
        params, st, loss, _ = step(params, st, *b)
        losses.append(float(loss))
    import harness
    ts = harness.load_module(tiny.BENCH + "/runners/train_step.py", "r_ts")
    cfg = tiny.load("configs", "tdnn1024_hclg60k")
    assert cfg["train"]["steps"] == 400
    lrs = [ts.lr_at(cfg, s) for s in range(3)]
    rl, after = rtr.steps(p0, batches, SPLICE, lrs, 5.0)
    assert np.allclose(losses, rl, rtol=1e-5)
    for k in p0:
        assert (params[k].double() - after[-1][k]).abs().max() \
            < 1e-5 * max(after[-1][k].abs().max(), 1e-3)
