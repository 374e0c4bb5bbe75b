"""Card-only checks of the port: the table-gather and qaffine kernels, the
decoder, the int8 decode, the record decode with its lattices, the
chunked and adaptive decoders, the train steps, NG-SGD and checkpoints,
the mixed-up AM's group sum, the online path (features, the padded
decoder, both fused engines, the nnet2 decoder with i-vectors) and the GMM
path (GMM log-likelihoods, Viterbi alignment, the dense decoder's three
forward paths) and the triphone ladder (the affine transform, fMLLR and
MLLT statistics, a train_deltas EM iteration) and the discriminative path
(one MMI and one sMBR iteration's statistics, an nnet sMBR step) and the
nnet3 / nnet1 families (forwards of both nnet3 executors, NG-SGD steps,
train_frmshuff, train_lstm_streams, a CD-1 update, an nnet3 sMBR step)
and the speaker-recognition path (the diag and the full UBM's and the
gselect statistics within their bounds, an extractor E-step and M-step
for v1 and v2, sre10 v1 and v2 end to end with equal EERs, logistic
regression) and the adaptation and SGMM2 path (`loglikes_matrix` and the
SGMM2 statistics within their bounds, the updates and EBW solves by their
backward error, SGMM fMLLR, gpost and the pre-transform, raw, basis and
regression-tree fMLLR, MLLR, LVTLN and HLDA) and the rescoring and
feature modules (step_batch and the batch rescorer exactly, decode_biglm
against its exact oracle, pitch, resampling and convolution within their
bounds) and the file layer and network serving (every model file kind
through the port's save and load on the card, the decode sessions'
partials and finals, the threaded and the online GMM decoders, a TCP
server over concurrent connections) on a CUDA device.
Each test skips without a card. This file imports no jax, so it runs on
a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports jax, hence --noconftest there.)
"""

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.csr_beam import (AdaptiveCsrBeamDecoder,
                                              ChunkedCsrBeamDecoder,
                                              CsrBeamDecoder, CsrBeamOpts)
from kaldi_tpu_torch.decoder.simulate import make_corpus
from kaldi_tpu_torch.lat.generate import raw_lattice_from_decode
from kaldi_tpu_torch.nnet import quantized as tq
from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
from kaldi_tpu_torch.ops import table_gather as tg
from kaldi_tpu_torch.params import random_tdnn_params
from kaldi_tpu_torch.recognize import Recognizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from kaldi_tpu_torch.device import resolve_device
    return resolve_device("cuda")         # TF32 off for the plain versions


@pytest.mark.parametrize("B,P,N", [(8, 2048, 30384), (8, 7000, 4096),
                                   (3, 200, 1000), (2, 16384, 5000),
                                   (2, 20000, 3000), (4, 7000, 1),
                                   (1, 2048, 30384),
                                   # N % 4 != 0: scalar index loads and
                                   # stores, staged and direct rows
                                   (3, 200, 1001), (2, 4096, 4099),
                                   (2, 4097, 3001), (8, 7000, 4094)])
def test_kernel_bit_exact(card, B, P, N):
    rng = np.random.default_rng(P + N)
    tab = torch.from_numpy(rng.standard_normal((B, P)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, P, (B, N)).astype(np.int32))
    t, i = tab.to(card), idx.to(card)
    before = tg.launches
    got = tg.batched_table_gather(t, i)
    torch.cuda.synchronize()
    assert tg.launches == before + 1
    assert torch.equal(got, torch.gather(t, 1, i.long()))
    assert torch.equal(got.cpu(), tg.batched_table_gather(tab, idx))


@pytest.mark.parametrize("B,P,N", [(8, 2048, 30384), (8, 7000, 4096),
                                   (3, 200, 1003)])
def test_kernel_bit_exact_misaligned_index(card, B, P, N):
    rng = np.random.default_rng(P * N)
    tab = torch.from_numpy(rng.standard_normal((B, P)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-2, P + 2, (B, N)).astype(np.int32))
    t = tab.to(card)
    # the same indices one int32 past a 16-byte boundary
    moved = torch.empty(B * N + 1, dtype=torch.int32, device=card)[1:]
    moved = moved.view(B, N)
    moved.copy_(idx.to(card))
    assert moved.is_contiguous() and moved.data_ptr() % 16 == 4
    got = tg.batched_table_gather(t, moved)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tg.batched_table_gather(tab, idx))


def test_kernel_out_of_range_is_zero(card):
    tab = torch.arange(1, 201, dtype=torch.float32, device=card).view(2, 100)
    idx = torch.tensor([[-1, 0, 99, 100], [5, 1000, -7, 3]],
                       dtype=torch.int32, device=card)
    assert tg.gather_cuda(tab, idx).tolist() == [[0, 1, 100, 0],
                                                 [106, 0, 0, 104]]


@pytest.mark.parametrize("kw", [dict(fold_eps=True), dict(fold_eps=False),
                                dict(hub_threshold=64)])
def test_decoder_card_equals_cpu(card, kw):
    g, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                        num_pdfs=64, seed=1))
    opts = CsrBeamOpts(beam=9.0, max_active=256, acoustic_scale=0.1,
                       expand_budget=4096, eps_budget=1024, **kw)
    ll = (np.random.RandomState(3).randn(3, 40, 64) * 3).astype(np.float32)
    nf = np.array([40, 31, 17], np.int32)
    dg = CsrBeamDecoder(g, opts, device=card)
    dc = CsrBeamDecoder(g, opts, device="cpu")
    rg, rc = dg.decode(ll, nf), dc.decode(ll, nf)
    for b in range(3):
        assert rg[b][0] == rc[b][0] and rg[b][1] == rc[b][1]
        assert abs(rg[b][2] - rc[b][2]) < 1e-2
    for attr in ("last_overflow", "last_saturated", "last_active_sum",
                 "last_active_max"):
        np.testing.assert_array_equal(getattr(dg, attr), getattr(dc, attr))


# the path's shapes, then edges; (300, 72, 1024) has K % 16 != 0 and
# (129, 256, 130) is one row and one column past a tile
@pytest.mark.parametrize("M,K,N", [(7984, 200, 1024), (7984, 2048, 1024),
                                   (7984, 1024, 1024), (7984, 1024, 2048),
                                   (40, 128, 128), (1, 200, 1024),
                                   (37, 72, 48), (200, 33, 1000),
                                   (300, 72, 1024), (129, 256, 130)])
def test_qaffine_kernel_matches_plain(card, M, K, N):
    rng = np.random.default_rng(M + K + N)
    wq, sc = tq.quantize_weights(
        rng.standard_normal((N, K)).astype(np.float32) / np.sqrt(K))
    x = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in (x, wq, sc, b)]
    before = tq.launches
    got = tq.qaffine(*args)
    torch.cuda.synchronize()
    assert tq.launches == before + 1
    want = tq.qaffine_ref(*args)
    # three bf16 passes summed in f32 by the tensor cores, in another
    # order than the plain f32 matmul: 1e-5 of the output's scale
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


# x with full 24-bit mantissas at small K, against the product in f64. The
# split carries every bit of x, so the error is the accumulation's, near
# 1e-7 of max|y| here; a kernel without the lo pass loses 2^-17 of each x
# and lands near 2e-6.
@pytest.mark.parametrize("M,K,N", [(256, 16, 256), (512, 64, 512)])
def test_qaffine_kernel_keeps_all_of_x(card, M, K, N):
    rng = np.random.default_rng(K)
    wq, sc = tq.quantize_weights(
        rng.standard_normal((N, K)).astype(np.float32) / np.sqrt(K))
    x = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    got = tq.qaffine(*[torch.from_numpy(a).to(card) for a in (x, wq, sc, b)])
    want = ((x.astype(np.float64) @ wq.astype(np.float64).T)
            * sc.astype(np.float64) + b.astype(np.float64))
    err = np.abs(got.cpu().numpy().astype(np.float64) - want).max()
    assert err <= 1e-6 * np.abs(want).max(), err / np.abs(want).max()


def test_int8_decode_card_equals_cpu(card):
    g, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                        num_pdfs=64, seed=1))
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64, hidden_dim=64,
                     nonlinearity="relu")
    qtree = tq.quantize_tdnn(random_tdnn_params(cfg, np.random.default_rng(0)))
    waves, _segs, _words = make_corpus(g, 2, 200, np.random.default_rng(0),
                                       noise=0.25)
    opts = CsrBeamOpts(beam=13.0, max_active=512, acoustic_scale=0.1,
                       expand_budget=4096, eps_budget=1024)
    res = [Recognizer(tq.QuantizedTdnn(cfg).load_jax_qparams(qtree), g, opts,
                      device=dev, compute_dtype=None).recognize(waves)
           for dev in (card, "cpu")]
    for rg, rc in zip(*res):
        assert rg is not None and rc is not None
        assert rg[0] == rc[0] and rg[1] == rc[1]
        assert abs(rg[2] - rc[2]) < 1e-2


def _small_graph():
    g, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                        num_pdfs=64, seed=1))
    return g


REC = dict(rec_cap=128, rec_beam=6.0)


@pytest.mark.parametrize("rec", [dict(), dict(REC, rec_f16=True),
                                 dict(REC, rec_f16=True, rec_flat=True,
                                      rec_flat_cap=128),
                                 dict(REC, fold_eps=False)],
                         ids=["dense", "f16", "flat", "init_rounds"])
def test_decode_raw_card_equals_cpu(card, rec):
    g = _small_graph()
    opts = CsrBeamOpts(beam=10.0, max_active=256, acoustic_scale=0.1,
                       expand_budget=8192, eps_budget=2048, **rec)
    ll = (np.random.RandomState(11).randn(2, 25, 64) * 3).astype(np.float32)
    nf = np.array([25, 20], np.int32)
    dg = CsrBeamDecoder(g, opts, device=card)
    dc = CsrBeamDecoder(g, opts, device="cpu")
    rg, rc = dg.decode_raw(ll, nf), dc.decode_raw(ll, nf)
    assert list(rg) == list(rc)
    for key in rc:
        want, got = np.asarray(rc[key]), np.asarray(rg[key])
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if want.dtype.kind == "f" and not (rec.get("rec_f16")
                                           and key == "scores"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=key)
        else:   # ints, and scores rebuilt from the same float16 bits
            np.testing.assert_array_equal(got, want, err_msg=key)
    for attr in ("last_overflow", "last_saturated", "last_rec_trunc",
                 "last_active_sum", "last_active_max",
                 "last_flat_fallbacks"):
        np.testing.assert_array_equal(getattr(dg, attr), getattr(dc, attr))
    for b in range(2):
        for native in (True, False):
            lg = raw_lattice_from_decode(dg, rg, nf, b, 6.0,
                                         use_native=native)
            lc = raw_lattice_from_decode(dc, rc, nf, b, 6.0,
                                         use_native=native)
            ag, ac = lg.to_arrays(), lc.to_arrays()
            assert ag[0] == ac[0]
            for x, y in zip(ag[1:], ac[1:]):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)
            assert sorted(lg.finals) == sorted(lc.finals)


@pytest.mark.parametrize("tc", [7, 50])
def test_chunked_card_equals_one_shot(card, tc):
    g = _small_graph()
    opts = CsrBeamOpts(beam=9.0, max_active=128, acoustic_scale=0.1,
                       expand_budget=4096, eps_budget=1024, hub_threshold=64)
    ll = (np.random.RandomState(5).randn(3, 50, 64) * 3).astype(np.float32)
    nf = np.array([50, 41, 23], np.int32)
    ref = CsrBeamDecoder(g, opts, device=card)
    ch = ChunkedCsrBeamDecoder(g, opts, chunk_frames=tc, device=card)
    r_ref, r_ch = ref.decode(ll, nf), ch.decode(ll, nf)
    assert r_ch == r_ref
    for attr in ("last_overflow", "last_saturated", "last_active_sum",
                 "last_active_max"):
        np.testing.assert_array_equal(getattr(ch, attr), getattr(ref, attr))


def test_adaptive_card_equals_full(card):
    g = _small_graph()
    opts = CsrBeamOpts(beam=8.0, max_active=512, acoustic_scale=0.1,
                       expand_budget=16384, eps_budget=2048)
    ll = (np.random.RandomState(9).randn(3, 40, 64) * 3).astype(np.float32)
    nf = np.full(3, 40, np.int32)
    ad = AdaptiveCsrBeamDecoder(g, opts, small_max_active=64,
                                small_expand_budget=2048, device=card)
    res, full = ad.decode(ll, nf), ad.full.decode(ll, nf)
    assert ad.last_escalated.any()
    for r, f in zip(res, full):
        assert r[:2] == f[:2] and abs(r[2] - f[2]) < 1e-3


TRAIN_TDNN = TdnnConfig(feat_dim=8, num_pdfs=12, hidden_dim=16,
                        pnorm_output_dim=4, nonlinearity="relu",
                        splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))


def _train_on(dev, opt, steps, compute_dtype=None, seed=3):
    """`steps` train steps of the small TDNN on `dev` from seeded params
    and a batch with uneven frame weights. -> (params on the CPU,
    losses)."""
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.nnet.train import make_train_step
    from kaldi_tpu_torch.params import tdnn_params_from_jax
    rng = np.random.default_rng(seed)
    tree = random_tdnn_params(TRAIN_TDNN, rng)
    batch = [torch.as_tensor(a, device=dev) for a in (
        rng.standard_normal((3, 17, 8)).astype(np.float32),
        rng.integers(0, 12, (3, 10)).astype(np.int32),
        rng.uniform(0.5, 1.5, (3, 10)).astype(np.float32))]
    params = {k: v.to(dev) for k, v in tdnn_params_from_jax(tree).items()}
    state = opt.init(params)
    step = make_train_step(Tdnn(TRAIN_TDNN), opt, compute_dtype=compute_dtype)
    losses = []
    for _ in range(steps):
        params, state, loss, _ = step(params, state, *batch)
        assert loss.device.type == torch.device(dev).type
        losses.append(float(loss))
    return {k: v.cpu() for k, v in params.items()}, losses


def _assert_train_close(got, want, leaf_rel, loss_rel):
    (gp, gl), (wp, wl) = got, want
    for k in wp:
        err = float((gp[k] - wp[k]).abs().max())
        assert err <= leaf_rel * float(wp[k].abs().max()), (k, err)
    np.testing.assert_allclose(gl, wl, rtol=loss_rel)


@pytest.mark.parametrize("dtype,leaf_rel,loss_rel",
                         [(None, 1e-5, 1e-5), (torch.bfloat16, 2e-2, 1e-3)])
def test_train_steps_card_equal_cpu(card, dtype, leaf_rel, loss_rel):
    """8 steps with clip, l2 and momentum on: f32 at the train step's 1e-5
    bar; bf16 at the limits tests/test_torch_train.py states."""
    from kaldi_tpu_torch.nnet.train import NnetTrainOpts, make_optimizer
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.2, final_lr=0.05,
                                       max_grad_norm=0.5, l2_regularize=1e-2,
                                       momentum=0.9), 8)
    _assert_train_close(_train_on(card, opt, 8, dtype),
                        _train_on("cpu", opt, 8, dtype), leaf_rel, loss_rel)


def test_ng_sgd_card_equals_cpu_across_a_refresh(card):
    """12 steps at update_period 10: eigh by cuSOLVER against LAPACK."""
    from kaldi_tpu_torch.nnet.natural_gradient import ng_sgd
    opt = ng_sgd(0.05, alpha=0.5, update_period=10, momentum=0.9)
    _assert_train_close(_train_on(card, opt, 12, seed=1),
                        _train_on("cpu", opt, 12, seed=1), 1e-4, 1e-5)


def test_checkpoint_of_card_tensors(card, tmp_path):
    from kaldi_tpu_torch.params import tdnn_params_from_jax
    from kaldi_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    params = {k: v.to(card) for k, v in tdnn_params_from_jax(
        random_tdnn_params(TRAIN_TDNN, np.random.default_rng(0))).items()}
    params["final.b"] = params["final.b"].to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 5, params)
    step, back, _ = load_checkpoint(str(tmp_path), like=params)
    assert step == 5
    for k, v in params.items():
        assert back[k].device == v.device and back[k].dtype == v.dtype
        assert torch.equal(back[k], v)


# ------------------------------------------------------- the online path

def _mixed_am(dev):
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    cfg = TdnnConfig(feat_dim=40, num_pdfs=192, hidden_dim=256,
                     nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    gid = np.random.default_rng(4).permutation(np.repeat(np.arange(64), 3))
    model = Tdnn(cfg, device=dev).load_jax_params(
        random_tdnn_params(cfg, np.random.default_rng(3)))
    return AmNnet(model, group_ids=gid)


def test_group_sum_is_deterministic_and_equals_cpu(card):
    """The mixed-up AM's segment sums have a fixed order: two card runs are
    bit-equal, and the group sum of the same log-posteriors on the card
    equals the CPU's within 1e-6 relative."""
    from kaldi_tpu_torch.nnet.combine import sum_group_log_posteriors
    am = _mixed_am(card)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 300, 40)).astype(np.float32)).to(card)
    a, b = am.loglikes(x), am.loglikes(x)
    assert torch.equal(a, b)
    lp = torch.log_softmax(torch.from_numpy(np.random.default_rng(6)
                                            .standard_normal((4, 300, 192))
                                            .astype(np.float32)), dim=-1)
    got = sum_group_log_posteriors(lp.to(card), am.group_ids, 64).cpu()
    want = sum_group_log_posteriors(lp, am.group_ids, 64)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_online_features_card_equal_cpu(card):
    from kaldi_tpu_torch.ops.delta import add_deltas, sliding_cmvn
    from kaldi_tpu_torch.ops.features import MfccOpts, PlpOpts, mfcc, plp
    from kaldi_tpu_torch.ops.window import FrameOpts
    wave = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 16000)).astype(np.float32) * 1000)
    fo = FrameOpts(dither=0.0)
    for fn, opts in ((mfcc, MfccOpts(frame_opts=fo)),
                     (plp, PlpOpts(frame_opts=fo))):
        got, want = fn(wave.to(card), opts), fn(wave, opts)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-3)
        torch.testing.assert_close(add_deltas(got).cpu(), add_deltas(want),
                                   rtol=2e-4, atol=2e-3)
        torch.testing.assert_close(sliding_cmvn(got).cpu(),
                                   sliding_cmvn(want), rtol=2e-4, atol=2e-3)


def test_beam_search_card_equals_cpu(card):
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    g = _small_graph()
    opts = BeamSearchOpts(beam=11.0, max_active=128)
    ll = (np.random.RandomState(8).randn(2, 30, 64) * 3).astype(np.float32)
    nf = np.array([30, 22], np.int32)
    dg = BeamSearchDecoder(g, opts, device=card)
    dc = BeamSearchDecoder(g, opts, device="cpu")
    for rg, rc in zip(dg.decode(ll, nf), dc.decode(ll, nf)):
        assert rg[0] == rc[0] and rg[1] == rc[1]
        assert abs(rg[2] - rc[2]) < 1e-2
    rg, rc = dg.decode_raw(ll, nf), dc.decode_raw(ll, nf)
    for key in rc:
        if rc[key].dtype.kind == "f":
            np.testing.assert_allclose(rg[key], rc[key], rtol=0, atol=1e-4,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(rg[key], rc[key], err_msg=key)


def _stream(fused, wave, chunk=2560):
    fused.reset()
    for pos in range(0, len(wave), chunk):
        fused.accept_waveform(wave[pos:pos + chunk])
    fused.input_finished()
    return fused.best_path()


@pytest.mark.parametrize("engine", ["padded", "csr"])
def test_fused_card_equals_cpu(card, engine):
    """Both engines of FusedOnlineDecoder stream the same words and tids on
    the card as on the CPU; the CSR engine's emitting rounds launch the
    gather kernel."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
    from kaldi_tpu_torch.ops.features import FbankOpts
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts
    g = _small_graph()
    fb = FbankOpts(frame_opts=FrameOpts(dither=0.0),
                   mel_opts=MelOpts(num_bins=40))
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64, hidden_dim=128,
                     nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    params = random_tdnn_params(cfg, np.random.default_rng(0))
    waves = [np.random.default_rng(s).standard_normal(n).astype(np.float32)
             * 4000 for s, n in ((1, 20000), (2, 9999))]
    res = {}
    for dev in (card, "cpu"):
        am = AmNnet(Tdnn(cfg).load_jax_params(params))
        if engine == "padded":
            dec = BeamSearchDecoder(g, BeamSearchOpts(beam=11.0,
                                                      max_active=128),
                                    device=dev)
        else:
            dec = CsrBeamDecoder(g, CsrBeamOpts(
                beam=11.0, max_active=128, expand_budget=4096,
                eps_budget=1024), device=dev)
        fused = FusedOnlineDecoder(am, dec, fb, t_max=256)
        before = tg.launches
        res[str(dev)] = [_stream(fused, w) for w in waves]
        if engine == "csr" and dev == card:
            assert tg.launches > before
    for rg, rc in zip(res[str(card)], res["cpu"]):
        assert rg is not None and rc is not None
        assert rg[0] == rc[0] and rg[1] == rc[1]
        assert abs(rg[2] - rc[2]) < 1e-2


def test_gmm_loglikes_card_equal_cpu(card):
    import chip_smoke as cs
    rng = np.random.RandomState(0)
    counts = [1, 40] + [int(c) for c in rng.randint(1, 17, 20)]
    feats = (rng.randn(3, 200, 39) * 3.0).astype(np.float32)
    got = cs.random_am(counts, 39, 1, card).loglikes(feats).cpu().numpy()
    want = cs.random_am(counts, 39, 1, "cpu").loglikes(feats).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_viterbi_align_card_equals_cpu(card):
    import chip_smoke as cs
    from kaldi_tpu_torch.decoder.graph_pack import pack_graphs
    from kaldi_tpu_torch.decoder.viterbi import equal_align, viterbi_align
    from kaldi_tpu_torch.fst.graph import TrainingGraphCompiler
    lang, ctx, tm, _g = cs.gmm_stack(cs.RM_LEXICON, cs.rm_unigram_arpa())
    comp = TrainingGraphCompiler(lang, tm, ctx, 1.0, 0.1)
    batch = pack_graphs([comp.compile_transcript(w) for w in
                         (["ONE", "TWO"], ["STOP", "OH", "NINE"], ["SIX"])],
                        tm.id2pdf_array)
    nf = np.array([70, 90, 4], np.int32)        # the last has no path
    ll = (np.random.RandomState(1).randn(3, 90, tm.num_pdfs) * 4.0).astype(
        np.float32)
    for fn in (lambda d: viterbi_align(batch, ll, nf, 0.1, device=d),
               lambda d: equal_align(batch, nf, device=d)):
        got, want = fn(card), fn("cpu")
        assert got[2] is None and want[2] is None
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1] and abs(g[2] - w[2]) <= 1e-5 * abs(w[2])


@pytest.mark.parametrize("which,opts", [
    ("yesno", {}), ("rm_like", {}), ("rm_like", {"traceback_chunk": 16}),
    ("hub", {"acoustic_scale": 1.0})],
    ids=["assoc", "sequential", "checkpointed", "hub"])
def test_dense_paths_card_equal_cpu(card, which, opts):
    import chip_smoke as cs
    from kaldi_tpu_torch.decoder.dense import (DenseDecoderOpts,
                                               DenseViterbiDecoder)
    rng = np.random.RandomState(2)
    if which == "hub":
        g, P = cs.dense_hub_graph(), 7
        ll = rng.randint(-20, 1, (3, 50, P)).astype(np.float32)
    else:
        lex, arpa = ((cs.YESNO_LEXICON, cs.YESNO_ARPA) if which == "yesno"
                     else (cs.RM_LEXICON, cs.rm_unigram_arpa()))
        _l, _c, tm, g = cs.gmm_stack(lex, arpa)
        ll = (rng.randn(3, 50, tm.num_pdfs) * 5.0).astype(np.float32)
    nf = np.array([50, 37, 9], np.int32)
    got, want = (DenseViterbiDecoder(g, DenseDecoderOpts(**opts),
                                     device=d).decode(ll, nf)
                 for d in (card, "cpu"))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert a[0] == b[0] and a[1] == b[1]
            assert abs(a[2] - b[2]) <= 1e-4 * max(abs(b[2]), 1.0)


def test_apply_affine_transform_card_equals_cpu(card):
    import chip_smoke as cs
    from kaldi_tpu_torch.transform.fmllr import apply_affine_transform
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 300, 39) * 8.0).astype(np.float32)
    W = np.concatenate([np.eye(39) + rng.randn(39, 39) * 0.1,
                        rng.randn(39, 1)], axis=1)
    got = apply_affine_transform(x, W, card)
    assert got.device.type == "cuda"
    want = apply_affine_transform(x, W).numpy()
    assert np.max(np.abs(got.cpu().numpy() - want)
                  / cs.affine_term_scale(x, W)) <= 1e-6


def _sat_mono_and_alignments():
    import chip_smoke as cs
    from kaldi_tpu_torch.steps import mono, tdnn
    train, _test, _refs = cs.sat_corpus("cpu")
    lang = cs.gmm_stack(cs.YESNO_LEXICON, cs.YESNO_ARPA)[0]
    utts = [(u, f, w) for u, f, w, _s in train[:9]]
    m = mono.train_mono(lang, utts, mono.MonoTrainOpts(**cs.SAT_LDA_MONO),
                        device="cpu")
    return m, tdnn.align_with_gmm(m, utts)


def test_fmllr_and_mllt_stats_card_equal_cpu(card):
    """Statistics whose posteriors come from the card, within 1e-5 of the
    same sums with each posterior 1 and the terms' absolute values, and
    within the bound that the loglikes' card-vs-CPU difference sets
    (chip_smoke.posterior_stats_card_vs_cpu, as phase 19 holds them)."""
    import chip_smoke as cs
    m, ali = _sat_mono_and_alignments()
    _stats, errs = cs.posterior_stats_card_vs_cpu(
        cs.gmm_model_on(m, "cpu").am, cs.gmm_model_on(m, card).am, ali)
    check = cs._Limits()
    cs.check_posterior_stats(check, "SAT corpus", errs)
    assert check.failed == []
    for k in ("fMLLR K", "fMLLR G", "MLLT G"):
        assert errs[k]["terms"] <= 1e-5, (k, errs[k])
    assert errs["fMLLR beta"]["terms"] <= 1e-5


def test_train_deltas_iteration_card_equals_cpu(card):
    """train_deltas' tree from card and CPU alignments, then its first EM
    iteration from the tree's init on each (chip_smoke.em_card_vs_cpu:
    identical alignments, parameters within 1e-5, loglikes within 1e-5
    of their GEMM terms' magnitude)."""
    import copy
    import chip_smoke as cs
    from kaldi_tpu_torch.steps import deltas, mono
    rng = np.random.RandomState(11)
    train = cs.tri_corpus(rng, 12, lambda w: cs.mfcc_deltas(w, "cpu"))
    lang = cs.gmm_stack(cs.TRI_LEXICON, cs.TRI_ARPA)[0]
    m = mono.train_mono(lang, train, mono.MonoTrainOpts(**cs.TRI_MONO),
                        device="cpu")
    opts = deltas.DeltasTrainOpts(**cs.TRI_SMALL)
    trees = {d: deltas.build_triphone_tree(lang, cs.gmm_model_on(m, d),
                                           train, opts)
             for d in ("cpu", "cuda")}
    (cc, ctm, cls), (gc, gtm, _gls) = trees["cpu"], trees["cuda"]
    assert cs.trees_equal(cc.event_map, gc.event_map)
    np.testing.assert_array_equal(ctm.id2pdf_array, gtm.id2pdf_array)
    models = {d: mono.MonoModel(deltas.init_am_from_leaf_stats(cls, 39, d),
                                copy.deepcopy(ctm), cc, lang)
              for d in ("cpu", "cuda")}
    batch, feats, nf = mono.compile_and_pad(lang, ctm, cc, train, 1.0, 0.1)
    err, ll_err = cs.em_card_vs_cpu("train_deltas iteration", models, batch,
                                    feats, nf, opts, None,
                                    models["cpu"].am.total_gauss + 20)
    assert err <= 1e-5 and ll_err <= 1e-5


@pytest.mark.parametrize("criterion", ["mmi", "smbr"])
def test_discriminative_iteration_card_equals_cpu(card, criterion):
    """One MMI (sMBR) iteration's num and den statistics on the yesno
    system, the card's AM against the CPU's on the same boosted lattices
    and numerator alignment (chip_smoke.disc_small_setup): the lattice
    weights and every statistic within the bound that the two devices'
    loglikes set (chip_smoke.disc_stats_card_vs_cpu, as phase 21 holds
    them)."""
    import dataclasses
    import chip_smoke as cs
    su = cs.disc_small_setup()
    _stats, errs = cs.disc_stats_card_vs_cpu(
        su["m_cpu"].am, su["m_card"].am, su["tm"], su["lats"], su["align"],
        su["feats"], su["nf"],
        dataclasses.replace(su["opts"], criterion=criterion), su["sil"])
    assert errs["weight ratio"] <= 1.0, errs
    assert errs["num"]["bound"] <= 1.0 and errs["den"]["bound"] <= 1.0, errs


def test_nnet_smbr_step_card_equals_cpu(card):
    """One sMBR step of a small TDNN on the card and on the CPU from the
    same params, features and posteriors (chip_smoke.smbr_step_card_vs_cpu):
    each leaf within 1e-5 of its largest |p| plus its largest step, and
    moved."""
    import chip_smoke as cs
    st = cs.smbr_step_card_vs_cpu(cs.disc_small_setup())
    assert st["err"] <= 1e-5 and st["moved"] > 0, st


@pytest.mark.parametrize("which", ["tdnn", "lstm"])
def test_nnet3_forward_and_steps_card_equal_cpu(card, which):
    """The dense (TDNN) and recurrent (LSTM) executors' forwards within 1e-5
    of max |y|, and 8 NG-SGD steps within TRAIN_LIMITS["ng_sgd"]
    (chip_smoke's phase 23 helpers; `_train_errors` raises past them)."""
    import chip_smoke as cs
    assert cs.nnet3_forward_card_vs_cpu(which) <= cs.NNET_FORWARD_LIMIT
    cs.nnet3_steps_card_vs_cpu(which)


def test_nnet1_trainers_and_rbm_card_equal_cpu(card):
    """One train_frmshuff pass and 2 train_lstm_streams chunks within
    TRAIN_LIMITS["f32"]; a CD-1 update from a shared hidden sample within
    1e-5."""
    import chip_smoke as cs
    cs.frmshuff_card_vs_cpu()
    cs.lstm_streams_card_vs_cpu()
    assert cs.cd1_card_vs_cpu() <= 1e-5


def test_nnet3_smbr_step_card_equals_cpu(card):
    """One sMBR step of a config-built nnet3 TDNN behind AmNnet3 on the
    card and on the CPU: each leaf within 1e-5 of its terms, and moved."""
    import chip_smoke as cs
    st = cs.nnet3_smbr_step_card_vs_cpu(cs.disc_small_setup())
    assert st["err"] <= 1e-5 and st["moved"] > 0, st


def _sre_small():
    import chip_smoke as cs
    data, cm = cs.sre_small_corpus(np.random.RandomState(0))
    return cs.sre_small_split(data), cm


def test_sre_statistics_card_equal_cpu(card):
    """On CPU-trained sre10 v1 and v2 systems of tests/test_sre_pipeline.py's
    corpus: the diag and the full UBM's statistics, the gselect / min-post
    stats and one extractor E-step and M-step from the same stats, card vs
    CPU, each within its bound (chip_smoke's phase 25 helpers)."""
    import chip_smoke as cs
    from kaldi_tpu_torch.steps import sre
    (train, _e, _t, _tr), cm = _sre_small()
    st: dict = {}
    s = sre.train_sre_system(train, sre.SrePipelineOpts(
        **cs.SRE_SMALL["v1"]), device="cpu", stage_stats=st)
    flat = [f for us in train.values() for f in us]
    pooled = np.concatenate(flat)
    check = cs._Limits()
    gs = cs.gselect_stats_card_vs_cpu(s.extractor, flat, s.opts.num_gselect)
    cs.check_ubm_stats(check, "v1", cs.diag_ubm_stats_card_vs_cpu(
        st["diag_gmm"], pooled), cs.full_ubm_stats_card_vs_cpu(
        s.ubm, pooled), gs)
    cs.check_extractor_step(check, "v1", cs.extractor_step_card_vs_cpu(
        s.extractor, *gs["stats"]))
    s2 = sre.train_sre_system(train, sre.SrePipelineOpts(
        **cs.SRE_SMALL["v2"]), post_fn=cs.sre_oracle_post_fn(cm),
        num_post_classes=4, device="cpu")
    g2, X2 = s2.stats(flat)
    cs.check_extractor_step(check, "v2", cs.extractor_step_card_vs_cpu(
        s2.extractor, g2.numpy(), X2.numpy()))
    check.done("card-only SRE statistics")


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_sre_pipeline_card_equals_cpu(card, name):
    """train_sre_system + evaluate_sre on the card and on the CPU: the
    same EER, under PARITY.md:47's 15%."""
    import chip_smoke as cs
    from kaldi_tpu_torch.steps import sre
    (train, enroll, test, trials), cm = _sre_small()
    kw = ({} if name == "v1" else
          dict(post_fn=cs.sre_oracle_post_fn(cm), num_post_classes=4))
    eer = {d: sre.evaluate_sre(sre.train_sre_system(
        train, sre.SrePipelineOpts(**cs.SRE_SMALL[name]), device=d, **kw),
        enroll, test, trials)[0] for d in ("cpu", "cuda")}
    assert eer["cuda"] == eer["cpu"] < 0.15, eer


def test_logistic_regression_card_equals_cpu(card):
    """Logistic regression on 5 overlapping classes: the loss within 1e-5
    relative and the same classes (the weights are not held: Adam follows
    f32 noise where the loss is flat)."""
    from kaldi_tpu_torch.ivector.logistic_regression import \
        LogisticRegression
    rng = np.random.RandomState(0)
    y = rng.randint(0, 5, 200)
    X = rng.randn(5, 12)[y] + rng.randn(200, 12)
    lr = {d: LogisticRegression() for d in ("cpu", "cuda")}
    loss = {d: lr[d].train(X, y, device=d) for d in lr}
    assert abs(loss["cuda"] - loss["cpu"]) <= 1e-5 * abs(loss["cpu"])
    np.testing.assert_array_equal(lr["cuda"].classify(X),
                                  lr["cpu"].classify(X))


def _sgmm_small():
    import chip_smoke as cs
    return cs.sgmm_small_setup("cpu")


def test_sgmm_loglikes_and_statistics_card_within_their_bounds(card):
    """`loglikes_matrix` and the SGMM2 accumulation (gamma, y, Y, Q,
    S_centered, the total loglike) card vs CPU, plain and with a speaker
    vector, each within its bound (chip_smoke's phase 27 helpers)."""
    import chip_smoke as cs
    from kaldi_tpu_torch.sgmm import estimate_speaker_vector
    su = _sgmm_small()
    m = su["model"]
    spk = estimate_speaker_vector(m, su["spk_feats"], su["spk_post"], 3)
    assert cs.sgmm_loglikes_card_vs_cpu(m, su["feats"], 3) <= 1.0
    assert cs.sgmm_loglikes_card_vs_cpu(m, su["spk_feats"], 3, spk) <= 1.0
    for x, post, sp in ((su["feats"], su["post"], None),
                        (su["spk_feats"], su["spk_post"], spk)):
        e = cs.sgmm_stats_card_vs_cpu(m, x, post, 3, sp)
        assert e["unjustified"] == 0
        for k in ("gamma", "y", "Y", "Q", "S_centered", "tot_like"):
            assert e[k] <= 1.0, (k, e[k])


def test_sgmm_updates_ebw_and_extras_card_within_their_bounds(card):
    import chip_smoke as cs
    su = _sgmm_small()
    m = su["model"]
    e = cs.sgmm_stats_card_vs_cpu(m, su["feats"], su["post"], 3)
    up = cs.sgmm_update_card_vs_cpu(m, e["accs"], "vMwSc")
    assert max(up.values()) <= 1.0, up
    ex = cs.sgmm_extras_card_vs_cpu(su)
    for k, v in ex.items():
        assert v <= (0.0 if "differ" in k else 1.0), (k, v)


def test_adaptation_transforms_card_within_their_bounds(card):
    import chip_smoke as cs
    for k, v in cs.adapt_card_vs_cpu().items():
        if "reported" not in k:
            assert v <= (0.0 if "equal" in k else 1.0), (k, v)


@pytest.mark.parametrize("name", ["plain", "missing_backoffs",
                                  "unused_backoffs"])
def test_step_batch_and_rescoring_card_equal_cpu(card, name):
    """step_batch exactly (chip_smoke.step_batch_card_vs_cpu, phase 29),
    and the batch rescorer's lattices array for array on random
    topological lattices at three scales."""
    import chip_smoke as cs
    clm = cs.shape_lm(name)
    assert not any(cs.step_batch_card_vs_cpu(clm).values())
    lats = cs.random_topo_lattices(1, 8, [1, 2, 3, 0, 99])
    for scale in (0.5, 1.0, -1.0):
        assert cs.rescore_card_vs_cpu(lats, clm, scale)[-1] == 0


def test_hub_lattice_rescoring_card_equals_cpu(card):
    import chip_smoke as cs
    from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm
    from kaldi_tpu_torch.lm.synth import synth_trigram_arpa
    words, lats = cs.hub_lattices()
    clm = ConstArpaLm(synth_trigram_arpa(words, 300, 300,
                                         rng=np.random.default_rng(3)),
                      cs.symbol_table(words))
    assert cs.rescore_card_vs_cpu(lats, clm, 0.5)[-1] == 0


def test_decode_biglm_on_the_card_equals_exact(card):
    import chip_smoke as cs
    b = cs.biglm_vs_exact()
    assert b["n"] == 3 and not b["words"] and not b["none"]
    assert b["cost gap"] <= 1e-3


def test_pitch_and_resampling_card_within_their_bounds(card):
    """chip_smoke.features_card_vs_cpu on tests/test_signal_pitch.py's
    signals: convolution, both resamplers and the NCCF within the bounds
    of their arithmetic, the Viterbi path equal on every frame."""
    import chip_smoke as cs
    f = cs.features_card_vs_cpu(cs.pitch_signals())
    for k in ("conv", "resample 8k", "resample 4k", "nccf"):
        assert f[k] <= 1.0, (k, f)
    assert f["viterbi frames"] == 0 and f["pitch frames"] == 0, f


# --- the file layer and network serving (chip_smoke.py phase 31) ---

@pytest.fixture(scope="module")
def yesno_gmm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    return cs.yesno_gmm_system()


def test_model_files_card_equal_cpu(card, yesno_gmm, tmp_path):
    """Every model kind saved by the port, loaded on the card and on the
    CPU and saved again: equal files, the card's loads computing exactly
    what the originals did (chip_smoke.model_files_card_vs_cpu)."""
    import chip_smoke as cs
    assert len(cs.model_files_card_vs_cpu(yesno_gmm, str(tmp_path))) == 14


def test_decode_sessions_card_equal_cpu(card, yesno_gmm):
    """DecodeSession and FusedDecodeSession over even, odd and
    one-byte-first PCM chunks: every partial and final equal."""
    import chip_smoke as cs
    s = cs.sessions_card_vs_cpu(yesno_gmm)
    assert s["gmm"] > 0 and s["fused"] > 0


def test_threaded_decoder_on_the_card_equals_synchronous(card, yesno_gmm):
    import chip_smoke as cs
    assert cs.threaded_vs_sync(yesno_gmm) > 0


def test_online_gmm_decoder_card_within_its_bound(card, yesno_gmm):
    import chip_smoke as cs
    g = cs.gmm_decoder_card_vs_cpu(yesno_gmm)
    assert g["words"] == 8 and g["estimates"] > 0
    assert g["bound ratio"] <= 1.0, g


def test_fused_server_on_the_card_answers_concurrent_connections(card):
    """Three connections at once to an AudioServer over
    `fused_session_factory` on the card: each FINAL equals the offline
    decode on the card, and the gather launched."""
    import chip_smoke as cs
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn
    from kaldi_tpu_torch.online.server import (AudioServer,
                                               fused_session_factory)
    su = cs.small_stream_setup()
    am = AmNnet(Tdnn(su["cfg"]).load_jax_params(su["params"]),
                priors=su["priors"])
    words = cs.symbol_table([f"w{k}" for k in range(1, 41)])
    factory = fused_session_factory(am, su["graph"], su["opts"], su["fb"],
                                    words, chunk_samples=2560, t_max=256)
    dec = factory().fused.dec
    rng = np.random.default_rng(36)
    waves = [(rng.standard_normal(n) * 4000).astype(np.float32)
             for n in (20000, 13333, 26001)]
    want = [[f"w{w}" for w in r[0]]
            for r in cs._offline(am, dec, waves, su["fb"])]
    tg.launches = 0
    got = cs._finals(cs._serve_concurrently(
        AudioServer("127.0.0.1", 0, factory), waves, 2560))
    assert got == want and tg.launches > 0


# --- decoder tools (PR 16's phase 33 helpers) ---

def test_verifiers_card_equal_cpu(card):
    """check_packed_graph / check_tier_tables silent on the card's tables
    in both tier-B layouts, every corruption raising as on the CPU."""
    import chip_smoke as cs
    assert cs.verify_card_vs_cpu()["corruptions"] >= 12


def test_decode_batched_card_equals_cpu_and_single(card):
    import chip_smoke as cs
    b = cs.batched_card_vs_cpu()
    assert b["utts"] == len(cs.TOOLS_LENGTHS) and b["launches"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_simple_decode_equals_csr_on_the_card(card, seed):
    import chip_smoke as cs
    assert cs.simple_vs_csr(seed=seed)["cost_gap"] <= 1e-4
