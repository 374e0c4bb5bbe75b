"""Port parity: kaldi_tpu_torch's FusedStreamingServer against kaldi_tpu's.

test_fused_serving.py's fixture (24-bin fbank, the 40-word HCLG, a relu
TDNN of width 64 over 16 pdfs, 4 streams of 160 ms chunks), but with
numpy-seeded weights and non-uniform priors, given to both packages:
`Tdnn.init`'s zero final layer would tie every acoustic cost. On the
contracts of test_fused_serving.py (mixed lengths and feed rates, slot
reuse, staggered open/close, a stream near capacity beside an idle slot)
the port's streams give the JAX server's words and tids, cost within
rel 1e-4 / abs 1e-2, and equal the port's own offline decode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.decoder.biggraph import (BigGraphConfig as JBigGraphConfig,
                                        make_big_hclg as j_make_big_hclg)
from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder as JDecoder,
                                        CsrBeamOpts as JOpts)
from kaldi_tpu.nnet.am_nnet import AmNnet as JAmNnet
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu.online.serving import FusedStreamingServer as JServer
from kaldi_tpu.ops import (FbankOpts as JFbankOpts, FrameOpts as JFrameOpts,
                           MelOpts as JMelOpts)
from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.online.serving import FusedStreamingServer
from kaldi_tpu_torch.ops.features import FbankOpts, fbank
from kaldi_tpu_torch.ops.mel import MelOpts
from kaldi_tpu_torch.ops.window import FrameOpts
from kaldi_tpu_torch.params import random_tdnn_params

torch.set_num_threads(2)

GRAPH = dict(vocab=40, avg_bigram_succ=6, num_pdfs=16, seed=3)
TDNN = dict(feat_dim=24, num_pdfs=16, hidden_dim=64, pnorm_output_dim=32,
            nonlinearity="relu",
            splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
DECODE = dict(beam=11.0, max_active=128, acoustic_scale=0.1,
              expand_budget=2048, eps_budget=512, hub_threshold=64)
SERVE = dict(n_streams=4, chunk_samples=2560, t_max=256)


def _build(fold_eps):
    params = random_tdnn_params(TdnnConfig(**TDNN), np.random.default_rng(0))
    priors = np.random.default_rng(1).dirichlet(np.ones(16))
    jparams = {"layers": [{k: jnp.asarray(v) for k, v in l.items()}
                          for l in params["layers"]],
               "final": {k: jnp.asarray(v) for k, v in params["final"].items()}}
    jam = JAmNnet(JTdnn(JTdnnConfig(**TDNN)), jparams, priors=priors)
    jgraph, _ = j_make_big_hclg(JBigGraphConfig(**GRAPH))
    jdec = JDecoder(jgraph, JOpts(**DECODE, fold_eps=fold_eps))
    jfb = JFbankOpts(frame_opts=JFrameOpts(dither=0.0),
                     mel_opts=JMelOpts(num_bins=24))
    am = AmNnet(Tdnn(TdnnConfig(**TDNN)).load_jax_params(params),
                priors=priors)
    graph, _ = make_big_hclg(BigGraphConfig(**GRAPH))
    dec = CsrBeamDecoder(graph, CsrBeamOpts(**DECODE, fold_eps=fold_eps),
                         device="cpu")
    fb = FbankOpts(frame_opts=FrameOpts(dither=0.0),
                   mel_opts=MelOpts(num_bins=24))
    return dict(jam=jam, jdec=jdec, jfb=jfb, am=am, dec=dec, fb=fb,
                jsrv=JServer(jam, jdec, jfb, **SERVE),
                srv=FusedStreamingServer(am, dec, fb, **SERVE))


@pytest.fixture(scope="module")
def fx():
    return _build(fold_eps=True)       # the eps arcs fold away: R = 1


def _offline(fx, wave):
    """The port's offline decode: fbank -> AmNnet.loglikes -> decode."""
    feats = fbank(torch.from_numpy(wave), fx["fb"])
    ll = fx["am"].loglikes(feats[None])
    return fx["dec"].decode(ll, np.array([feats.shape[0]], np.int32))[0]


def _same(got, want, what):
    assert got is not None and want is not None, what
    assert list(got[0]) == list(want[0]), f"{what}: words differ"
    assert list(got[1]) == list(want[1]), f"{what}: tids differ"
    assert got[2] == pytest.approx(want[2], rel=1e-4, abs=1e-2), what


def _mixed(srv, waves):
    slots = [srv.open() for _ in waves]
    assert srv.open() is None          # batch is full
    pos = [0] * len(waves)
    sizes = [2560, 1300, 5000, 2000]
    while any(p < len(w) for p, w in zip(pos, waves)):
        for i, w in enumerate(waves):
            if pos[i] < len(w):
                srv.feed(slots[i], w[pos[i]: pos[i] + sizes[i]])
                pos[i] += sizes[i]
        srv.step()
    out = []
    for s in slots:
        srv.input_finished(s)
        srv.drain(s)
        assert srv.finished(s)
    for s in slots:
        out.append(srv.best_path(s))
        srv.close(s)
    return out


def _reuse(srv, waves):
    out = []
    for wave in waves:
        s = srv.open()
        srv.feed(s, wave)
        srv.input_finished(s)
        srv.drain(s)
        out.append(srv.best_path(s))
        srv.close(s)
    return out


def _staggered(srv, waves):
    w1, w2 = waves
    s1 = srv.open()
    srv.feed(s1, w1[:10000])
    srv.step()
    srv.step()
    s2 = srv.open()                    # opens mid-flight of s1
    srv.feed(s2, w2)
    srv.input_finished(s2)
    srv.feed(s1, w1[10000:])
    srv.input_finished(s1)
    srv.drain(s2)
    srv.drain(s1)
    out = [srv.best_path(s1), srv.best_path(s2)]
    srv.close(s1)
    srv.close(s2)
    return out


def _waves(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(L).astype(np.float32) * 4000 for L in lengths]


@pytest.mark.parametrize("scenario,seed,lengths", [
    (_mixed, 21, (9000, 17000, 30000, 12345)),
    (_reuse, 31, (11000, 11000)),
    (_staggered, 41, (20000, 8000)),
], ids=["mixed_lengths", "slot_reuse", "staggered_open_close"])
def test_server_matches_jax_and_offline(fx, scenario, seed, lengths):
    waves = _waves(seed, lengths)
    want = scenario(fx["jsrv"], waves)
    got = scenario(fx["srv"], waves)
    for i, (g, w, wave) in enumerate(zip(got, want, waves)):
        _same(g, w, f"stream {i} vs the JAX server")
        _same(g, _offline(fx, wave), f"stream {i} vs the offline decode")


def test_eps_rounds_and_start_closure_match_jax():
    """Unfolded eps arcs: one eps round per frame (R = 2) and a start-state
    closure whose records best_path walks on the host."""
    fx = _build(fold_eps=False)
    assert fx["srv"].R == 2 and fx["srv"]._init_records
    waves = _waves(31, (11000, 9000))
    want = _reuse(fx["jsrv"], waves)
    got = _reuse(fx["srv"], waves)
    for i, (g, w, wave) in enumerate(zip(got, want, waves)):
        _same(g, w, f"stream {i} vs the JAX server")
        _same(g, _offline(fx, wave), f"stream {i} vs the offline decode")


def _near_capacity(make, wave, extra):
    """One stream decoded up to t_max beside an in-use idle slot, then two
    more steps that only the idle slot takes part in."""
    srv = make()
    s_long, s_idle = srv.open(), srv.open()
    srv.feed(s_long, wave)
    srv.input_finished(s_long)
    srv.drain(s_long)
    srv.feed(s_idle, extra)
    srv.step()
    srv.step()
    return srv.best_path(s_long)


def test_near_capacity_with_idle_slot(fx):
    rng = np.random.default_rng(41)
    wave = rng.standard_normal(40000).astype(np.float32) * 4000
    extra = rng.standard_normal(6000).astype(np.float32) * 4000
    total = fbank(torch.from_numpy(wave), fx["fb"]).shape[0]
    kw = dict(n_streams=2, chunk_samples=2560, t_max=total)
    want = _near_capacity(
        lambda: JServer(fx["jam"], fx["jdec"], fx["jfb"], **kw), wave, extra)
    got = _near_capacity(
        lambda: FusedStreamingServer(fx["am"], fx["dec"], fx["fb"], **kw),
        wave, extra)
    _same(got, want, "vs the JAX server")
    _same(got, _offline(fx, wave), "vs the offline decode")


def test_runs_on_its_decoders_device(fx):
    srv = fx["srv"]
    assert srv.device == fx["dec"].device == torch.device("cpu")
    assert all(t.device == srv.device for t in
               (srv._buf, srv._fifo, srv._st, srv._arena, srv._ilar))


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_unported_options_raise(fx, kw):
    """A mesh that is not a parallel.mesh DeviceMesh is refused (the
    sharded server: tests/test_torch_parallel_serving.py)."""
    with pytest.raises(TypeError):
        FusedStreamingServer(fx["am"], fx["dec"], fx["fb"], **SERVE, **kw)


def test_mesh_axis_keyword_is_accepted(fx):
    """JAX's server takes `mesh_axis`; with mesh=None the port's server
    takes it too and serves as without it."""
    srv = FusedStreamingServer(fx["am"], fx["dec"], fx["fb"], **SERVE,
                               mesh=None, mesh_axis="data")
    wave = _waves(51, (9000,))[0]
    (got,) = _reuse(srv, [wave])
    _same(got, _offline(fx, wave), "mesh_axis server vs the offline decode")


def _close_paths(got, want, what):
    """The same (words, tids) paths, each cost within 1e-2."""
    assert (got is None) == (want is None), what
    if want is None:
        return
    pg = {(w, t): c for (w, t, c) in got.paths(max_paths=100000)}
    pw = {(w, t): c for (w, t, c) in want.paths(max_paths=100000)}
    assert sorted(pg) == sorted(pw), what
    assert max(abs(pg[k] - pw[k]) for k in pw) < 1e-2, what


def _lattice_session(srv, waves):
    """Feed each wave whole into its own slot, drain, and take the
    lattices (test_fused_serving.py's test_serving_get_lattice)."""
    slots = []
    for w in waves:
        s = srv.open()
        srv.feed(s, w)
        srv.input_finished(s)
        slots.append(s)
    for s in slots:
        srv.drain(s)
    out = [srv.get_lattice(s, 6.0) for s in slots]
    for s in slots:
        srv.close(s)
    return out


def test_get_lattice_matches_jax_and_offline(fx):
    """keep_loglikes keeps each stream's unscaled loglikes on the device;
    get_lattice over them equals JAX's server and the port's offline
    latgen of the same audio. A server without the ring refuses."""
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.generate import decode_to_lattices
    kw = dict(n_streams=2, chunk_samples=2560, t_max=256, keep_loglikes=True)
    rng = np.random.default_rng(51)
    waves = [rng.standard_normal(L).astype(np.float32) * 4000
             for L in (12000, 9000)]
    want = _lattice_session(JServer(fx["jam"], fx["jdec"], fx["jfb"], **kw),
                            waves)
    srv = FusedStreamingServer(fx["am"], fx["dec"], fx["fb"], **kw)
    got = _lattice_session(srv, waves)
    assert srv._llar.shape == (2, 256 + srv.ndmax, 16)
    for i, (g, w, wave) in enumerate(zip(got, want, waves)):
        assert g is not None
        _close_paths(g, w, f"stream {i} vs the JAX server")
        feats = fbank(torch.from_numpy(wave), fx["fb"])
        off = decode_to_lattices(fx["dec"], fx["am"].loglikes(feats[None]),
                                 np.array([feats.shape[0]], np.int32), 6.0)[0]
        _close_paths(g, off, f"stream {i} vs the offline latgen")
        assert lattice_best_path(g)[:2] == lattice_best_path(w)[:2]
    with pytest.raises(ValueError, match="keep_loglikes"):
        fx["srv"].get_lattice(0)
