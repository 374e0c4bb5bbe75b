"""Port parity: the stream-sharded FusedStreamingServer against kaldi_tpu's.

test_torch_serving.py's setup (24-bin fbank, the 40-word HCLG, a relu
TDNN of width 64 over 16 pdfs with numpy-seeded weights and non-uniform
priors) on two gloo ranks with a (2, 1) mesh: 8 streams, 4 per rank, as
test_fused_serving.py:157-181 shards JAX's over the virtual devices. Both
ranks make the same calls and get the same slot ids from `open()`; every
stream's best path equals JAX's mesh server and the port's offline decode
on both ranks (the owner's answer is broadcast), and so do the lattices
(keep_loglikes) of a stream on each rank's device. The session then
closes two slots, one per rank, and reopens them with new audio
(`torch_serving_gang.session`).
"""

import numpy as np
import pytest
import torch

import jax

from kaldi_tpu.online.serving import FusedStreamingServer as JServer
from kaldi_tpu.parallel.mesh import make_mesh as j_make_mesh
from kaldi_tpu_torch.lat.generate import decode_to_lattices
from kaldi_tpu_torch.ops.features import fbank

import test_torch_serving as ts
import torch_serving_gang as sg
from torch_gang import run_gang


@pytest.fixture(scope="module")
def inputs():
    return {"waves": sg.waves(61, 8), "more": sg.waves(71, 2)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    script = ("import torch_serving_gang as sg\n"
              "from kaldi_tpu_torch.online.serving import FusedStreamingServer\n"
              "from kaldi_tpu_torch.parallel.mesh import make_mesh\n"
              "srv = FusedStreamingServer(*sg.port_parts(), **sg.SERVE,\n"
              "                           mesh=make_mesh(2, 1, device='cpu'))\n"
              "save(sg.session(srv, ARGS['waves'], ARGS['more']))\n")
    return run_gang(tmp_path_factory.mktemp("serving"), "serving", script, 2,
                    inputs)


@pytest.fixture(scope="module")
def jax_session(inputs):
    fx = ts._build(fold_eps=True)
    mesh = j_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    srv = JServer(fx["jam"], fx["jdec"], fx["jfb"], **sg.SERVE, mesh=mesh)
    return sg.session(srv, inputs["waves"], inputs["more"]), fx


def _offline(fx, wave):
    feats = fbank(torch.from_numpy(wave), fx["fb"])
    ll = fx["am"].loglikes(feats[None])
    return fx["dec"].decode(ll, np.array([feats.shape[0]], np.int32))[0], \
        decode_to_lattices(fx["dec"], ll, np.array([feats.shape[0]],
                                                   np.int32), 6.0)[0]


def _close_paths(got: dict, want: dict, what):
    assert sorted(got) == sorted(want), what
    assert max(abs(got[k] - want[k]) for k in want) < 1e-2, what


def test_ranks_share_the_bookkeeping(ranks, jax_session):
    """open() gives every rank the same slot ids, and JAX's."""
    want, _fx = jax_session
    for r in ranks:
        assert r["slots"] == ranks[0]["slots"] == want["slots"]
        assert r["reopened"] == ranks[0]["reopened"] == want["reopened"]
        assert sorted(r["reopened"]) == sorted(
            [r["slots"][0], r["slots"][7]])


def test_streams_match_jax_and_offline(ranks, jax_session, inputs):
    want, fx = jax_session
    offline = [_offline(fx, w)[0] for w in inputs["waves"]]
    again = [_offline(fx, w)[0] for w in inputs["more"]]
    for rank, r in enumerate(ranks):
        for i in range(8):
            ts._same(r["best"][i], want["best"][i], f"rank {rank} stream {i}"
                     " vs the JAX mesh server")
            ts._same(r["best"][i], offline[i], f"rank {rank} stream {i} vs "
                     "the offline decode")
            assert r["best"][i] == ranks[0]["best"][i]
        for i in range(2):
            ts._same(r["again"][i], want["again"][i], f"rank {rank} reopened "
                     f"{i} vs the JAX mesh server")
            ts._same(r["again"][i], again[i], f"rank {rank} reopened {i}")


def test_lattices_match_jax_and_offline(ranks, jax_session, inputs):
    want, fx = jax_session
    for rank, r in enumerate(ranks):
        for j, i in enumerate(sg.LATTICE_SLOTS):
            got = r["lats"][j]
            assert got is not None
            assert got == ranks[0]["lats"][j]
            _close_paths(got, want["lats"][j], (rank, i, "JAX"))
            off = _offline(fx, inputs["waves"][i])[1]
            _close_paths(got, {(w, t): c for (w, t, c)
                               in off.paths(max_paths=100000)},
                         (rank, i, "offline"))
