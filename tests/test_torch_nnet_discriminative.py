"""Port parity: sequence-discriminative nnet training
(kaldi_tpu_torch.nnet.discriminative) against kaldi_tpu's, on the CPU.

The egs are tests/test_discriminative.py's: training utterances of the
yesno system (`test_torch_lat_posteriors.build_system`) with their
features edge-padded by the TDNN's context, the GMM's numerator
alignment and the denominator lattices (JAX's, carried across by
`params.lattice_from_jax`). The TDNN is small (39 -> 32 relu, splice
(-2..2), (-1, 1), (0,)), drawn by JAX's init with a random final layer
(JAX's init zeroes it, which makes every loglike equal).

- `compute_discriminative_post` from the same loglikes: the dense signed
  gradient and the objective equal JAX's exactly (host code) for MMI,
  sMBR and MPFE.
- One SGD step of the surrogate loss from the same params, features and
  posteriors: the params within 1e-5 relative of JAX's (an f32 forward
  and backward in each package).
- Two epochs over the egs, each package rescoring with its own
  loglikes: the objective history within 1e-4 of JAX's (the f32
  loglikes differ in their last bits and move the lattice posteriors a
  little; observed under 1e-9).
"""

import copy

import jax
import numpy as np
import pytest

from kaldi_tpu.decoder.graph_pack import pack_graphs as jpack_graphs
from kaldi_tpu.decoder.viterbi import viterbi_align as jviterbi_align
from kaldi_tpu.fst.graph import TrainingGraphCompiler as JCompiler
from kaldi_tpu.nnet import discriminative as jdisc
from kaldi_tpu.nnet.am_nnet import AmNnet as JAmNnet
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu_torch.nnet import discriminative as tdisc
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.params import (lattice_from_jax, params_to_jax,
                                    tdnn_params_from_jax)
from test_torch_lat_posteriors import build_system


@pytest.fixture(scope="module")
def system():
    """The yesno system, its lattices the port's (JAX's copies of them for
    JAX's side)."""
    return build_system(jax_decode=False)

CFG = dict(feat_dim=39, hidden_dim=32, pnorm_output_dim=8,
           nonlinearity="relu", splice_indexes=((-2, -1, 0, 1, 2), (-1, 1),
                                                (0,)))


@pytest.fixture(scope="module")
def nnet(system):
    """Both packages' AmNnet over the same params, and the egs."""
    s = system
    jm = s["jmodel"]
    P = jm.am.num_pdfs
    jcfg = JTdnnConfig(num_pdfs=P, **CFG)
    jmodel = JTdnn(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    params["final"]["w"] = rng.randn(*params["final"]["w"].shape).astype(
        np.float32) * 0.3
    params["final"]["b"] = rng.randn(P).astype(np.float32) * 0.1
    priors = rng.dirichlet(np.ones(P) * 5.0)
    jam = JAmNnet(jmodel, params, priors)
    tcfg = TdnnConfig(num_pdfs=P, **CFG)
    tam = AmNnet(Tdnn.from_params(tcfg, tdnn_params_from_jax(params)),
                 priors)
    comp = JCompiler(jm.lang, jm.trans_model, jm.ctx_dep, 1.0, 0.1)
    batch = jpack_graphs([comp.compile_transcript(list(w))
                          for _u, _f, w in s["train"]],
                         jm.trans_model.id2pdf_array)
    align = jviterbi_align(batch, s["ll"], s["nf"], 0.1)
    lc, rc = jcfg.left_context, jcfg.right_context
    egs = []
    for b, (lat, (_u, f, _w)) in enumerate(zip(s["jlats"], s["train"])):
        if lat is None or align[b] is None or len(egs) == 4:
            continue
        egs.append((np.pad(f, ((lc, rc), (0, 0)), mode="edge"),
                    np.asarray(align[b][0]), lat))
    return dict(jam=jam, tam=tam, egs=egs, lc=lc,
                sil={s["lang"].phones["SIL"]})


def _port_egs(egs):
    return [(f, ali, lattice_from_jax(lat)) for f, ali, lat in egs]


def _jax_egs(egs):
    return [(f, ali, copy.deepcopy(lat)) for f, ali, lat in egs]


@pytest.mark.parametrize("criterion", ["mmi", "smbr", "mpfe"])
def test_discriminative_post_equals_jax(system, nnet, criterion):
    """The dense signed gradient and objective of each eg, from the same
    loglikes (the port's), equal JAX's."""
    tm_j, tm_t = system["jmodel"].trans_model, system["model"].trans_model
    for f, ali, lat in nnet["egs"]:
        ll = nnet["tam"].loglikes_np(f[None])[0][nnet["lc"]:
                                                  nnet["lc"] + len(ali)]
        want = jdisc.compute_discriminative_post(
            nnet["jam"], copy.deepcopy(lat), ali, tm_j,
            jdisc.NnetDiscriminativeOpts(criterion=criterion), ll,
            nnet["sil"])
        got = tdisc.compute_discriminative_post(
            nnet["tam"], lattice_from_jax(lat), ali, tm_t,
            tdisc.NnetDiscriminativeOpts(criterion=criterion), ll,
            nnet["sil"])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        assert np.abs(got[0]).max() > 0


def test_one_smbr_step_equals_jax(system, nnet, monkeypatch):
    """One epoch over one eg with the dense posteriors fixed (the same in
    both packages): the params after one SGD step of the surrogate loss
    within 1e-5 relative of JAX's, and moved."""
    f, ali, lat = nnet["egs"][0]
    ll = nnet["tam"].loglikes_np(f[None])[0][nnet["lc"]:nnet["lc"] + len(ali)]
    post, objf = tdisc.compute_discriminative_post(
        nnet["tam"], lattice_from_jax(lat), ali, system["model"].trans_model,
        tdisc.NnetDiscriminativeOpts(), ll, nnet["sil"])
    for m in (jdisc, tdisc):
        monkeypatch.setattr(m, "compute_discriminative_post",
                            lambda *a, **k: (post, objf))
    opts = dict(criterion="smbr", learning_rate=3e-2, num_epochs=1)
    jp, _jh = jdisc.train_nnet_discriminative(
        nnet["jam"], system["jmodel"].trans_model, _jax_egs([nnet["egs"][0]]),
        jdisc.NnetDiscriminativeOpts(**opts), nnet["sil"])
    tp, _th = tdisc.train_nnet_discriminative(
        nnet["tam"], system["model"].trans_model,
        _port_egs([nnet["egs"][0]]), tdisc.NnetDiscriminativeOpts(**opts),
        nnet["sil"])
    want = params_to_jax(tdnn_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jp)))
    got = params_to_jax(tp)
    before = params_to_jax(nnet["tam"].model.params())
    for g, w, b in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(before)):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    assert any(not np.array_equal(np.asarray(g), np.asarray(b))
               for g, b in zip(jax.tree_util.tree_leaves(got),
                               jax.tree_util.tree_leaves(before)))


@pytest.mark.parametrize("criterion,boost", [("smbr", 0.0), ("mmi", 0.1)])
def test_two_epochs_equal_jax(system, nnet, criterion, boost):
    """Two epochs of sMBR (and of bMMI) over the egs in each package: the
    objective history within 1e-4 of JAX's and the params on the model's
    device; sMBR's expected accuracy per frame does not fall."""
    opts = dict(criterion=criterion, boost=boost, learning_rate=3e-4,
                num_epochs=2)
    _jp, jh = jdisc.train_nnet_discriminative(
        nnet["jam"], system["jmodel"].trans_model, _jax_egs(nnet["egs"]),
        jdisc.NnetDiscriminativeOpts(**opts), nnet["sil"])
    stats: list = []
    tp, th = tdisc.train_nnet_discriminative(
        nnet["tam"], system["model"].trans_model, _port_egs(nnet["egs"]),
        tdisc.NnetDiscriminativeOpts(**opts), nnet["sil"], iter_stats=stats)
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-4)
    assert all(v.device.type == "cpu" for v in tp.values())
    assert [st["iter"] for st in stats] == [0, 1]
    assert all(k in stats[0] for k in ("loglikes", "post", "step"))
    if criterion == "smbr":
        assert th[-1] >= th[0] - 1e-3
