"""kaldi_tpu_torch.steps.sgmm_steps against kaldi_tpu.steps.sgmm_steps on
the CPU, on tests/test_sgmm.py's yesno corpora.

- `SgmmAm` serves JAX's f32 loglikes (within one f32 rounding of the f64
  values they are cast from).
- From the same UBM (JAX's host `train_diag_ubm` / `train_full_ubm` of the
  port's alignments, carried across) JAX's `train_sgmm2` and the port's
  give the same model at 1e-9 of each parameter and the same loglikes
  over three iterations, a substate split between them included.
- The port's whole yesno runs (chip_smoke.sgmm_yesno_system) meet
  PARITY.md:36 (RandomState 13) and :37 (21, bMMI), as JAX's slow tests
  assert them. JAX's whole slow runs carry `slow` here too.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.sgmm import AmSgmm2 as JAmSgmm2
from kaldi_tpu.sgmm import Sgmm2Accs as JSgmm2Accs
from kaldi_tpu.sgmm import train_sgmm2 as jtrain
from kaldi_tpu.steps import sgmm_steps as jsteps
from kaldi_tpu.steps.ubm import (DiagUbmTrainOpts as JDiagOpts,
                                 FullUbmTrainOpts as JFullOpts,
                                 train_diag_ubm as jdiag,
                                 train_full_ubm as jfull)

from kaldi_tpu_torch.params import sgmm2_from_jax
from kaldi_tpu_torch.sgmm import Sgmm2Accs, train_sgmm2
from kaldi_tpu_torch.sgmm.estimate import v_system
from kaldi_tpu_torch.steps import sgmm_steps as tsteps
from kaldi_tpu_torch.steps.tdnn import align_with_gmm


@pytest.fixture(scope="module")
def yesno13():
    return cs.sgmm_yesno_system(13, "cpu")


def _jax_init(r):
    """JAX's UBMs and init model from the port's alignments of the
    system's training set (train_sgmm2_system's first stages)."""
    aligned = align_with_gmm(r["gmm"], r["train"])
    pooled = np.concatenate([f for f, _p in aligned])
    dubm = jdiag(pooled.astype(np.float64), JDiagOpts(num_gauss=8,
                                                      num_iters=3))
    fubm = jfull(dubm, pooled, JFullOpts(num_iters=2))
    post = [[(int(p), 1.0)] for _f, pdfs in aligned for p in pdfs]
    return JAmSgmm2(fubm, num_states=r["gmm"].am.num_pdfs, phn_dim=8), \
        pooled, post


def _jax_v_systems(jm, ja):
    """JAX's v update's systems (kaldi_tpu/sgmm/estimate.py:121-134), each
    substate's (lhs, rhs), flat in the port's order."""
    lhs, rhs = [], []
    for j in range(jm.num_states):
        for m in range(len(jm.c[j])):
            gam = ja.gamma[j][m]
            g_tot = gam.sum()
            v = jm.v[j][m]
            logw = jm.w @ v
            w_cur = np.exp(logw - np.log(np.exp(logw - logw.max()).sum())
                           - logw.max())
            Hsum = np.einsum("i,ist->st", gam, jm.H)
            g_w = jm.w.T @ (gam - g_tot * w_cur)
            a = np.maximum(gam, g_tot * w_cur)
            H_w = np.einsum("i,is,it->st", a, jm.w, jm.w)
            lhs.append(Hsum + H_w + 1e-6 * np.eye(len(v)))
            rhs.append(ja.y[j][m] + H_w @ v + g_w)
    return np.stack(lhs), np.stack(rhs)


def test_train_sgmm2_equals_jax(yesno13):
    """Two iterations ("vc", "Mc"), a split to 2 substates per state, then
    one more ("vc"): the same loglikes (1e-9) and the same model (v by its
    solves' backward error after the split). The split
    takes JAX's state occupancies on both sides: with a hard alignment they
    are frame counts, and two states of equal count are a tie that the
    occupancies' last bit breaks (in JAX as in the port)."""
    jm, x, post = _jax_init(yesno13)
    tm = sgmm2_from_jax(jm, "cpu")
    jm, jl = jtrain(jm, x, post, num_iters=2, num_gselect=8)
    stats: list = []
    tm, tl = train_sgmm2(tm, x, post, num_iters=2, num_gselect=8,
                         iter_stats=stats)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert [s["flags"] for s in stats] == ["vc", "Mc"]
    ja = JSgmm2Accs(jm)
    ja.accumulate(jm, x, post, 8)
    S = 2 * jm.num_states
    jm.split_substates(S, state_occs=ja.state_occs())
    tm.split_substates(S, state_occs=ja.state_occs())
    ta = Sgmm2Accs(tm)
    ta.accumulate(tm, x, post, 8)
    lhs, rhs, live = (a.numpy() for a in v_system(tm, ta))
    ja = JSgmm2Accs(jm)
    ja.accumulate(jm, x, post, 8)
    jlhs, jrhs = _jax_v_systems(jm, ja)
    assert np.abs(lhs - jlhs).max() <= 1e-9 * np.abs(jlhs).max()
    assert np.abs(rhs - jrhs).max() <= 1e-9 * np.abs(jrhs).max()
    jm, jl = jtrain(jm, x, post, num_iters=1, num_gselect=8)
    tm, tl = train_sgmm2(tm, x, post, num_iters=1, num_gselect=8)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert int(tm.offsets[-1]) == sum(len(c) for c in jm.c) == S
    # a split leaves substates of little occupancy whose v systems are
    # nearly singular (condition numbers up to 1e13): v is held by each
    # side's backward error in its own system, the systems at 1e-9, the
    # other parameters at 1e-9
    V = np.concatenate([np.stack(v) for v in jm.v])
    for v, (a, b) in ((tm.V.numpy(), (lhs, rhs)), (V, (jlhs, jrhs))):
        be = cs.backward_error(np.transpose(a[live], (0, 2, 1)),
                               v[live][:, None, :], b[live][:, None, :])
        assert be.max() <= cs.backward_bound(8, 1)
    for got, want in ((tm.c, np.concatenate(jm.c)), (tm.M, jm.M),
                      (tm.w, jm.w), (tm.Sigma_inv, jm.Sigma_inv)):
        got = got.numpy()
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_sgmm_am_loglikes_equal_jax(yesno13):
    jm, _x, _p = _jax_init(yesno13)
    test = yesno13["train"][:3]
    fb, _nf = cs.pad_batch([f for _u, f, _w in test])
    want = jsteps.SgmmAm(jm, 8).loglikes_np(fb, 0.5)
    tam = tsteps.SgmmAm(sgmm2_from_jax(jm, "cpu"), 8)
    got = tam.loglikes(fb, 0.5)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert tam.num_pdfs == jm.num_states and tam.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -23, atol=0)
    np.testing.assert_array_equal(tam.loglikes_np(fb, 0.5), got.numpy())


def test_system_meets_parity_36(yesno13):
    """PARITY.md:36 on the port's own run: SGMM <= GMM + 5 and < 20, the
    loglike rising (test_sgmm2_asr_decode's assertions)."""
    check = cs._Limits()
    cs.check_sgmm_yesno(check, "yesno 13", yesno13)
    assert check.failed == []
    assert yesno13["sgmm"].sgmm.num_gauss == 8
    assert yesno13["sgmm"].sgmm.phn_dim == 8


def test_bmmi_meets_parity_37():
    """PARITY.md:37 on the port's own run: the bMMI objective does not fall
    and the WER does not rise over the ML SGMM (test_sgmm2_bmmi_e2e's
    assertions)."""
    r = cs.sgmm_yesno_system(21, "cpu")
    check = cs._Limits()
    cs.check_sgmm_yesno(check, "yesno 21", r)
    assert check.failed == [] and len(r["objs"]) == 3


def test_system_stage_stats(yesno13):
    st: dict = {}
    its: list = []
    _am, likes = tsteps.train_sgmm2_system(
        yesno13["gmm"], yesno13["train"][:6], tsteps.SgmmTrainOpts(
            ubm_gauss=4, phn_dim=4, num_iters=2), iter_stats=its,
        stage_secs=st)
    assert set(st) == {"align", "diag_ubm", "full_ubm", "sgmm"}
    assert [s["iter"] for s in its] == [0, 1] and len(likes) == 2
    assert all(s["accumulate"] >= 0 and s["update"] >= 0 for s in its)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [13, 21])
def test_jax_whole_runs_beside_the_ports(seed):
    """JAX's own slow runs on the port's features (its UBMs, SGMM and bMMI
    in host numpy): their results beside the port's, each held to its
    PARITY.md row."""
    from kaldi_tpu.decoder.beam_search import BeamSearchDecoder, \
        BeamSearchOpts
    from kaldi_tpu.decoder.graph_pack import pack_graph
    from kaldi_tpu.fst.graph import make_hclg
    from kaldi_tpu.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu.steps.mono import MonoTrainOpts, train_mono
    r = cs.sgmm_yesno_system(seed, "cpu")
    lang = prepare_lang(Lexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                        num_sil_states=3)
    train = r["train"]
    gmm = train_mono(lang, train, MonoTrainOpts(**cs.SGMM_YESNO_MONO))
    cfg = cs.SGMM_YESNO[seed]
    am, likes = jsteps.train_sgmm2_system(gmm, train, jsteps.SgmmTrainOpts(
        ubm_gauss=8, phn_dim=8, num_iters=cfg["sgmm_iters"]))
    assert likes[-1] > likes[0]
    graph = make_hclg(lang, arpa_to_g(ArpaLm.parse(cs.YESNO_ARPA),
                                      lang.words), gmm.trans_model,
                      gmm.ctx_dep, self_loop_scale=0.1)
    if cfg["bmmi"]:
        _am2, objs = jsteps.train_sgmm2_bmmi(gmm, am, graph, train,
                                             jsteps.SgmmMmiOpts(num_iters=2))
        assert objs[-1] >= objs[0] - 1e-3
    dec = BeamSearchDecoder(pack_graph(graph.fst,
                                       gmm.trans_model.id2pdf_array),
                            BeamSearchOpts(beam=16.0, max_active=256,
                                           acoustic_scale=0.1))
    assert dec is not None
    check = cs._Limits()
    cs.check_sgmm_yesno(check, f"port {seed}", r)
    assert check.failed == []
