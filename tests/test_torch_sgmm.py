"""kaldi_tpu_torch.sgmm against kaldi_tpu.sgmm on the CPU.

The same inputs (tests/test_sgmm.py's three-class data from
RandomState(0), its 4-gaussian UBM and AmSgmm2(phn_dim=5, spk_dim=2,
seed=1), split to 6 substates) go through JAX's SGMM2 and the port's, the
JAX model carried across by `params.sgmm2_from_jax`. Everything is f64 on
both sides, so each result is held to 1e-9 of its own magnitude (the
port's normaliser form and batched GEMMs differ from JAX's direct
quadratic forms only by rounding); gselect is compared as sets; the
fMLLR line search by its auxiliary. Then test_sgmm.py's contracts are
restated against the port, and chip_smoke's phase 27 helpers run with
the CPU on both sides.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import kaldi_tpu.sgmm as js
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiagGmm
from kaldi_tpu.gmm.estimation import AccumDiagGmm as JAcc
from kaldi_tpu.gmm.estimation import mle_diag_gmm_update as jmle
from kaldi_tpu.gmm.full_gmm import FullGmm as JFullGmm
from kaldi_tpu.sgmm import ebw as jebw
from kaldi_tpu.sgmm import fmllr as jfmllr
from kaldi_tpu.sgmm import gpost as jgpost
from kaldi_tpu.sgmm import prexform as jpx

import kaldi_tpu_torch.sgmm as ts
from kaldi_tpu_torch.gmm.full_gmm import FullGmm
from kaldi_tpu_torch.params import sgmm2_from_jax, sgmm2_to_lists
from kaldi_tpu_torch.sgmm import ebw as tebw
from kaldi_tpu_torch.sgmm import fmllr as tfmllr
from kaldi_tpu_torch.sgmm import gpost as tgpost
from kaldi_tpu_torch.sgmm import prexform as tpx

REL = 1e-9


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _data():
    rng = np.random.RandomState(0)
    mu = rng.randn(3, 4) * 3.0
    feats = np.concatenate([mu[j] + rng.randn(150, 4) for j in range(3)])
    post = [[(j, 1.0)] for j in range(3) for _ in range(150)]
    return feats, post, mu


def _jax_model(split: int = 6, phn_dim: int = 5):
    feats, post, _mu = _data()
    ubm = JDiagGmm.from_stats(feats.mean(0), feats.var(0)).split(4)
    for _ in range(5):
        acc = JAcc(ubm.num_gauss, ubm.dim)
        acc.accumulate(ubm, feats.astype(np.float32))
        ubm = jmle(ubm, acc)
    fubm = JFullGmm.from_diag(ubm.weights, ubm.means, ubm.vars)
    m = js.AmSgmm2(fubm, num_states=3, phn_dim=phn_dim, spk_dim=2, seed=1)
    if split:
        m.split_substates(split)
    return m, fubm, feats, post


@pytest.fixture
def pair():
    jm, _f, feats, post = _jax_model()
    return jm, sgmm2_from_jax(jm, "cpu"), feats, post


def _flat(jm) -> tuple:
    return (np.concatenate([np.stack(v) for v in jm.v]),
            np.concatenate(jm.c))


def _assert_model_equal(tm, jm, rel=REL):
    V, c = _flat(jm)
    assert list(tm.offsets) == list(np.cumsum([0] + [len(x) for x in jm.c]))
    for got, want in ((tm.V, V), (tm.c, c), (tm.M, jm.M), (tm.w, jm.w),
                      (tm.Sigma_inv, jm.Sigma_inv), (tm.gconst, jm.gconst),
                      (tm.SinvM, jm.SinvM), (tm.H, jm.H)):
        assert _rel(got.numpy(), want) <= rel


def test_init_equals_jax():
    jm, fubm, _x, _p = _jax_model(split=0)
    tm = ts.AmSgmm2(FullGmm(fubm.weights, fubm.means, fubm.covars), 3, 5,
                    spk_dim=2, seed=1, device="cpu")
    _assert_model_equal(tm, jm, rel=1e-12)
    assert _rel(tm.N.numpy(), jm.N) == 0.0


@pytest.mark.parametrize("with_spk", [False, True])
def test_loglikes_matrix_equals_jax(pair, with_spk):
    jm, tm, feats, post = pair
    spk = js.estimate_speaker_vector(jm, feats[:100], post[:100], 3) \
        if with_spk else None
    tspk = ts.Sgmm2SpeakerState(torch.as_tensor(spk.v)) if with_spk else None
    got = tm.loglikes_matrix(feats, 3, tspk)
    assert got.dtype == torch.float64 and got.shape == (len(feats), 3)
    assert _rel(got.numpy(), jm.loglikes_matrix(feats, 3, spk)) <= REL


def test_norm_set_ids_equal_jax(pair):
    jm, _tm, feats, _p = pair
    jm.norm_set_ids = np.array([0, 0, 1, 1])
    tm = sgmm2_from_jax(jm, "cpu")
    assert _rel(tm.loglikes_matrix(feats, 4).numpy(),
                jm.loglikes_matrix(feats, 4)) <= REL


@pytest.mark.parametrize("k", [1, 3, 4])
def test_gselect_sets_equal_jax(pair, k):
    jm, tm, feats, _p = pair
    got = tm.gselect(feats, k).numpy()
    want = jm.gselect(feats, k)
    assert all(set(a) == set(b) for a, b in zip(got, want))


def test_component_posteriors_equal_jax(pair):
    jm, tm, feats, _p = pair
    gsel = jm.gselect(feats, 3)
    for t in (0, 170, 449):
        for j in range(3):
            pj, lj = jm.component_posteriors(j, feats[t], gsel[t])
            pt, lt = tm.component_posteriors(j, feats[t], gsel[t])
            assert _rel(pt.numpy(), pj) <= REL
            assert abs(float(lt) - lj) <= REL * abs(lj)
            assert abs(float(tm.log_likelihood(j, feats[t], gsel[t]))
                       - jm.log_likelihood(j, feats[t], gsel[t])) \
                <= REL * abs(lj)


@pytest.mark.parametrize("with_spk", [False, True])
def test_accumulate_equals_jax(pair, with_spk):
    """gamma, y, Y, Q, S_centered (f64 GEMMs over dense posteriors) and the
    totals: 1e-9 of each statistic's largest entry; soft state posteriors
    (two states per frame) included."""
    jm, tm, feats, post = pair
    spk = js.estimate_speaker_vector(jm, feats, post, 3) if with_spk \
        else None
    tspk = ts.Sgmm2SpeakerState(torch.as_tensor(spk.v)) if with_spk else None
    soft = [[(j, 0.75), ((j + 1) % 3, 0.25)] for [(j, _w)] in post]
    for sp in (post, soft):
        ja, ta = js.Sgmm2Accs(jm), ts.Sgmm2Accs(tm)
        ja.accumulate(jm, feats, sp, 3, spk)
        ta.accumulate(tm, feats, sp, 3, tspk)
        assert abs(ta.tot_like - ja.tot_like) <= REL * abs(ja.tot_like)
        assert ta.tot_frames == pytest.approx(ja.tot_frames, rel=1e-12)
        assert _rel(ta.gamma.numpy(), np.concatenate(ja.gamma)) <= REL
        assert _rel(ta.y.numpy(), np.concatenate(ja.y)) <= REL
        for f in ("Y", "Q", "S_centered"):
            assert _rel(getattr(ta, f).numpy(), getattr(ja, f)) <= REL, f
        np.testing.assert_allclose(ta.state_occs(), ja.state_occs(),
                                   rtol=1e-12)


@pytest.mark.parametrize("flag", ["v", "M", "w", "S", "c"])
def test_update_flag_equals_jax(pair, flag):
    """One M-step of each flag from statistics accumulated by each package
    on the same model: 1e-9 of each parameter's magnitude."""
    jm, tm, feats, post = pair
    ja, ta = js.Sgmm2Accs(jm), ts.Sgmm2Accs(tm)
    ja.accumulate(jm, feats, post, 3)
    ta.accumulate(tm, feats, post, 3)
    js.update_sgmm2(jm, ja, flag)
    ts.update_sgmm2(tm, ta, flag)
    _assert_model_equal(tm, jm)


def test_speaker_vector_equals_jax(pair):
    jm, tm, feats, post = pair
    off = np.random.RandomState(9).randn(4) * 0.8
    want = js.estimate_speaker_vector(jm, feats[:100] + off, post[:100], 3)
    got = ts.estimate_speaker_vector(tm, feats[:100] + off, post[:100], 3)
    assert _rel(got.v.numpy(), want.v) <= REL


def test_split_substates_equals_jax():
    """JAX's RNG order and substate layout, with state occupancies."""
    jm, _f, feats, post = _jax_model(split=0)
    tm = sgmm2_from_jax(jm, "cpu")
    occ = np.array([3.0, 1.0, 2.0])
    jm.split_substates(11, state_occs=occ, seed=4)
    tm.split_substates(11, state_occs=occ, seed=4)
    _assert_model_equal(tm, jm, rel=1e-15)
    V, c = sgmm2_to_lists(tm)
    assert [len(x) for x in V] == [len(x) for x in jm.v]


def test_dimension_surgery_equals_jax():
    jm, _f, feats, _p = _jax_model(phn_dim=3)
    tm = sgmm2_from_jax(jm, "cpu")
    for m in (jm, tm):
        m.increase_phn_dim(5, seed=2)
        m.increase_spk_dim(3, seed=3)
    _assert_model_equal(tm, jm)
    assert _rel(tm.N.numpy(), jm.N) == 0.0
    assert _rel(tm.loglikes_matrix(feats, 3).numpy(),
                jm.loglikes_matrix(feats, 3)) <= REL
    with pytest.raises(ValueError):
        tm.increase_phn_dim(6)
    tm.remove_speaker_space()
    assert tm.spk_dim == 0


def test_gpost_and_accumulate_gpost_equal_jax(pair, tmp_path):
    jm, tm, feats, post = pair
    want = jgpost.compute_gpost(jm, feats[:60], post[:60], 3)
    got = tgpost.compute_gpost(tm, feats[:60], post[:60], 3)
    for fg, fw in zip(got, want):
        for (jg, gg, pg), (jw, gw, pw) in zip(fg, fw):
            assert jg == jw and set(gg) == set(gw) and pg.dtype == np.float32
            np.testing.assert_allclose(pg[:, np.argsort(gg)],
                                       pw[:, np.argsort(gw)], rtol=1e-6,
                                       atol=1e-12)
    ja, ta = js.Sgmm2Accs(jm), ts.Sgmm2Accs(tm)
    ja.accumulate_gpost(jm, feats[:60], want)
    ta.accumulate_gpost(tm, feats[:60], want)
    assert ta.tot_frames == pytest.approx(ja.tot_frames, rel=1e-12)
    for f in ("Y", "Q", "S_centered"):
        assert _rel(getattr(ta, f).numpy(), getattr(ja, f)) <= REL
    path = str(tmp_path / "g.pkl")
    tgpost.write_gpost_ark(path, {"u": got})
    (utt, back), = tgpost.read_gpost_ark(path)
    assert utt == "u" and len(back) == len(got)


def _fmllr_pair(jm, tm, feats, post):
    bad = feats @ (np.eye(4) * 0.7).T + 0.8
    fa, ta = jfmllr.FmllrSgmm2Accs(jm), tfmllr.FmllrSgmm2Accs(tm)
    fa.accumulate(jm, bad, post)
    ta.accumulate(tm, bad, post)
    return fa, ta


def test_sgmm_fmllr_stats_and_gradient_equal_jax(pair):
    jm, tm, feats, post = pair
    fa, ta = _fmllr_pair(jm, tm, feats, post)
    assert ta.beta == pytest.approx(fa.beta, rel=1e-12)
    assert _rel(ta.K.numpy(), fa.K) <= REL
    assert _rel(ta.G.numpy(), fa.G) <= REL
    assert _rel(tpx.fmllr_grad_at_identity(ta, tm).numpy(),
                jpx.fmllr_grad_at_identity(fa, jm)) <= REL


def test_sgmm_fmllr_estimate_by_its_auxiliary(pair):
    """The backtracking line search follows rounding near the optimum (a
    `val > cur` branch), so the whole estimate is held by its auxiliary
    improvement (1e-9 relative), W within 1e-6."""
    jm, tm, feats, post = pair
    fa, ta = _fmllr_pair(jm, tm, feats, post)
    Wj, ij = jfmllr.estimate_sgmm2_fmllr(fa, jm)
    Wt, it = tfmllr.estimate_sgmm2_fmllr(ta, tm)
    assert abs(it - ij) <= REL * abs(ij)
    assert _rel(Wt.numpy(), Wj) <= 1e-6
    np.testing.assert_allclose(
        tfmllr.apply_fmllr(Wt, feats[:5]).numpy(),
        jfmllr.apply_fmllr(Wj, feats[:5]), rtol=1e-5)
    W0, i0 = tfmllr.estimate_sgmm2_fmllr(tfmllr.FmllrSgmm2Accs(tm), tm)
    np.testing.assert_array_equal(W0[:, :4].numpy(), np.eye(4))
    assert i0 == 0.0


def test_prexform_distances_and_basis_equal_jax(pair):
    jm, tm, feats, post = pair
    occ = np.array([150.0, 120.0, 180.0])
    for got, want in zip(tpx.compute_prexform(tm, occ),
                         jpx.compute_prexform(jm, occ)):
        assert _rel(got.numpy(), want) <= REL
    assert _rel(tpx.state_distances(tm, occ).numpy(),
                jpx.state_distances(jm, occ)) <= REL
    fa, ta = _fmllr_pair(jm, tm, feats, post)
    fb, tb = _fmllr_pair(jm, tm, feats[::-1] * 1.1, post[::-1])
    Bj = jpx.estimate_fmllr_basis(jm, [fa, fb], 2)
    Bt = tpx.estimate_fmllr_basis(tm, [ta, tb], 2).numpy()
    assert Bt.shape == Bj.shape == (2, 4, 5)
    # eigenvectors of distinct eigenvalues agree up to sign
    for a, b in zip(Bt, Bj):
        assert abs(abs((a * b).sum()) - 1.0) <= 1e-9


def _ebw_stats(jm, tm, feats, post):
    for f in ("vc", "Mc"):
        a = js.Sgmm2Accs(jm)
        a.accumulate(jm, feats, post, 4)
        js.update_sgmm2(jm, a, f)
    tm = sgmm2_from_jax(jm, "cpu")
    ll = jm.loglikes_matrix(feats, 4)
    p = np.exp(ll - ll.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    den_post = [[(j, float(p[t, j])) for j in range(3) if p[t, j] > 1e-6]
                for t in range(len(feats))]
    out = {}
    for name, m, mod in (("j", jm, js), ("t", tm, ts)):
        num, den = mod.Sgmm2Accs(m), mod.Sgmm2Accs(m)
        num.accumulate(m, feats, post, 4)
        den.accumulate(m, feats, den_post, 4)
        out[name] = (m, num, den)
    return out


@pytest.mark.parametrize("flag", ["v", "w", "c", "M", "S"])
def test_ebw_update_equals_jax(pair, flag):
    jm, tm, feats, post = pair
    s = _ebw_stats(jm, tm, feats, post)
    ij = jebw.update_sgmm2_ebw(*s["j"], jebw.EbwSgmm2Options(), flag)
    it = tebw.update_sgmm2_ebw(*s["t"], tebw.EbwSgmm2Options(), flag)
    _assert_model_equal(s["t"][0], s["j"][0])
    assert it.keys() == ij.keys()
    for k in ij:
        assert abs(it[k] - ij[k]) <= REL * max(abs(ij[k]), 1.0)


def test_batched_quadratic_solvers_equal_jax():
    """Well-posed, floored, fallback and all-negative problems, batched
    against JAX's per-problem solvers."""
    rng = np.random.RandomState(3)
    Qs, gs = [], []
    for kind in range(12):
        A = rng.randn(4, 4)
        Q = A @ A.T
        if kind % 4 == 1:
            Q = Q - 1.5 * np.eye(4)            # some negative eigenvalues
        elif kind % 4 == 2:
            Q = -Q                             # nothing positive
        elif kind % 4 == 3:
            w, V = np.linalg.eigh(Q)
            Q = (V * np.array([1e-9, 1e-3, 1.0, 2.0])) @ V.T
        Qs.append(Q)
        gs.append(rng.randn(4))
    d, im = tebw._solve_quadratic(torch.as_tensor(np.stack(Qs)),
                                  torch.as_tensor(np.stack(gs)))
    for b in range(12):
        dj, ij = jebw._solve_quadratic(Qs[b], gs[b])
        np.testing.assert_allclose(d[b].numpy(), dj, rtol=1e-9, atol=1e-12)
        assert abs(float(im[b]) - ij) <= 1e-9 * max(abs(ij), 1.0)
    L = rng.randn(12, 3, 4)
    d, im = tebw._solve_quadratic_matrix(torch.as_tensor(np.stack(Qs)),
                                         torch.as_tensor(L))
    for b in range(12):
        dj, ij = jebw._solve_quadratic_matrix(Qs[b], L[b])
        np.testing.assert_allclose(d[b].numpy(), dj, rtol=1e-9, atol=1e-12)
        assert abs(float(im[b]) - ij) <= 1e-9 * max(abs(ij), 1.0)


# ------------------------------------ test_sgmm.py's contracts on the port

def _port_setup():
    su = cs.sgmm_small_setup("cpu")
    return su["model"], su["feats"], su["post"]


def test_port_setup_equals_jax_setup():
    """chip_smoke.sgmm_small_setup builds test_sgmm.py's model (before its
    split, which JAX's fixture does not make) from the port's host UBM
    code."""
    jm, _f, feats, _p = _jax_model(split=6)
    tm, tfeats, _tp = _port_setup()
    np.testing.assert_array_equal(tfeats, feats)
    _assert_model_equal(tm, jm)


def test_em_improves_loglike():
    model, feats, post = _port_setup()
    likes = []
    for flags in ["vc", "Mc", "vwc", "Sc", "vc", "Mc"]:
        accs = ts.Sgmm2Accs(model)
        accs.accumulate(model, feats, post, num_gselect=4)
        likes.append(accs.tot_like / accs.tot_frames)
        model = ts.update_sgmm2(model, accs, update_flags=flags)
    accs = ts.Sgmm2Accs(model)
    accs.accumulate(model, feats, post, num_gselect=4)
    likes.append(accs.tot_like / accs.tot_frames)
    assert likes[-1] > likes[0] + 0.1, likes
    assert all(likes[k + 1] >= likes[k] - 0.1
               for k in range(len(likes) - 1)), likes


def test_classification_after_training():
    model, feats, post = _port_setup()
    for flags in ["vc", "Mc", "vwc"]:
        accs = ts.Sgmm2Accs(model)
        accs.accumulate(model, feats, post, num_gselect=4)
        model = ts.update_sgmm2(model, accs, update_flags=flags)
    _f, _p, mu = _data()
    eval_rng = np.random.RandomState(42)
    for j in range(3):
        x = mu[j] + eval_rng.randn(30, 4)
        ll = model.loglikes_matrix(x, num_gselect=4).numpy()
        assert int(np.argmax(ll.sum(axis=0))) == j


def test_substate_splitting():
    model, feats, post = _port_setup()
    n_before = int(model.offsets[-1])
    model.split_substates(n_before + 3)
    assert int(model.offsets[-1]) == n_before + 3
    c = model.c.numpy()
    for j in range(model.num_states):
        assert c[model.offsets[j]:model.offsets[j + 1]].sum() \
            == pytest.approx(1.0)
    accs = ts.Sgmm2Accs(model)
    accs.accumulate(model, feats, post, num_gselect=4)
    before = accs.tot_like / accs.tot_frames
    model2 = ts.update_sgmm2(model, accs, update_flags="vc")
    accs2 = ts.Sgmm2Accs(model2)
    accs2.accumulate(model2, feats, post, num_gselect=4)
    assert accs2.tot_like / accs2.tot_frames >= before - 0.05


def test_speaker_vector_adaptation():
    su = cs.sgmm_small_setup("cpu")
    model = su["model"]
    accs0 = ts.Sgmm2Accs(model)
    accs0.accumulate(model, su["spk_feats"], su["spk_post"], num_gselect=4)
    spk = ts.estimate_speaker_vector(model, su["spk_feats"], su["spk_post"],
                                     num_gselect=4)
    assert spk.v.shape == (2,)
    accs1 = ts.Sgmm2Accs(model)
    accs1.accumulate(model, su["spk_feats"], su["spk_post"], num_gselect=4,
                     spk=spk)
    assert accs1.tot_like / accs1.tot_frames \
        > accs0.tot_like / accs0.tot_frames


def test_sgmm2_fmllr_recovers_feature_transform():
    """test_sgmm.py's check on a model trained as its module fixture is by
    the tests before it (the EM schedule; JAX's own four updates there pass
    a tuple of flags and update nothing)."""
    su = cs.sgmm_small_setup("cpu", split=False)
    m, feats, post = su["model"], su["feats"], su["post"]
    for flags in ["vc", "Mc", "vwc", "Sc", "vc", "Mc"]:
        accs = ts.Sgmm2Accs(m)
        accs.accumulate(m, feats, post, num_gselect=4)
        m = ts.update_sgmm2(m, accs, flags)
    bad = feats @ (np.eye(4) * 0.7).T + 0.8

    def total_ll(x):
        ll = m.loglikes_matrix(x, 10).numpy()
        return sum(ll[t, j] for t, fr in enumerate(post) for j, _w in fr)

    fa = tfmllr.FmllrSgmm2Accs(m)
    fa.accumulate(m, bad, post)
    W, impr = tfmllr.estimate_sgmm2_fmllr(fa, m)
    assert impr > 0.0
    assert total_ll(tfmllr.apply_fmllr(W, bad).numpy()) \
        > total_ll(bad) + 0.2 * len(post)


def test_sgmm2_ebw_improves_mmi_objective():
    su = cs.sgmm_small_setup("cpu", split=False)
    m, feats, post = su["model"], su["feats"], su["post"]
    for flags in ("vc", "Mc"):
        accs = ts.Sgmm2Accs(m)
        accs.accumulate(m, feats, post, num_gselect=4)
        m = ts.update_sgmm2(m, accs, update_flags=flags)

    def objective(model):
        ll = model.loglikes_matrix(feats, 4).numpy()
        mx = ll.max(axis=1, keepdims=True)
        den_log = mx[:, 0] + np.log(np.exp(ll - mx).sum(axis=1))
        num_log = np.array([ll[t, post[t][0][0]] for t in range(len(feats))])
        p = np.exp(ll - mx)
        p /= p.sum(axis=1, keepdims=True)
        den_post = [[(j, float(p[t, j])) for j in range(3) if p[t, j] > 1e-6]
                    for t in range(len(feats))]
        num, den = ts.Sgmm2Accs(model), ts.Sgmm2Accs(model)
        num.accumulate(model, feats, post, num_gselect=4)
        den.accumulate(model, feats, den_post, num_gselect=4)
        return float((num_log - den_log).mean()), num, den

    obj0, num, den = objective(m)
    objs = [obj0]
    for _ in range(3):
        tebw.update_sgmm2_ebw(m, num, den, update_flags="vMwSc")
        obj, num, den = objective(m)
        objs.append(obj)
    assert objs[-1] > objs[0] + 1e-3, objs
    assert all(objs[k + 1] >= objs[k] - 1e-3 for k in range(3)), objs


# ----------------------------------------- chip_smoke's phase 27 helpers

def test_phase27_sgmm_checks_with_the_cpu_on_both_sides():
    """The card-vs-CPU helpers of phase 27 run with card="cpu": every
    ratio is 0 (identical arithmetic), so each check passes."""
    su = cs.sgmm_small_setup("cpu")
    m = su["model"]
    assert cs.sgmm_loglikes_card_vs_cpu(m, su["feats"], 3, card="cpu") == 0
    e = cs.sgmm_stats_card_vs_cpu(m, su["feats"], su["post"], 3, card="cpu")
    assert e["flips"] == e["unjustified"] == 0
    assert all(e[k] == 0.0 for k in ("gamma", "y", "Y", "Q", "S_centered",
                                      "tot_like"))
    up = cs.sgmm_update_card_vs_cpu(m, e["accs"], "vMwSc", card="cpu")
    assert set(up) == set("vMwSc") and max(up.values()) <= 1.0, up
    ex = cs.sgmm_extras_card_vs_cpu(su, card="cpu")
    assert max(ex.values()) <= 1.0, ex


def test_stats_bound_breaks_for_a_moved_model():
    """The accumulation bound binds: statistics of a model whose M moved by
    1e-6 (the terms change, not only the loglikes) exceed it."""
    su = cs.sgmm_small_setup("cpu")
    m = su["model"]

    class Moved:
        def __init__(self, model):
            self.model = model

        def to(self, _device):
            out = self.model.copy()
            out.M = out.M * (1.0 + 1e-6)
            out._update_derived()
            return out

    moved = m.copy()
    moved.to = Moved(m).to
    e = cs.sgmm_stats_card_vs_cpu(moved, su["feats"], su["post"], 3,
                                  card="cpu")
    assert max(e[k] for k in ("y", "Y", "S_centered")) > 1.0, e
