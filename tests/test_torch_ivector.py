"""Port parity: the speaker-recognition modules of kaldi_tpu_torch.ivector
against kaldi_tpu.ivector, and the full-covariance GMM's batch path, on
the CPU.

- VAD, the EER and PLDA (train, transform, llr, adapt, score_trials) are
  host copies: equal to JAX's within 1e-12 (PLDA's per-count inverse is
  the same inverse, taken once).
- The full GMM's batch path against JAX's numpy: the f64 loglikes (one
  GEMM over packed features) within 1e-9, cast to f32 within one f32
  rounding; the statistics from the same posteriors
  (`accumulate_posteriors_batch`) and `mle_full_gmm_update` from the same
  statistics within 1e-9; `accumulate_batch`, whose f32 posteriors differ
  by each side's softmax rounding, within the bound that sets. The diag
  UBM's `accumulate_batch` against the host numpy within 1e-5 of its
  terms' magnitude (f32 sums in another order).
- The extractor: gselect / min-post posteriors of the batch path against
  `frame_posteriors` (the same selection; within 1e-6), one EM iteration
  of the batch path from the same stats against JAX's host loop (A, B, M
  and the i-vectors within 1e-9 relative: Cholesky where JAX calls solve
  and inv, so the condition number of L and A times the f64 roundoff), a
  whole `train_ivector_extractor` (M and the i-vectors within 1e-5 of
  their largest magnitude: f32 gselect loglikes in another summation
  order feed f64 EM).
- chip_smoke's M-step check binds (a batch M-step within its backward
  error bound, an M moved by 1e-9 outside it), and its UBM, gselect and
  extractor-step checks run with the CPU on both sides.
- tests/test_ivector.py's sre10/v1 pipeline on the port: PARITY.md:46's
  EER < 0.10 and PLDA <= cosine + 0.02.
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.gmm import full_gmm as jfull
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiag
from kaldi_tpu.gmm.estimation import AccumDiagGmm as JAccDiag
from kaldi_tpu.ivector import extractor as jext
from kaldi_tpu.ivector import metrics as jmet
from kaldi_tpu.ivector import plda as jplda
from kaldi_tpu.ivector import vad as jvad
from kaldi_tpu_torch.gmm import full_gmm as tfull
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.estimation import AccumDiagGmm, mle_diag_gmm_update
from kaldi_tpu_torch.ivector import extractor as text
from kaldi_tpu_torch.ivector import metrics as tmet
from kaldi_tpu_torch.ivector import plda as tplda
from kaldi_tpu_torch.ivector import vad as tvad
from kaldi_tpu_torch.params import (full_gmm_from_jax,
                                    ivector_extractor_from_jax,
                                    plda_from_jax)
from test_ivector import _make_speaker_data

F32_EPS = 2.0 ** -24


def _full_gmm(seed=0, M=6, D=5):
    rng = np.random.RandomState(seed)
    A = rng.randn(M, D, D)
    cov = A @ A.transpose(0, 2, 1) + np.eye(D)
    return jfull.FullGmm(rng.dirichlet(np.ones(M)), rng.randn(M, D) * 3,
                         cov), rng


# ------------------------------------------------------------ host copies

@pytest.mark.parametrize("ctx", [0, 2])
def test_vad_equals_jax(ctx):
    rng = np.random.RandomState(ctx)
    feats = rng.randn(200, 13) * 4
    feats[50:90, 0] += 12.0
    opts = dict(vad_energy_threshold=3.0, vad_frames_context=ctx)
    j = jvad.compute_vad(feats, jvad.VadOpts(**opts))
    t = tvad.compute_vad(feats, tvad.VadOpts(**opts))
    np.testing.assert_array_equal(t, j)
    assert 0 < t.sum() < len(t)
    np.testing.assert_array_equal(tvad.select_voiced_frames(feats, t),
                                  jvad.select_voiced_frames(feats, j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eer_equals_jax(seed):
    rng = np.random.RandomState(seed)
    t, n = rng.randn(50) + 1.5, rng.randn(400)
    np.testing.assert_allclose(tmet.compute_eer(t, n), jmet.compute_eer(t, n),
                               rtol=1e-12, atol=0)
    assert tmet.compute_eer([], n) == jmet.compute_eer([], n)
    assert tmet.compute_eer([5, 6], [1, 2]) == (0.0, 5.0)


def _plda_pair(seed=0, D=6, spk=9, n=(3, 4)):
    rng = np.random.RandomState(seed)
    js, ts = jplda.PldaStats(D), tplda.PldaStats(D)
    centers = rng.randn(spk, D) * 2
    for s in range(spk):
        iv = centers[s] + rng.randn(n[s % len(n)], D)
        js.add_speaker(jplda.length_normalize(iv))
        ts.add_speaker(tplda.length_normalize(iv))
    return jplda.Plda.train(js, 6), tplda.Plda.train(ts, 6), rng


def test_plda_train_and_scoring_equal_jax():
    j, t, rng = _plda_pair()
    for f in ("mean", "transform", "psi"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-12,
                                   atol=1e-12)
    enroll = {f"e{i}": rng.randn(6) for i in range(4)}
    test = {f"t{i}": rng.randn(6) for i in range(5)}
    n_enroll = {"e0": 3, "e2": 2}
    for ln in (True, False):
        sj = j.score_trials(enroll, test, n_enroll, length_norm=ln)
        st = t.score_trials(enroll, test, n_enroll, length_norm=ln)
        assert list(st) == list(sj)
        np.testing.assert_allclose([st[k] for k in st], [sj[k] for k in sj],
                                   rtol=1e-12, atol=1e-12)
    u, v = rng.randn(6), rng.randn(6)
    np.testing.assert_allclose(t.llr(u, 2, v), j.llr(u, 2, v), rtol=1e-12)
    np.testing.assert_allclose(t.transform_ivector(u), j.transform_ivector(u),
                               rtol=1e-12, atol=1e-12)


def test_plda_adapt_equals_jax():
    j, t, rng = _plda_pair(seed=3)
    adapt = rng.randn(40, 6) * 1.7 + 0.4
    ja, ta = j.adapt(adapt), t.adapt(adapt)
    for f in ("mean", "transform", "psi"):
        np.testing.assert_allclose(getattr(ta, f), getattr(ja, f),
                                   rtol=1e-12, atol=1e-12)
    carried = plda_from_jax(ja)
    np.testing.assert_array_equal(carried.transform, ja.transform)


def test_plda_speakers_with_equal_counts_share_one_inverse():
    """Every speaker with 4 i-vectors (one inverse per EM iteration) gives
    JAX's model within 1e-12."""
    j, t, _rng = _plda_pair(seed=5, n=(4,))
    np.testing.assert_allclose(t.transform, j.transform, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(t.psi, j.psi, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------- GMM batch paths

def _jax_loglikes_f64(jg, x):
    """JAX's `FullGmm.loglikes` before its cast to f32."""
    ic = jg.inv_covars()
    return (jg.gconsts()[None, :]
            + x @ np.einsum("mde,me->md", ic, jg.means).T
            - 0.5 * np.einsum("td,mde,te->tm", x, ic, x))


def test_full_gmm_loglikes_equal_jax():
    """One f64 GEMM over [1, x, x_d x_e] against the packed parameters is
    JAX's einsums within 1e-9; cast to f32 the loglikes are JAX's within
    one f32 rounding, and the posteriors within each side's f32 softmax
    rounding (`softmax_shift_bound` of equal loglikes)."""
    import chip_smoke as cs
    jg, rng = _full_gmm()
    tg = full_gmm_from_jax(jg)
    x = rng.randn(700, 5) * 3
    f64 = (tfull.full_features(torch.as_tensor(x))
           @ tg.device_pack("cpu")).numpy()
    np.testing.assert_allclose(f64, _jax_loglikes_f64(jg, x), rtol=1e-9)
    ll = jg.loglikes(x)
    got = tg.loglikes_batch(x, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ll, rtol=F32_EPS, atol=0)
    want = jg.posteriors(x).astype(np.float64)
    b, _s = cs.softmax_shift_bound(ll.astype(np.float64),
                                   got.astype(np.float64), want,
                                   np.ones(want.shape, bool))
    assert np.all(np.abs(tg.posteriors_batch(x, "cpu").numpy() - want) <= b)
    np.testing.assert_allclose(tg.loglike_batch(x, "cpu").numpy(),
                               jg.loglike(x), rtol=4 * F32_EPS)


def test_accumulate_posteriors_batch_equals_jax():
    """`accumulate_posteriors_batch` (one f64 GEMM per utterance) against
    JAX's `accumulate_from_posteriors`, from the same f64 posteriors,
    over two utterances: 1e-9."""
    _jg, rng = _full_gmm(seed=2)
    xs = [rng.randn(n, 5) * 2 + 1 for n in (300, 170)]
    ps = [rng.dirichlet(np.ones(6), len(x)) for x in xs]
    ja, ta = jfull.AccumFullGmm(6, 5), tfull.AccumFullGmm(6, 5)
    for x, p in zip(xs, ps):
        ja.accumulate_from_posteriors(x, p)
    ta.accumulate_posteriors_batch(xs, ps, device="cpu")
    for f in ("occ", "mean_acc", "cov_acc"):
        np.testing.assert_allclose(getattr(ta, f), getattr(ja, f), rtol=1e-9)


def test_accumulate_batch_within_the_posteriors_bound():
    """`accumulate_batch` with frame weights against JAX's `accumulate`:
    the f32 posteriors differ by at most each side's softmax rounding, b;
    the statistics by b^T [1, |x|, |x||x|^T] plus JAX's f32 sum of the
    occupancies (gamma_T eps32) and the f64 sums (gamma_{T+2} eps64)."""
    import chip_smoke as cs
    jg, rng = _full_gmm()
    tg = full_gmm_from_jax(jg)
    x = rng.randn(700, 5) * 3
    w = rng.uniform(0.2, 1.0, len(x))
    ja, ta = jfull.AccumFullGmm(6, 5), tfull.AccumFullGmm(6, 5)
    ja.accumulate(jg, x, w)
    like = ta.accumulate_batch(tg, x, w, device="cpu")
    ll = jg.loglikes(x).astype(np.float64)
    post = jg.posteriors(x).astype(np.float64)
    b, _s = cs.softmax_shift_bound(
        ll, tg.loglikes_batch(x, "cpu").numpy().astype(np.float64), post,
        np.ones(post.shape, bool))
    b, p = b * w[:, None], post * w[:, None]
    ax = np.abs(x)
    T = len(x)
    r32, r64 = cs._gamma_n(T, cs.F32_EPS), 2 * cs._gamma_n(T + 2, cs.F64_EPS)
    for got, want, bound in (
            (ta.occ, ja.occ, b.sum(0) + (r32 + r64) * p.sum(0)),
            (ta.mean_acc, ja.mean_acc, (b + r64 * p).T @ ax),
            (ta.cov_acc, ja.cov_acc, np.einsum("tm,td,te->mde", b + r64 * p,
                                               ax, ax))):
        assert np.all(np.abs(got - want) <= bound)
    np.testing.assert_allclose(like, jg.loglike(x).astype(np.float64).sum(),
                               rtol=1e-6)


@pytest.mark.parametrize("floor_scale", [0.0, 0.5])
def test_mle_full_gmm_update_equals_jax(floor_scale):
    """`mle_full_gmm_update` from the same statistics (two gaussians under
    the occupancy threshold keep their parameters, the rest floored by one
    batched eigh): JAX's model within 1e-9."""
    jg, rng = _full_gmm(seed=3)
    x = rng.randn(400, 5) * 2
    ja = jfull.AccumFullGmm(6, 5)
    post = rng.dirichlet(np.ones(6), len(x))
    post[:, :2] *= 0.01
    ja.accumulate_from_posteriors(x, post)
    ta = tfull.AccumFullGmm(6, 5)
    ta.occ, ta.mean_acc, ta.cov_acc = (np.copy(ja.occ), np.copy(ja.mean_acc),
                                       np.copy(ja.cov_acc))
    opts = dict(min_gaussian_occupancy=5.0, variance_floor=0.9,
                covariance_floor_scale=floor_scale)
    want = jfull.mle_full_gmm_update(jg, ja, **opts)
    got = tfull.mle_full_gmm_update(full_gmm_from_jax(jg), ta, device="cpu",
                                    **opts)
    assert np.sum(ja.occ <= 5.0) == 2
    for f in ("weights", "means", "covars"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-9)


def test_floor_eigenvalues_equals_the_host_loop():
    _jg, rng = _full_gmm(seed=4)
    A = rng.randn(7, 5, 5)
    covs = A @ A.transpose(0, 2, 1) - 0.5 * np.eye(5)
    got = tfull.floor_eigenvalues(covs, 1e-3, "cpu")
    for c, g in zip(covs, got):
        w, V = np.linalg.eigh(0.5 * (c + c.T))
        np.testing.assert_allclose(g, (V * np.maximum(w, 1e-3)) @ V.T,
                                   rtol=1e-10, atol=1e-12)


def test_diag_accumulate_batch_equals_host():
    rng = np.random.RandomState(7)
    g = DiagGmm(rng.dirichlet(np.ones(8)), rng.randn(8, 6) * 2,
                rng.uniform(0.5, 2.0, (8, 6)))
    x = (rng.randn(1500, 6) * 2).astype(np.float32)
    host, batch = AccumDiagGmm(8, 6), AccumDiagGmm(8, 6)
    host.accumulate(g, x)
    batch.accumulate_batch(g, torch.as_tensor(x), chunk=400)
    ja = JAccDiag(8, 6)
    ja.accumulate(JDiag(g.weights, g.means, g.vars), x)
    np.testing.assert_array_equal(host.mean_acc, ja.mean_acc)
    ax = np.abs(x.astype(np.float64))
    for got, want, terms in ((batch.occ, host.occ, len(x)),
                             (batch.mean_acc, host.mean_acc, ax.sum(0).max()),
                             (batch.var_acc, host.var_acc,
                              (ax * ax).sum(0).max())):
        assert np.abs(got - want).max() <= 1e-5 * terms
    a = mle_diag_gmm_update(g, batch)
    b = mle_diag_gmm_update(g, host)
    np.testing.assert_allclose(a.means, b.means, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- the extractor

@pytest.fixture(scope="module")
def ext_pair():
    jg, rng = _full_gmm(seed=1, M=8, D=5)
    jx = jext.IvectorExtractor(jg, 4, seed=2)
    utts = [rng.randn(rng.randint(40, 120), 5) * 3 for _ in range(9)]
    return jx, ivector_extractor_from_jax(jx), jg, utts


@pytest.mark.parametrize("gselect,min_post", [(3, 0.05), (8, 0.025),
                                              (20, 0.0)])
def test_gselect_posteriors_equal_frame_posteriors(ext_pair, gselect,
                                                   min_post):
    jx, tx, _g, utts = ext_pair
    packed = torch.as_tensor(tx._gselect_gmm().packed())
    for f in utts[:4]:
        want = jx.frame_posteriors(f, gselect, min_post)
        got = text._gselect_posteriors(torch.as_tensor(f, dtype=torch.float32),
                                       packed, gselect, min_post).numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_batch_stats_equal_utterance_stats(ext_pair, monkeypatch):
    """Chunks of a few utterances (a small chunk budget) give each
    utterance's `utterance_stats`; supplied posteriors too."""
    jx, tx, _g, utts = ext_pair
    monkeypatch.setattr(text, "CHUNK_ELEMS", 8 * 150)
    gam, X = tx.batch_stats(utts, 3, 0.05, device="cpu")
    posts = [jx.frame_posteriors(f, 3, 0.05) for f in utts]
    gp, Xp = tx.batch_stats(utts, posts=posts, device="cpu")
    for n, (f, p) in enumerate(zip(utts, posts)):
        g1, X1 = jx.utterance_stats(f, p)
        for gg, XX in ((gam, X), (gp, Xp)):
            np.testing.assert_allclose(gg[n].numpy(), g1, rtol=0, atol=1e-5)
            np.testing.assert_allclose(XX[n].numpy(), X1, rtol=0,
                                       atol=1e-5 * np.abs(f).sum(0).max())
        np.testing.assert_allclose(Xp[n].numpy(), X1, rtol=1e-12, atol=1e-12)


def test_one_em_iteration_from_the_same_stats_equals_jax(ext_pair):
    jx, _tx, _g, utts = ext_pair
    jx = jext.IvectorExtractor.__new__(jext.IvectorExtractor)
    jx.__dict__.update({k: np.copy(v) if isinstance(v, np.ndarray) else v
                        for k, v in ext_pair[0].__dict__.items()})
    tx = ivector_extractor_from_jax(jx)
    stats = [jx.utterance_stats(f, jx.frame_posteriors(f, 3))
             for f in utts]
    want_iv = np.stack([jx.extract(g, X)[0] for g, X in stats])
    got_iv = tx.extract_batch(stats, device="cpu")
    np.testing.assert_allclose(got_iv, want_iv, rtol=1e-9,
                               atol=1e-9 * np.abs(want_iv).max())
    assert got_iv.shape == (len(stats), 4)
    js = jext.IvectorStats(jx)
    for g, X in stats:
        js.accumulate(jx, g, X)
    js.update(jx)
    gam = torch.as_tensor(np.stack([g for g, _ in stats]))
    Xs = torch.as_tensor(np.stack([X for _, X in stats]))
    ts = text.em_iteration(tx, gam, Xs)
    assert ts.count == len(stats)
    for got, want in ((ts.A.numpy(), js.A), (ts.B.numpy(), js.B),
                      (tx.M, jx.M)):
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_device_copy_follows_updates(ext_pair):
    """U and V are rebuilt after an update (host or batch) and after a new
    M, and kept otherwise."""
    jx, _tx, _g, utts = ext_pair
    tx = ivector_extractor_from_jax(jx)
    c = tx.on_device("cpu")
    assert tx.on_device("cpu") is c
    stats = [tx.utterance_stats(f, tx.frame_posteriors(f, 3))
             for f in utts]
    st = text.IvectorStats(tx, "cpu")
    for g, X in stats:
        st.accumulate(tx, g, X)
    st.update(tx)
    c2 = tx.on_device("cpu")
    assert c2 is not c
    np.testing.assert_allclose(c2["M"].numpy(), tx.M)
    tx.M = tx.M * 2.0
    assert tx.on_device("cpu") is not c2


def test_train_ivector_extractor_batch_path_equals_jax(ext_pair):
    _jx, _tx, jg, utts = ext_pair
    j = jext.train_ivector_extractor(jg, utts, 4, num_iters=3, seed=1,
                                     num_gselect=4)
    t = text.train_ivector_extractor(full_gmm_from_jax(jg), utts, 4,
                                     num_iters=3, seed=1, num_gselect=4,
                                     device="cpu")
    np.testing.assert_allclose(t.M, j.M, rtol=0,
                               atol=1e-5 * np.abs(j.M).max())
    want = np.stack([j.extract(*j.utterance_stats(f, j.frame_posteriors(
        f, 4)))[0] for f in utts])
    got = t.extract_batch([t.utterance_stats(f, t.frame_posteriors(f, 4))
                           for f in utts], device="cpu")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_mstep_backward_error_binds(ext_pair):
    """chip_smoke's M-step check: the batch M-step's M is within the
    backward-error bound of its own statistics, and an M moved by 1e-9 of
    itself is not."""
    import chip_smoke as cs
    jx, tx, _g, utts = ext_pair
    stats = [jx.utterance_stats(f, jx.frame_posteriors(f, 3)) for f in utts]
    gam = torch.as_tensor(np.stack([g for g, _ in stats]))
    Xs = torch.as_tensor(np.stack([X for _, X in stats]))
    tx = ivector_extractor_from_jax(jx)
    st = text.em_iteration(tx, gam, Xs)
    A, B = st.A.numpy(), st.B.numpy()
    back, bound = cs.mstep_backward_error(tx.M, A, B, 1e-4)
    assert bound < 1e-13 and back.max() <= bound, (back.max(), bound)
    moved, _ = cs.mstep_backward_error(tx.M * (1 + 1e-9), A, B, 1e-4)
    assert moved.max() > bound


def test_card_vs_cpu_checks_run_on_the_cpu(ext_pair):
    """chip_smoke's UBM, gselect and extractor-step checks with the CPU on
    both sides: the same arithmetic twice, so every difference is 0, each
    tensor finite, and the M-step within its backward-error bound."""
    import chip_smoke as cs
    jx, tx, jg, utts = ext_pair
    x = np.concatenate(utts)
    du = cs.diag_ubm_stats_card_vs_cpu(tx._gselect_gmm(), x, card="cpu")
    assert du == {"occ": 0.0, "mean": 0.0, "var": 0.0, "ll": 0.0}
    fu = cs.full_ubm_stats_card_vs_cpu(full_gmm_from_jax(jg), x, card="cpu")
    assert fu == {"occ": 0.0, "mean": 0.0, "cov": 0.0, "ll": 0.0}
    gs = cs.gselect_stats_card_vs_cpu(tx, utts, 3, card="cpu")
    assert gs["post"] == gs["gamma"] == gs["X"] == 0.0 and gs["flips"] == 0
    es = cs.extractor_step_card_vs_cpu(tx, *gs["stats"], gauss=[0, 5, 7],
                                       card="cpu")
    assert es["finite"] and es["kappa_L"] > 1.0 and es["kappa_A"] > 1.0
    for k in ("L", "b", "w", "Linv", "A", "B", "w_rel", "M_rel"):
        assert es[k] == 0.0, (k, es[k])
    assert 0.0 < es["M"] <= 1.0 and 0.0 < es["solve"] <= 1.0


def test_ivector_plda_pipeline_on_the_port():
    """tests/test_ivector.py's pipeline with the port's modules, the batch
    paths on the CPU: PARITY.md:46's EER < 0.10, and PLDA at most 0.02
    above cosine scoring on the same trials."""
    rng = np.random.RandomState(0)
    data = _make_speaker_data(rng)
    frames = np.concatenate([u for us in data.values() for u in us])
    ubm = DiagGmm.from_stats(frames.mean(0), frames.var(0)).split(8)
    for _ in range(8):
        acc = AccumDiagGmm(ubm.num_gauss, ubm.dim)
        acc.accumulate_batch(ubm, torch.as_tensor(frames, dtype=torch.float32))
        ubm = mle_diag_gmm_update(ubm, acc)
    fubm = tfull.FullGmm.from_diag(ubm.weights, ubm.means, ubm.vars)
    for _ in range(3):
        facc = tfull.AccumFullGmm(fubm.num_gauss, fubm.dim)
        facc.accumulate_batch(fubm, frames, device="cpu")
        fubm = tfull.mle_full_gmm_update(fubm, facc, device="cpu")
    train = [u for us in data.values() for u in us[:4]]
    ext = text.train_ivector_extractor(fubm, train, 8, num_iters=4,
                                       device="cpu")
    order = [(s, i) for s, us in data.items() for i in range(len(us))]
    ivs = dict(zip(order, ext.extract_batch(
        ext.batch_stats([data[s][i] for s, i in order], device="cpu"),
        device="cpu")))
    stats = tplda.PldaStats(8)
    for spk in data:
        stats.add_speaker(tplda.length_normalize(
            np.stack([ivs[spk, i] for i in range(4)])))
    plda = tplda.Plda.train(stats, num_iters=8)
    enroll = {s: np.stack([ivs[s, i] for i in range(4)]).mean(0)
              for s in data}
    tests = {f"{s}_t{i - 4}": ivs[s, i] for s, i in order if i >= 4}
    scores = plda.score_trials(enroll, tests, n_enroll={s: 4 for s in data})

    def eer_of(score):
        tgt, non = [], []
        for (e, tk) in scores:
            (tgt if tk.rsplit("_t", 1)[0] == e else non).append(score(e, tk))
        return tmet.compute_eer(tgt, non)[0]

    eer = eer_of(lambda e, tk: scores[e, tk])
    eer_cos = eer_of(lambda e, tk: float(
        enroll[e] @ tests[tk] / (np.linalg.norm(enroll[e])
                                 * np.linalg.norm(tests[tk]) + 1e-10)))
    assert eer < 0.10, eer
    assert eer <= eer_cos + 0.02, (eer, eer_cos)
