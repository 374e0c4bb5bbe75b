"""The port's adaptation transforms against kaldi_tpu's on the CPU: raw
fMLLR, basis fMLLR, regression-tree fMLLR / MLLR, LVTLN and HLDA.

Inputs are tests/test_adaptation_extras.py's and test_fmllr_raw.py's,
made from the same seeds. Tolerances:
- f64 modules (basis, regression tree, MLLR, LVTLN, HLDA): 1e-9 of each
  result's magnitude where both packages start from the same inputs
  (statistics carried across by `params.fmllr_stats_from_jax`); where the
  port takes its own f32 gaussian posteriors from `AmDiagGmm` (the
  regression-tree statistics), the same statistics from the port's
  posteriors through JAX's own `FmllrStats.accumulate` at 1e-9, and JAX's
  whole accumulation within 1e-5 of the statistics' terms;
- raw fMLLR (f32): one Adam step at 1e-5 of max |W|; the whole 150- or
  300-step run by its objective (Adam's m / sqrt(v) follows rounding near
  the optimum): the gain per frame within 1e-3 relative;
- the regression tree: node for node, exactly (host 2-means in JAX's RNG
  order); the basis: up to the sign of each vector.
Then test_adaptation_extras.py's and test_fmllr_raw.py's contracts are
restated against the port, and chip_smoke's phase 27 helper runs with the
CPU on both sides.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.gmm.am_gmm import AmDiagGmm as JAm
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiag
from kaldi_tpu.transform import basis_fmllr as jbf
from kaldi_tpu.transform import fmllr as jfm
from kaldi_tpu.transform import fmllr_raw as jraw
from kaldi_tpu.transform import hlda as jhl
from kaldi_tpu.transform import lvtln as jlv
from kaldi_tpu.transform import regtree as jrt

from kaldi_tpu_torch import params as P
from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.nnet.optim import adam, apply_updates
from kaldi_tpu_torch.ops.delta import splice_frames
from kaldi_tpu_torch.transform import basis_fmllr as tbf
from kaldi_tpu_torch.transform import fmllr as tfm
from kaldi_tpu_torch.transform import fmllr_raw as traw
from kaldi_tpu_torch.transform import hlda as thl
from kaldi_tpu_torch.transform import lvtln as tlv
from kaldi_tpu_torch.transform import regtree as trt

REL = 1e-9


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _toy(seed, num_pdfs=3, num_gauss=2, dim=4):
    """test_adaptation_extras._toy_am for both packages, and the rng."""
    rng = np.random.RandomState(seed)
    tam = cs.toy_am(rng, num_pdfs, num_gauss, dim)
    jam = JAm([JDiag(g.weights, g.means, g.vars) for g in tam.pdfs])
    return jam, tam, rng


# ------------------------------------------------------------------ MLLR

def _mllr_data(am, rng):
    D = am.dim
    shift = rng.randn(D) * 0.8
    data = []
    for g in am.pdfs:
        for m in range(g.num_gauss):
            x = g.means[m] + shift + rng.randn(400, D) * np.sqrt(g.vars[m])
            p = np.zeros((400, g.num_gauss))
            p[:, m] = 1.0
            data.append((x, g.means, g.vars, p))
    return data, shift


def test_mllr_stats_and_estimate_equal_jax():
    jam, tam, rng = _toy(0)
    data, _shift = _mllr_data(tam, rng)
    js_, ts_ = jrt.MllrStats(4), trt.MllrStats(4, "cpu")
    for args in data:
        js_.accumulate(*args)
        ts_.accumulate(*args)
    assert ts_.beta == pytest.approx(js_.beta, rel=1e-12)
    assert _rel(ts_.K, js_.K) <= REL and _rel(ts_.G, js_.G) <= REL
    assert _rel(trt.estimate_mllr(ts_), jrt.estimate_mllr(js_)) <= REL
    W = jrt.estimate_mllr(js_)
    for a, b in zip(trt.apply_mllr_to_means(tam, W).pdfs,
                    jrt.apply_mllr_to_means(jam, W).pdfs):
        np.testing.assert_allclose(a.means, b.means, rtol=1e-12)
    low = trt.MllrStats(4, "cpu")
    np.testing.assert_array_equal(trt.estimate_mllr(low).numpy(),
                                  np.eye(4, 5))


def test_mllr_recovers_mean_shift():
    _jam, am, rng = _toy(0)
    data, shift = _mllr_data(am, rng)
    stats = trt.MllrStats(4, "cpu")
    for args in data:
        stats.accumulate(*args)
    W = trt.estimate_mllr(stats).numpy()
    np.testing.assert_allclose(W[:, :4], np.eye(4), atol=0.1)
    np.testing.assert_allclose(W[:, 4], shift, atol=0.15)


# -------------------------------------------------------- regression tree

def _regtree_case():
    jam, tam, rng = _toy(1, num_pdfs=4, num_gauss=2, dim=3)
    feats, pdfs = cs._regtree_data(rng, tam)
    post = [[(int(p), 1.0)] for p in pdfs]
    return jam, tam, feats, pdfs, post


@pytest.mark.parametrize("classes,seed", [(4, 0), (3, 5), (8, 1)])
def test_regression_tree_equals_jax(classes, seed):
    jam, tam, *_rest = _regtree_case()
    jt = jrt.RegressionTree(jam, classes, seed)
    tt = trt.RegressionTree(tam, classes, seed, device="cpu")
    assert tt.parent == jt.parent and tt.leaves == jt.leaves
    np.testing.assert_array_equal(tt.gauss2leaf, jt.gauss2leaf)
    for a, b in zip(tt.members, jt.members):
        np.testing.assert_array_equal(a, b)
    carried = P.regression_tree_from_jax(jt, "cpu")
    assert carried.parent == jt.parent and carried.num_nodes == jt.num_nodes


def test_regtree_stats_equal_jax():
    """Each leaf's fMLLR statistics (f64 GEMMs over a leaf one-hot) equal
    JAX's FmllrStats.accumulate of the same (the port's) posteriors at
    1e-9, and JAX's whole accumulation (its own f32 posteriors) within
    1e-5 of the statistics' terms."""
    jam, tam, feats, pdfs, post = _regtree_case()
    jt = jrt.RegressionTree(jam, 4)
    tt = trt.RegressionTree(tam, 4, device="cpu")
    ja, ta = jrt.RegtreeStats(jt, 3), trt.RegtreeStats(tt, 3)
    ja.accumulate(jam, feats, post)
    ta.accumulate(tam, feats, post)
    _x, gam = trt._entry_posteriors(tam, feats, post, "cpu")
    gam = gam.numpy()
    means = np.concatenate([g.means for g in tam.pdfs])
    var = np.concatenate([g.vars for g in tam.pdfs])
    scale = cs.fmllr_term_scale(tam, feats, pdfs)
    for leaf in tt.leaves:
        sel = tt.gauss2leaf == leaf
        same = jfm.FmllrStats(3)
        same.accumulate(feats, means[sel], var[sel], gam[:, sel])
        s = ta.stats[leaf]
        assert _rel(s.K, same.K) <= REL and _rel(s.G, same.G) <= REL
        assert s.beta == pytest.approx(same.beta, rel=1e-12)
        assert np.abs(s.K - ja.stats[leaf].K).max() <= 1e-5 * np.abs(
            scale.K).max()
        assert np.abs(s.G - ja.stats[leaf].G).max() <= 1e-5 * np.abs(
            scale.G).max()
    for a, b in zip(ta.summed_up(), ja.summed_up()):
        assert a.beta == pytest.approx(b.beta, rel=1e-5)


def test_regtree_fmllr_and_mllr_estimates_equal_jax():
    """From the same statistics (JAX's, carried across): the per-node
    fMLLR solves and the batched MLLR solves with their back-off."""
    jam, tam, feats, pdfs, post = _regtree_case()
    jt = jrt.RegressionTree(jam, 4)
    tt = trt.RegressionTree(tam, 4, device="cpu")
    ja, ta = jrt.RegtreeStats(jt, 3), trt.RegtreeStats(tt, 3)
    ja.accumulate(jam, feats, post)
    ta.stats = [P.fmllr_stats_from_jax(s) for s in ja.stats]
    xj = jrt.estimate_regtree_fmllr(ja, 200.0)
    xt = trt.estimate_regtree_fmllr(ta, 200.0)
    assert xj.keys() == xt.keys()
    for g in xj:
        assert _rel(xt[g], xj[g]) <= 1e-6   # f32 output of estimate_fmllr
    mj, mt = jrt.RegtreeMllrStats(jt, 3), trt.RegtreeMllrStats(tt, 3)
    mj.accumulate(jam, feats, post)
    mt.accumulate(tam, feats, post)
    for a, b in ((mt.K, mj.K), (mt.G, mj.G), (mt.beta, mj.beta)):
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    mt.K, mt.G, mt.beta = (torch.as_tensor(a) for a in (mj.K, mj.G, mj.beta))
    for K, G in ((mt.summed_up()[0], mj.summed_up()[0]),
                 (mt.summed_up()[1], mj.summed_up()[1])):
        assert _rel(K, G) <= REL
    # the solves (G_d + 1e-6 I) w_d = k_d are held by their backward error
    # (their condition number makes a forward 1e-9 vacuous): both
    # packages' rows within chip_smoke.backward_bound of the same system
    wj = jrt.estimate_regtree_mllr(mj, 200.0)
    wt = trt.estimate_regtree_mllr(mt, 200.0)
    K, G, beta = (a.numpy() for a in mt.summed_up())
    for g, leaf in enumerate(tt.gauss2leaf):
        # the deepest ancestor (the leaf included) with enough occupancy
        n = next(a for a in tt.ancestors(int(leaf)) if beta[a] >= 200.0)
        A = np.transpose(G[n] + 1e-6 * np.eye(4), (0, 2, 1))
        for W in (wt[g], wj[g]):
            be = cs.backward_error(A, W[:, None, :], K[n][:, None, :])
            assert be.max() <= cs.backward_bound(4, 1)


def test_regtree_loglikes_and_mllr_model_equal_jax():
    jam, tam, feats, _pdfs, _post = _regtree_case()
    jt = jrt.RegressionTree(jam, 4)
    tt = trt.RegressionTree(tam, 4, device="cpu")
    rng = np.random.RandomState(7)
    by_leaf = {leaf: np.concatenate([np.eye(3) + rng.randn(3, 3) * 0.1,
                                     rng.randn(3, 1) * 0.2], 1)
               for leaf in jt.leaves[:3]}
    got = trt.regtree_fmllr_loglikes(tam, tt, by_leaf, feats)
    assert got.dtype == torch.float64
    assert _rel(got, jrt.regtree_fmllr_loglikes(jam, jt, by_leaf, feats)) \
        <= REL
    for a, b in zip(trt.apply_regtree_mllr(tam, tt, by_leaf).pdfs,
                    jrt.apply_regtree_mllr(jam, jt, by_leaf).pdfs):
        np.testing.assert_allclose(a.means, b.means, rtol=1e-12)
    stacked = np.concatenate([by_leaf.get(leaf, np.eye(3, 4))
                              for leaf in sorted(jt.leaves)])
    a = trt.unstack_transforms(tt, stacked, 3)
    b = jrt.unstack_transforms(jt, stacked, 3)
    assert a.keys() == b.keys()


def test_regression_tree_and_regtree_fmllr():
    """test_adaptation_extras.py's contract on the port."""
    _jam, am, feats, _pdfs, post = _regtree_case()
    tree = trt.RegressionTree(am, num_base_classes=4, device="cpu")
    assert len(tree.leaves) == 4 and tree.gauss2leaf.shape[0] == 8
    acc = trt.RegtreeStats(tree, am.dim)
    acc.accumulate(am, feats, post)
    xf = trt.estimate_regtree_fmllr(acc, min_count=200.0)
    assert set(xf.keys()) == set(range(8))
    for W in xf.values():
        np.testing.assert_allclose(W[:, :am.dim], np.eye(am.dim), atol=0.35)
    assert len({W.tobytes() for W in xf.values()}) < 8


# ---------------------------------------------------------- basis fMLLR

def _basis_case():
    rng = np.random.RandomState(2)
    dim = 3
    g = DiagGmm(np.ones(2) / 2, rng.randn(2, dim) * 2, np.ones((2, dim)))

    def stats(n, A, b):
        s = jfm.FmllrStats(dim)
        for m in range(2):
            x = (g.means[m] + rng.randn(n, dim)) @ A.T + b
            p = np.zeros((n, 2))
            p[:, m] = 1.0
            s.accumulate(x, g.means, g.vars, p)
        return s

    train = [stats(150, np.eye(dim) + rng.randn(dim, dim) * 0.1,
                   rng.randn(dim) * 0.3) for _ in range(12)]
    test = stats(60, np.eye(dim) * 1.1, np.array([0.5, -0.2, 0.1]))
    return train, test


def test_basis_accus_and_basis_equal_jax():
    train, _test = _basis_case()
    ja, ta = jbf.BasisFmllrAccus(3), tbf.BasisFmllrAccus(3, "cpu")
    for s in train:
        ja.accumulate_from_speaker(s)
        ta.accumulate_from_speaker(P.fmllr_stats_from_jax(s))
    assert _rel(ta.grad_scatter, ja.grad_scatter) <= REL
    assert _rel(ta.H, ja.H) <= REL and ta.beta == pytest.approx(ja.beta)
    assert _rel(tbf._hbar(ta), jbf._hbar(ja)) <= REL
    bj = jbf.estimate_fmllr_basis(ja, 6)
    bt = tbf.estimate_fmllr_basis(ta, 6).numpy()
    for a, b in zip(bt, bj):      # up to sign, each of distinct eigenvalue
        s = np.sign((a * b).sum())
        assert _rel(s * a, b) <= 1e-7


def test_basis_gradient_and_transform_equal_jax():
    """One gradient at 1e-9; the projected ascent (a backtracking line
    search) by its auxiliary at 1e-9 and the same coefficient count."""
    train, test = _basis_case()
    ja = jbf.BasisFmllrAccus(3)
    for s in train:
        ja.accumulate_from_speaker(s)
    basis = jbf.estimate_fmllr_basis(ja, 6)
    W0 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    tt = P.fmllr_stats_from_jax(test)
    got = tbf._auxf_gradient(torch.as_tensor(W0), *tbf._stats_on(tt, "cpu"))
    assert _rel(got, jbf._auxf_gradient(W0, test)) <= REL
    Wj, nj, ij = jbf.compute_basis_fmllr_transform(test, basis, eta=0.05)
    Wt, nt, it = tbf.compute_basis_fmllr_transform(
        tt, torch.as_tensor(basis), eta=0.05)
    assert nt == nj and abs(it - ij) <= REL * abs(ij)
    assert abs(float(tbf.fmllr_auxf_t(Wt, *tbf._stats_on(tt, "cpu")))
               - jfm.fmllr_auxf(Wj, test)) <= REL * abs(
        jfm.fmllr_auxf(Wj, test))


def test_basis_fmllr():
    """test_adaptation_extras.py's contract on the port."""
    train, test = _basis_case()
    accus = tbf.BasisFmllrAccus(3, "cpu")
    for s in train:
        accus.accumulate_from_speaker(P.fmllr_stats_from_jax(s))
    basis = tbf.estimate_fmllr_basis(accus, basis_size=6)
    assert basis.shape == (6, 3, 4)
    V = basis.reshape(6, -1).numpy()
    np.testing.assert_allclose(V @ tbf._hbar(accus).numpy() @ V.T, np.eye(6),
                               atol=1e-8)
    tt = P.fmllr_stats_from_jax(test)
    W, n_used, impr = tbf.compute_basis_fmllr_transform(tt, basis, eta=0.05)
    assert 1 <= n_used <= 6 and impr > 0.0
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    assert tfm.fmllr_auxf(W.numpy(), tt) > tfm.fmllr_auxf(ident, tt)


# ----------------------------------------------------------------- LVTLN

def _lvtln_case():
    rng = np.random.RandomState(3)
    dim = 4
    maps = {0: np.eye(dim) * 0.8 + 0.05, 1: np.eye(dim),
            2: np.eye(dim) * 1.25 - 0.05}
    X = rng.randn(2000, dim)
    g = JDiag(np.ones(1), np.zeros((1, dim)), np.ones((1, dim)))
    xs = rng.randn(500, dim) @ np.linalg.inv(maps[2]).T
    stats = jfm.FmllrStats(dim)
    stats.accumulate(xs, g.means, g.vars, np.ones((500, 1)))
    return maps, X, stats


@pytest.mark.parametrize("estimate_bias", [True, False])
def test_lvtln_equals_jax(estimate_bias):
    maps, X, stats = _lvtln_case()
    jl = jlv.LinearVtln(4, [0.9, 1.0, 1.1])
    tl = tlv.LinearVtln(4, [0.9, 1.0, 1.1], "cpu")
    for c, M in maps.items():
        jl.train_class(c, X, X @ M.T)
        tl.train_class(c, X, X @ M.T)
    assert _rel(tl.A, jl.A) <= REL
    cj, Wj, aj = jl.select_class(stats, estimate_bias)
    ct, Wt, at = tl.select_class(P.fmllr_stats_from_jax(stats),
                                 estimate_bias)
    assert ct == cj and _rel(Wt, Wj) <= REL and _rel(at, aj) <= REL
    carried = P.linear_vtln_from_jax(jl, "cpu")
    assert _rel(carried.A, jl.A) == 0.0 and carried.warp_of(2) == 1.1


def test_lvtln_selects_matching_warp():
    maps, X, stats = _lvtln_case()
    lv = tlv.LinearVtln(4, [0.9, 1.0, 1.1], "cpu")
    for c, M in maps.items():
        lv.train_class(c, X, X @ M.T)
    np.testing.assert_allclose(lv.A[1].numpy(), np.eye(4), atol=1e-3)
    c, _W, auxfs = lv.select_class(P.fmllr_stats_from_jax(stats))
    assert c == 2 and auxfs[2] > auxfs[1] > auxfs[0]
    empty = tfm.FmllrStats(4)
    assert lv.select_class(empty)[0] == lv.default_class


# ------------------------------------------------------------------ HLDA

def _hlda_feed(stats_list):
    rng = np.random.RandomState(4)
    cm = np.zeros((3, 5))
    cm[:, 0] = [-4, 0, 4]
    cm[:, 1] = [3, -3, 0]
    for c in range(3):
        x = cm[c] + rng.randn(500, 5)
        for s in stats_list:
            s.accumulate(x, np.full(500, c), 3)
    return cm


def test_hlda_equals_jax():
    """Statistics and scatters at 1e-9; the cyclic row update (JAX's per-row
    inverse, no Sherman-Morrison) gives JAX's rows and gain at 1e-9."""
    js_, ts_ = jhl.HldaStats(5), thl.HldaStats(5, "cpu")
    _hlda_feed([js_, ts_])
    assert _rel(ts_.total_2nd, js_.total_2nd) <= REL
    assert _rel(ts_.class_mean_acc, np.stack(js_.class_mean_acc)) <= REL
    for a, b in zip(ts_.scatters(), js_.scatters()):
        assert _rel(a, b) <= REL
    Aj, ij = jhl.estimate_hlda(js_, 2)
    At, it = thl.estimate_hlda(ts_, 2)
    assert _rel(At, Aj) <= REL and abs(it - ij) <= REL * abs(ij)


def test_hlda_finds_informative_dims():
    stats = thl.HldaStats(5, "cpu")
    cm = _hlda_feed([stats])
    A, impr = thl.estimate_hlda(stats, keep_dims=2)
    assert A.shape == (2, 5) and impr >= -1e-6
    proj = cm @ A.T
    assert np.linalg.norm(proj[0] - proj[1]) > 1.0
    assert np.linalg.norm(proj[0] - proj[2]) > 1.0
    assert np.abs(A[:, :2]).sum() > np.abs(A[:, 2:]).sum()


# ------------------------------------------------------------ raw fMLLR

def _raw_case():
    """test_fmllr_raw.py's setup for both packages."""
    rng = np.random.RandomState(0)
    d, L, R, Dm = 3, 1, 1, 4
    proj = rng.randn(Dm, (L + R + 1) * d) * 0.4
    Tmat = np.concatenate([proj, np.zeros((Dm, 1))], axis=1)
    clean = rng.randn(800, d) * 1.5 + rng.randn(d)
    y = splice_frames(torch.as_tensor(clean), L, R).numpy() @ proj.T
    pid = (y[:, 0] > np.median(y[:, 0])).astype(int)
    stats = [(y[pid == c].mean(0)[None], y[pid == c].var(0)[None] + 1e-3)
             for c in (0, 1)]
    tam = AmDiagGmm([DiagGmm(np.ones(1), m, v) for m, v in stats], "cpu")
    jam = JAm([JDiag(np.ones(1), m, v) for m, v in stats])
    A_true, b_true = np.eye(d) * 1.3, np.array([0.5, -0.3, 0.2])
    distorted = clean @ A_true.T + b_true
    return dict(d=d, L=L, R=R, proj=proj, Tmat=Tmat, clean=clean, y=y,
                pid=pid, tam=tam, jam=jam, A_true=A_true, b_true=b_true,
                distorted=distorted)


def test_raw_accumulators_equal_jax():
    """Windows equal; the gaussian posteriors (one gaussian per pdf) 1; the
    padded means and inverse variances equal."""
    c = _raw_case()
    ja = jraw.FmllrRawAccs(3, 1, 1)
    ja.accumulate_from_alignment(c["jam"], c["distorted"][:400], c["Tmat"],
                                 c["pid"][:400])
    ta = traw.FmllrRawAccs(3, 1, 1, "cpu")
    ta.accumulate_from_alignment(c["tam"], c["distorted"][:400], c["Tmat"],
                                 c["pid"][:400])
    X, mu, iv, gam = ta.stacked()
    np.testing.assert_allclose(X.numpy(), np.stack(ja.windows), rtol=1e-6)
    np.testing.assert_allclose(mu.numpy()[:, 0], np.stack(
        [m[0] for m in ja.means]), rtol=1e-6)
    np.testing.assert_allclose(gam.numpy(), np.stack(ja.gammas), rtol=1e-6)
    assert ta.beta() == pytest.approx(ja.beta(), rel=1e-6)
    carried = P.fmllr_raw_accs_from_jax(ja, "cpu")
    assert carried.num_frames == 400


def test_raw_one_adam_step_equals_jax():
    """The f32 objective's gradient through autograd and one optax.adam
    step (the port's adam) from the identity: 1e-5 of max |W|."""
    import jax
    import jax.numpy as jnp
    import optax
    c = _raw_case()
    ja = jraw.FmllrRawAccs(3, 1, 1)
    ja.accumulate_from_alignment(c["jam"], c["distorted"][:400], c["Tmat"],
                                 c["pid"][:400])
    ta = P.fmllr_raw_accs_from_jax(ja, "cpu")
    X, mu, iv, gam = ta.stacked()
    beta = ja.beta()
    W0 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    Xj, Tj = jnp.asarray(X.numpy()), jnp.asarray(c["Tmat"], jnp.float32)
    muj, ivj, gj = (jnp.asarray(a.numpy()) for a in (mu, iv, gam))

    def auxf(W):
        A, b = W[:, :3], W[:, 3]
        Xw = Xj.reshape(len(Xj), 3, 3) @ A.T + b
        y = Xw.reshape(len(Xj), 9) @ Tj[:, :-1].T + Tj[:, -1]
        diff = y[:, None, :] - muj
        return (-0.5 * jnp.sum(gj[:, :, None] * ivj * diff * diff)
                + beta * jnp.linalg.slogdet(A)[1])

    g = jax.grad(lambda w: -auxf(w))(jnp.asarray(W0))
    tx = optax.adam(0.02)
    upd, _s = tx.update(g, tx.init(jnp.asarray(W0)))
    want = np.asarray(optax.apply_updates(jnp.asarray(W0), upd))
    W = torch.as_tensor(W0).requires_grad_(True)
    (-traw.fmllr_raw_auxf(W, X, torch.as_tensor(c["Tmat"], dtype=torch.float32),
                          mu, iv, gam, beta, 3, 3)).backward()
    t = adam(0.02)
    u, _st = t.update({"W": W.grad}, t.init({"W": W.detach()}))
    got = apply_updates({"W": W.detach()}, u)["W"].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert float(traw.fmllr_raw_auxf(torch.as_tensor(W0), X, torch.as_tensor(
        c["Tmat"], dtype=torch.float32), mu, iv, gam, beta, 3, 3)) \
        == pytest.approx(float(auxf(jnp.asarray(W0))), rel=1e-6)


@pytest.mark.parametrize("steps,lr", [(150, 0.02), (300, 0.03)])
def test_raw_adam_run_by_its_objective(steps, lr):
    """JAX's and the port's whole Adam runs from the same accumulators: the
    gain per frame within 1e-3 relative (Adam follows f32 rounding near the
    optimum, so W is not held)."""
    c = _raw_case()
    ja = jraw.FmllrRawAccs(3, 1, 1)
    ja.accumulate_from_alignment(c["jam"], c["distorted"][:400], c["Tmat"],
                                 c["pid"][:400])
    Wj, gj = jraw.estimate_fmllr_raw(ja, c["Tmat"], steps, lr)
    Wt, gt = traw.estimate_fmllr_raw(P.fmllr_raw_accs_from_jax(ja, "cpu"),
                                     c["Tmat"], steps, lr)
    assert Wt.dtype == np.float32 and Wt.shape == (3, 4)
    assert abs(gt - gj) <= 1e-3 * abs(gj)


def test_fmllr_raw_recovers_distortion():
    """test_fmllr_raw.py's contract on the port."""
    c = _raw_case()
    d = 3
    accs = traw.FmllrRawAccs(d, 1, 1, "cpu")
    accs.accumulate_from_alignment(c["tam"], c["distorted"][:400], c["Tmat"],
                                   c["pid"][:400])
    W, impr = traw.estimate_fmllr_raw(accs, c["Tmat"], num_steps=300,
                                      lr=0.03)
    assert impr > 0.0
    X, mu, iv, gam = accs.stacked()
    Tm = torch.as_tensor(c["Tmat"], dtype=torch.float32)

    def auxf_of(Wx):
        return float(traw.fmllr_raw_auxf(torch.as_tensor(Wx, dtype=torch.float32),
                                         X, Tm, mu, iv, gam, accs.beta(),
                                         d, 3))

    A_inv = np.linalg.inv(c["A_true"])
    W_true = np.concatenate([A_inv, (-A_inv @ c["b_true"])[:, None]], axis=1)
    assert auxf_of(W) >= auxf_of(W_true) - 0.5

    def mismatch(Wx):
        Xw = c["distorted"][:400] @ Wx[:, :d].T + Wx[:, d]
        sp = splice_frames(torch.as_tensor(Xw), 1, 1).numpy() @ c["proj"].T
        return np.abs(sp.mean(0) - c["y"][:400].mean(0)).max()

    ident = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    assert mismatch(W) < mismatch(ident) * 0.5


def test_fmllr_raw_identity_below_min_count():
    accs = traw.FmllrRawAccs(3, 1, 1, "cpu")
    W, impr = traw.estimate_fmllr_raw(accs, np.zeros((4, 10)), min_count=100)
    np.testing.assert_allclose(W[:, :3], np.eye(3))
    assert impr == 0.0


# ----------------------------------------- chip_smoke's phase 27 helper

def test_phase27_adaptation_checks_with_the_cpu_on_both_sides():
    out = cs.adapt_card_vs_cpu(card="cpu")
    for k, v in out.items():
        assert v <= (0.0 if "equal" in k else 1.0) or "reported" in k, (k, v)
