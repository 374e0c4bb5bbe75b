"""Port parity: the SRE pipeline (kaldi_tpu_torch.steps.sre) and the UBM
steps (steps.ubm) against kaldi_tpu's, on the CPU.

- `train_full_ubm`: one iteration from a diag UBM carried across from JAX
  (weights, means and covariances within 1e-5 relative: the loglikes are
  f64 cast to f32 on both sides, the posteriors f32, and JAX sums the
  occupancies in f32), its per-iteration log-likelihoods non-decreasing.
- `full_ubm_from_posteriors`: f64 GEMMs against JAX's einsums, 1e-10.
- `train_diag_ubm` with `host_numpy` is JAX's host code whatever the
  device (it touches none): the same GMM exactly, so `train_fmmi`'s
  posterior GMM is JAX's.
- `train_sre_system` + `evaluate_sre` on tests/test_sre_pipeline.py's
  corpus: v1 (GMM-UBM) and v2 (posterior UBM) give JAX's EER, and
  PARITY.md:47's EER < 0.15 on the port; v2's scores (f64 throughout,
  posteriors supplied) within 1e-8 of the largest |score|, v1's within
  1e-3 (f32 posteriors, summed in another order, feed the diag UBM, the
  full UBM and the extractor's EM in turn). A JAX system carried across
  by `sre_system_from_jax` scores within 1e-6. The PLDA trains on the
  training utterances' i-vectors after a second VAD pass, as JAX's does.
"""

import numpy as np
import pytest

from kaldi_tpu.gmm.full_gmm import FullGmm as JFullGmm
from kaldi_tpu.steps import sre as jsre
from kaldi_tpu.steps import ubm as jubm
from kaldi_tpu_torch.params import diag_gmm_from_jax, sre_system_from_jax
from kaldi_tpu_torch.steps import sre as tsre
from kaldi_tpu_torch.steps import ubm as tubm
from test_sre_pipeline import _make_corpus, _split


@pytest.fixture(scope="module")
def corpus():
    data, comp_means = _make_corpus(np.random.RandomState(0))
    return data, comp_means, _split(data)


def _post_fn(comp_means):
    def post_fn(feats):
        d = ((feats[:, None, :] - comp_means[None]) ** 2).sum(-1)
        e = np.exp(-0.5 * (d - d.min(axis=1, keepdims=True)))
        return e / e.sum(axis=1, keepdims=True)
    return post_fn


def _pooled(data):
    return np.concatenate([f for us in data.values() for f, _c in us[:3]])


def test_train_full_ubm_iteration_equals_jax(corpus):
    data, _cm, _s = corpus
    x = _pooled(data)
    d = jubm.train_diag_ubm(x, jubm.DiagUbmTrainOpts(num_gauss=8,
                                                     num_iters=2))
    want = jubm.train_full_ubm(d, x, jubm.FullUbmTrainOpts(num_iters=1))
    stats: list = []
    got = tubm.train_full_ubm(diag_gmm_from_jax(d), x,
                              tubm.FullUbmTrainOpts(num_iters=1),
                              device="cpu", iter_stats=stats)
    for f in ("weights", "means", "covars"):
        w = getattr(want, f)
        np.testing.assert_allclose(getattr(got, f), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    assert [s["iter"] for s in stats] == [0, 1]
    start = JFullGmm.from_diag(d.weights, d.means, d.vars)
    np.testing.assert_allclose(stats[0]["loglike"],
                               np.mean(start.loglike(x).astype(np.float64)),
                               rtol=1e-6)
    assert stats[1]["loglike"] >= stats[0]["loglike"]


def test_full_ubm_loglike_does_not_fall(corpus):
    data, _cm, _s = corpus
    x = _pooled(data)
    d = tubm.train_diag_ubm(x, tubm.DiagUbmTrainOpts(num_gauss=8,
                                                     num_iters=2),
                            device="cpu")
    stats: list = []
    tubm.train_full_ubm(d, x, tubm.FullUbmTrainOpts(num_iters=4),
                        device="cpu", iter_stats=stats)
    ll = [s["loglike"] for s in stats]
    assert len(ll) == 5
    assert all(b >= a - 1e-6 * abs(a) for a, b in zip(ll, ll[1:])), ll


def test_full_ubm_from_posteriors_equals_jax(corpus):
    data, cm, _s = corpus
    feats = [f for us in data.values() for f, _c in us[:2]]
    posts = [_post_fn(cm)(f) for f in feats]
    # one class left empty: its covariance is the floor
    posts = [np.concatenate([p, np.zeros((len(p), 1))], axis=1)
             for p in posts]
    want = jsre.full_ubm_from_posteriors(feats, posts, 5)
    got = tsre.full_ubm_from_posteriors(feats, posts, 5, device="cpu")
    for f in ("weights", "means", "covars"):
        w = getattr(want, f)
        np.testing.assert_allclose(getattr(got, f), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())
    assert np.all(np.linalg.eigvalsh(got.covars[4]) > 0)


def test_train_diag_ubm_on_the_cpu_is_jaxs_host_code(corpus):
    data, _cm, _s = corpus
    x = _pooled(data)
    opts = dict(num_gauss=8, num_iters=2)
    want = jubm.train_diag_ubm(x, jubm.DiagUbmTrainOpts(**opts))
    for dev in ("cpu", "cuda"):
        got = tubm.train_diag_ubm(x, tubm.DiagUbmTrainOpts(**opts),
                                  device=dev, host_numpy=True)
        for f in ("weights", "means", "vars"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.fixture(scope="module")
def systems(corpus):
    data, cm, (train, enroll, test, trials) = corpus
    out = {}
    for name, kw, opts in (
            ("v1", {}, dict(num_gauss=8, ivector_dim=8, use_vad=False)),
            ("v2", dict(post_fn=_post_fn(cm), num_post_classes=4),
             dict(num_gauss=4, ivector_dim=8, use_vad=False))):
        j = jsre.train_sre_system(train, jsre.SrePipelineOpts(**opts), **kw)
        t = tsre.train_sre_system(train, tsre.SrePipelineOpts(**opts),
                                  device="cpu", **kw)
        out[name] = (j, t, jsre.evaluate_sre(j, enroll, test, trials),
                     tsre.evaluate_sre(t, enroll, test, trials))
    return out


@pytest.mark.parametrize("name,rel", [("v1", 1e-3), ("v2", 1e-8)])
def test_sre_pipeline_equals_jax(systems, corpus, name, rel):
    _j, t, (jeer, jsc), (teer, tsc) = systems[name]
    assert teer == jeer
    assert teer < 0.15
    assert list(tsc) == list(jsc) and len(tsc) == len(corpus[2][3])
    want = np.array([jsc[k] for k in jsc])
    np.testing.assert_allclose([tsc[k] for k in jsc], want, rtol=0,
                               atol=rel * np.abs(want).max())
    assert t.ubm.num_gauss == (8 if name == "v1" else 4)


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_carried_sre_system_scores_as_jax(systems, corpus, name):
    j, _t, (jeer, jsc), _tres = systems[name]
    _data, _cm, (_tr, enroll, test, trials) = corpus
    carried = sre_system_from_jax(j, device="cpu")
    assert carried.opts == tsre.SrePipelineOpts(**{
        **j.opts.__dict__, "vad": tsre.VadOpts(**j.opts.vad.__dict__)})
    eer, sc = tsre.evaluate_sre(carried, enroll, test, trials)
    want = np.array([jsc[k] for k in jsc])
    np.testing.assert_allclose([sc[k] for k in jsc], want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert eer == jeer
    f = enroll[next(iter(enroll))]
    np.testing.assert_allclose(carried.ivector(f), j.ivector(f), rtol=0,
                               atol=1e-6 * np.abs(j.ivector(f)).max())


def test_sre_with_vad_equals_jax(corpus):
    """use_vad=True with an energy column that drops some frames: the same
    voiced frames as JAX's VAD. v2 trained on them (posteriors supplied,
    f64 throughout) gives JAX's EER and scores within 1e-8 of the largest,
    and a v1 system carried across from JAX scores with JAX's EER. v1
    trained by each package is not compared here: the voiced frames'
    energy column is constant, so its variance is f32 rounding noise on
    both sides and the diag UBM's EM ends in another optimum when the
    posteriors are summed in another order."""
    from kaldi_tpu.ivector import vad as jvad
    data, cm, _s = corpus
    rng = np.random.RandomState(5)
    loud = {s: [(f.copy(), c) for f, c in us] for s, us in data.items()}
    for us in loud.values():
        for f, _c in us:
            f[:, 0] = np.where(rng.rand(len(f)) < 0.8, 12.0, -3.0)
    train, enroll, test, trials = _split(loud)
    kw = dict(post_fn=_post_fn(cm), num_post_classes=4)
    opts = dict(num_gauss=4, ivector_dim=8, use_vad=True)
    j = jsre.train_sre_system(train, jsre.SrePipelineOpts(**opts), **kw)
    t = tsre.train_sre_system(train, tsre.SrePipelineOpts(**opts),
                              device="cpu", **kw)
    jopts = j.opts.vad
    for f in [f for us in train.values() for f in us] + list(test.values()):
        want = jvad.select_voiced_frames(f, jvad.compute_vad(f, jopts))
        assert 0 < len(want) < len(f)
        np.testing.assert_array_equal(t.voiced(f), want)
    jeer, jsc = jsre.evaluate_sre(j, enroll, test, trials)
    teer, tsc = tsre.evaluate_sre(t, enroll, test, trials)
    assert teer == jeer
    want = np.array([jsc[k] for k in jsc])
    np.testing.assert_allclose([tsc[k] for k in jsc], want, rtol=0,
                               atol=1e-8 * np.abs(want).max())
    j1 = jsre.train_sre_system(train, jsre.SrePipelineOpts(
        num_gauss=8, ivector_dim=8, use_vad=True))
    carried = sre_system_from_jax(j1, device="cpu")
    assert carried.opts.use_vad
    assert tsre.evaluate_sre(carried, enroll, test, trials)[0] == \
        jsre.evaluate_sre(j1, enroll, test, trials)[0]


def test_plda_ivectors_take_a_second_vad_pass_as_in_jax(corpus):
    """JAX trains the PLDA on `SreSystem.ivector` of the already voiced
    training frames, which runs the VAD again: with an energy column that
    varies among the voiced frames the second pass drops more of them.
    v2 (posteriors supplied, f64 throughout) gives JAX's PLDA within 1e-8
    and JAX's EER and scores within 1e-8 of the largest."""
    data, cm, _s = corpus
    rng = np.random.RandomState(6)
    loud = {s: [(f.copy(), c) for f, c in us] for s, us in data.items()}
    for us in loud.values():
        for f, _c in us:
            f[:, 0] = np.where(rng.rand(len(f)) < 0.8,
                               12.0 + 3.0 * rng.randn(len(f)), -3.0)
    train, enroll, test, trials = _split(loud)
    kw = dict(post_fn=_post_fn(cm), num_post_classes=4)
    opts = dict(num_gauss=4, ivector_dim=8, use_vad=True)
    j = jsre.train_sre_system(train, jsre.SrePipelineOpts(**opts), **kw)
    t = tsre.train_sre_system(train, tsre.SrePipelineOpts(**opts),
                              device="cpu", **kw)
    once = [t.voiced(f) for us in train.values() for f in us]
    assert all(len(t.voiced(f)) < len(f) for f in once)
    for f in ("mean", "transform", "psi"):
        w = getattr(j.plda, f)
        np.testing.assert_allclose(getattr(t.plda, f), w, rtol=0,
                                   atol=1e-8 * np.abs(w).max())
    jeer, jsc = jsre.evaluate_sre(j, enroll, test, trials)
    teer, tsc = tsre.evaluate_sre(t, enroll, test, trials)
    assert teer == jeer
    want = np.array([jsc[k] for k in jsc])
    np.testing.assert_allclose([tsc[k] for k in jsc], want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


def test_chip_smoke_copies_the_corpus():
    """chip_smoke.py's copy of `_make_corpus`, `_split` and the oracle
    posteriors (phase 25 and the card-only tests use it) equals this
    test's."""
    import chip_smoke as cs
    want, wcm = _make_corpus(np.random.RandomState(0))
    got, gcm = cs.sre_small_corpus(np.random.RandomState(0))
    np.testing.assert_array_equal(gcm, wcm)
    for s in want:
        for (f, c), (g, d) in zip(want[s], got[s]):
            np.testing.assert_array_equal(g, f)
            np.testing.assert_array_equal(d, c)
    gs, ws = cs.sre_small_split(got), _split(want)
    assert gs[3] == ws[3]
    for a, b in zip(gs[:3], ws[:3]):
        assert list(a) == list(b)
    f = want["spk0"][0][0]
    np.testing.assert_array_equal(cs.sre_oracle_post_fn(gcm)(f),
                                  _post_fn(wcm)(f))
