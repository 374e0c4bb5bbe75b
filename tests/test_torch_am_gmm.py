"""Port parity: kaldi_tpu_torch's AmDiagGmm, GMM statistics and updates, and
decodable functions against kaldi_tpu's, on the CPU.

The GMMs are random with uneven component counts (one pdf with 1 gaussian,
one with 40). Tolerances: log-likelihoods, aligned posteriors and the
accumulated statistics within rtol 1e-5 (the two packages' exp, log and
reduction orders differ in the last bits); the numpy updates
(`mle_diag_gmm_update`, `map_diag_gmm_update`, `split_by_count`) on the
same statistics within rtol 1e-6; the decodable functions exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.decoder import decodable as jdec
from kaldi_tpu.gmm import am_gmm as jam
from kaldi_tpu.gmm import diag_gmm as jdg
from kaldi_tpu.gmm import estimation as jest
from kaldi_tpu_torch.decoder import decodable as tdec
from kaldi_tpu_torch.gmm import am_gmm as tam
from kaldi_tpu_torch.gmm import diag_gmm as tdg
from kaldi_tpu_torch.gmm import estimation as t_est
from kaldi_tpu_torch.nnet.combine import _group_table

torch.set_num_threads(2)

COUNTS = [1, 40, 3, 7, 2, 12]
D = 6
RTOL = 1e-5


def _gmm_arrays(rng, m):
    w = rng.dirichlet(np.ones(m))
    mu = rng.randn(m, D) * 2.0
    var = rng.uniform(0.3, 2.0, (m, D))
    return w, mu, var


@pytest.fixture(scope="module")
def ams():
    rng = np.random.RandomState(0)
    arrays = [_gmm_arrays(rng, m) for m in COUNTS]
    j = jam.AmDiagGmm([jdg.DiagGmm(*a) for a in arrays])
    t = tam.AmDiagGmm([tdg.DiagGmm(*a) for a in arrays], device="cpu")
    feats = (rng.randn(3, 25, D) * 2.0).astype(np.float32)
    return j, t, feats


def test_loglikes_match_jax(ams):
    j, t, feats = ams
    assert t.total_gauss == j.total_gauss == sum(COUNTS)
    for p_j, p_t in zip(j.pack(), t.pack()):
        np.testing.assert_array_equal(p_j, p_t)
    for scale in (1.0, 0.1):
        want = j.loglikes_np(feats, scale)
        got = t.loglikes(feats, scale)
        assert got.dtype == torch.float32 and got.shape == (3, 25, 6)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(t.loglikes_np(feats[0]), j.loglikes_np(feats[0]),
                               rtol=RTOL, atol=RTOL)


def test_empty_segment_scores_as_in_jax():
    """A pdf with no gaussian scores log(1e-37) over a max of 0."""
    seg = np.array([2, 0, 2, 1, 2, 0], np.int32)
    table = _group_table(seg, 4)
    x = torch.zeros((1, 2, 2))
    packed = torch.zeros((5, 6))
    got = tam._am_loglikes(x, packed, torch.as_tensor(seg.astype(np.int64)),
                           torch.as_tensor(table), 1.0)
    np.testing.assert_allclose(got[0, 0, 3].item(), np.log(np.float32(1e-37)),
                               rtol=1e-6)


def _alignment(rng, T):
    pdf = rng.randint(0, len(COUNTS), T)
    w = rng.uniform(0.2, 1.0, T).astype(np.float32)
    return pdf, w


def test_aligned_posteriors_match_jax(ams):
    j, t, feats = ams
    rng = np.random.RandomState(1)
    x = feats[0]
    pdf, w = _alignment(rng, len(x))
    packed, seg = j.pack()
    want_post, want_ll = jest._aligned_posteriors(
        jnp.asarray(x), jnp.asarray(pdf), jnp.asarray(w), jnp.asarray(packed),
        jnp.asarray(seg))
    tp, ts, _ = t.device_pack()
    got_post, got_ll = t_est._aligned_posteriors(
        torch.from_numpy(x), torch.from_numpy(pdf.astype(np.int64)),
        torch.from_numpy(w), tp, ts)
    np.testing.assert_allclose(got_post.numpy(), np.asarray(want_post),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got_ll.item(), float(want_ll), rtol=RTOL)


def _acc_pair(ams, soft: bool):
    j, t, feats = ams
    rng = np.random.RandomState(2)
    ja, ta = jest.AccumAmDiagGmm(j), t_est.AccumAmDiagGmm(t)
    for b in range(feats.shape[0]):
        T = 25 - 4 * b              # uneven lengths: JAX pads these to 32
        x = feats[b, :T]
        if soft:
            post = [[(int(p), float(q)), (int((p + 1) % 6), 1.0 - float(q))]
                    for p, q in zip(*_alignment(rng, T))]
            ja.accumulate_from_posteriors(j, x, post)
            ta.accumulate_from_posteriors(t, x, post)
        else:
            pdf, w = _alignment(rng, T)
            ja.accumulate_from_alignment(j, x, pdf, w if b else None)
            ta.accumulate_from_alignment(t, x, pdf, w if b else None)
    return ja, ta


@pytest.mark.parametrize("soft", [False, True])
def test_accumulation_matches_jax(ams, soft):
    ja, ta = _acc_pair(ams, soft)
    assert ta.tot_frames == pytest.approx(ja.tot_frames, rel=1e-12)
    assert ta.tot_like == pytest.approx(ja.tot_like, rel=RTOL)
    for a, b in zip(ja.accs, ta.accs):
        for f in ("occ", "mean_acc", "var_acc"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=RTOL, atol=1e-6, err_msg=f)
    assert sum(a.occ.sum() for a in ta.accs) > 0


def _copy_acc(acc):
    out = t_est.AccumDiagGmm(len(acc.occ), acc.mean_acc.shape[1])
    out.occ[:], out.mean_acc[:], out.var_acc[:] = (acc.occ, acc.mean_acc,
                                                   acc.var_acc)
    return out


def _same_gmm(a, b, rtol):
    for f in ("weights", "means", "vars"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=rtol,
                                   err_msg=f)


def test_updates_and_split_match_jax(ams):
    j, t, _feats = ams
    ja, _ta = _acc_pair(ams, soft=False)
    for i, acc in enumerate(ja.accs):
        tacc = _copy_acc(acc)
        for kw in (dict(min_gaussian_occupancy=0.5), dict(update_vars=False)):
            _same_gmm(jest.mle_diag_gmm_update(j.pdfs[i], acc, **kw),
                      t_est.mle_diag_gmm_update(t.pdfs[i], tacc, **kw), 1e-6)
        kw = dict(update_weights=True, update_vars=True)
        _same_gmm(jest.map_diag_gmm_update(j.pdfs[i], acc, **kw),
                  t_est.map_diag_gmm_update(t.pdfs[i], tacc, **kw), 1e-6)
    jc, tc = j.copy(), t.copy()
    assert tc.device == t.device
    occs = np.array([a.occ.sum() for a in ja.accs]) * 10
    jc.split_by_count(80, 0.01, 0.25, min_count=5.0, occs=occs)
    tc.split_by_count(80, 0.01, 0.25, min_count=5.0, occs=occs)
    assert tc.total_gauss == jc.total_gauss > t.total_gauss
    for a, b in zip(jc.pdfs, tc.pdfs):
        _same_gmm(a, b, 1e-6)
    feats = ams[2]
    np.testing.assert_allclose(tc.loglikes_np(feats), jc.loglikes_np(feats),
                               rtol=RTOL, atol=RTOL)


def test_decodable_functions_match_jax():
    rng = np.random.RandomState(3)
    ll = rng.randn(2, 7, 5).astype(np.float32)
    id2pdf = np.array([-1, 0, 0, 3, 4, 2, 1, 1, 4], np.int32)
    tl = torch.from_numpy(ll)
    np.testing.assert_array_equal(tdec.scale_loglikes(tl, 0.1).numpy(),
                                  np.asarray(jdec.scale_loglikes(ll, 0.1)))
    got = tdec.map_loglikes(tl, id2pdf, 0.1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdec.map_loglikes(jnp.asarray(ll), id2pdf, 0.1)))
    np.testing.assert_array_equal(got[..., 0].numpy(),
                                  0.1 * ll[..., 0])      # tid 0 -> column 0
    imap = np.array([4, 4, 0, 2])
    np.testing.assert_array_equal(
        tdec.index_map_loglikes(tl, imap).numpy(),
        np.asarray(jdec.index_map_loglikes(jnp.asarray(ll), imap)))
    ll2 = rng.randn(2, 7, 5).astype(np.float32)
    for scales in (None, [0.5, 2.0]):
        np.testing.assert_array_equal(
            tdec.sum_loglikes([tl, torch.from_numpy(ll2)], scales).numpy(),
            np.asarray(jdec.sum_loglikes([jnp.asarray(ll), jnp.asarray(ll2)],
                                         scales)))
    with pytest.raises(ValueError):
        tdec.sum_loglikes([tl, tl], [1.0])


def test_am_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        tam.AmDiagGmm([tdg.DiagGmm(*_gmm_arrays(np.random.RandomState(0), 2))])
