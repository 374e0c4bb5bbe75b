"""Port parity: the EBW updates (kaldi_tpu_torch.gmm.ebw) and discriminative
GMM training (steps.mmi) against kaldi_tpu's, on the CPU.

- The EBW updates from the same statistics are exact: the module is host
  numpy, copied verbatim.
- One `train_discriminative` iteration (MMI and sMBR) from the same model,
  the same denominator lattices and the same loglikes: the same
  alignment, objective and lattice posteriors; the num and den
  statistics within the bound that the two packages' component loglikes
  set on the gaussian posteriors (`chip_smoke.softmax_shift_bound`); the
  port's EBW update of JAX's statistics equal to JAX's.
- The bound that chip_smoke.py phase 21 holds the card to
  (`disc_stats_card_vs_cpu`) holds for a moved AM on the CPU.
- A whole 3-iteration bMMI run of each package on its own lattices
  (tests/test_discriminative.py's options, 8 utterances): the objective
  per frame within 1e-4 of JAX's at every iteration (the f32 loglikes
  differ in their last bits; observed 1.4e-6), and the same decoded words
  and WER on the test set.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder as JBeam,
                                           BeamSearchOpts as JBeamOpts)
from kaldi_tpu.decoder.graph_pack import pack_graph as jpack_graph
from kaldi_tpu.gmm import ebw as jebw
from kaldi_tpu.gmm.am_gmm import AmDiagGmm as JAm
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiag
from kaldi_tpu.gmm import estimation as jest
from kaldi_tpu.gmm.estimation import (AccumAmDiagGmm as JAccAm,
                                      AccumDiagGmm as JAcc)
from kaldi_tpu.steps import mmi as jmmi
from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.graph_pack import pack_graph
from kaldi_tpu_torch.decoder.viterbi import viterbi_align
from kaldi_tpu_torch.gmm import ebw as tebw
from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm, _augment
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.estimation import AccumAmDiagGmm, AccumDiagGmm
from kaldi_tpu_torch.params import lattice_from_jax
from kaldi_tpu_torch.transform.fmllr import _posteriors_np
from kaldi_tpu_torch.steps import mmi as tmmi
from kaldi_tpu_torch.steps.mono import compile_and_pad
from test_torch_lat_posteriors import build_system


@pytest.fixture(scope="module")
def system():
    """The yesno system, its lattices the port's (JAX's copies of them for
    JAX's side)."""
    return build_system(jax_decode=False)


def _stats(rng, M, D, acc_cls, scale):
    """Random but consistent statistics of M gaussians: occupancies, and
    first and second moments of data around the model."""
    acc = acc_cls(M, D)
    occ = rng.uniform(0.0, scale, M)
    mean = rng.randn(M, D)
    var = rng.uniform(0.2, 2.0, (M, D))
    acc.occ = occ.copy()
    acc.mean_acc = occ[:, None] * mean
    acc.var_acc = occ[:, None] * (var + mean ** 2)
    return acc


def _pair(seed, M=6, D=4):
    """The same GMM and num/den statistics in both packages. Gaussian 0
    has no numerator data (left unchanged without I-smoothing) and
    gaussian 1 a heavy
    denominator (D doubles several times before the variances are
    positive)."""
    rng = np.random.RandomState(seed)
    w = rng.dirichlet(np.ones(M))
    mu = rng.randn(M, D)
    var = rng.uniform(0.3, 2.0, (M, D))
    out = []
    for gcls, acls in ((JDiag, JAcc), (DiagGmm, AccumDiagGmm)):
        r = np.random.RandomState(seed + 1)
        num = _stats(r, M, D, acls, 50.0)
        den = _stats(r, M, D, acls, 40.0)
        num.occ[0] = num.mean_acc[0] = num.var_acc[0] = 0.0
        den.occ[1] *= 20.0
        den.mean_acc[1] *= 20.0
        den.var_acc[1] = den.var_acc[1] * 20.0 + 30.0
        out.append((gcls(w, mu, var), num, den))
    return out


def _gmm_form(g):
    return [np.asarray(g.weights).tolist(), np.asarray(g.means).tolist(),
            np.asarray(g.vars).tolist()]


@pytest.mark.parametrize("E,tau", [(2.0, 0.0), (2.0, 100.0), (1.0, 10.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_ebw_updates_equal_jax(seed, E, tau):
    """I-smoothing, the mean/variance update with its D search, and the
    weight update: exactly JAX's from the same statistics."""
    (jg, jn, jd), (tg, tn, td) = _pair(seed)
    js = jebw.ismooth_stats_diag_gmm(jn, jg, tau)
    ts = tebw.ismooth_stats_diag_gmm(tn, tg, tau)
    for f in ("occ", "mean_acc", "var_acc"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    jnew, jimpr, jcnt = jebw.update_ebw_diag_gmm(
        jg, jn, jd, jebw.EbwOptions(E=E, tau=tau))
    tnew, timpr, tcnt = tebw.update_ebw_diag_gmm(
        tg, tn, td, tebw.EbwOptions(E=E, tau=tau))
    assert _gmm_form(tnew) == _gmm_form(jnew)
    assert (timpr, tcnt) == (jimpr, jcnt)
    if tau == 0.0:             # no numerator data: left unchanged
        assert tnew.means[0].tolist() == tg.means[0].tolist()
    for wt in (10.0, 0.5):
        assert _gmm_form(tebw.update_ebw_weights_diag_gmm(
            tnew, tn, td, wt)) == _gmm_form(jebw.update_ebw_weights_diag_gmm(
                jnew, jn, jd, wt))


@pytest.mark.parametrize("update_weights", [False, True])
def test_ebw_am_update_equals_jax_and_keeps_the_device(update_weights):
    """The whole-AM update, pdf by pdf, equals JAX's; the new AM is on the
    input AM's device."""
    pairs = [_pair(s, M=3 + s) for s in range(4)]
    jam = JAm([p[0][0] for p in pairs])
    tam = AmDiagGmm([p[1][0] for p in pairs], "cpu")
    jnum, jden, tnum, tden = JAccAm(jam), JAccAm(jam), AccumAmDiagGmm(tam), \
        AccumAmDiagGmm(tam)
    jnum.accs = [p[0][1] for p in pairs]
    jden.accs = [p[0][2] for p in pairs]
    tnum.accs = [p[1][1] for p in pairs]
    tden.accs = [p[1][2] for p in pairs]
    opts = dict(E=2.0, tau=50.0, weight_tau=5.0)
    want = jebw.update_ebw_am_diag_gmm(jam, jnum, jden,
                                       jebw.EbwOptions(**opts),
                                       update_weights)
    got = tebw.update_ebw_am_diag_gmm(tam, tnum, tden,
                                      tebw.EbwOptions(**opts),
                                      update_weights)
    assert got.device.type == "cpu"
    assert [_gmm_form(g) for g in got.pdfs] == \
        [_gmm_form(g) for g in want.pdfs]


def test_ebw_moves_toward_the_numerator():
    """tests/test_discriminative.py's EBW check on the port: the mean
    moves toward the numerator data (+2), away from the denominator's."""
    rng = np.random.RandomState(0)
    gmm = DiagGmm(np.array([1.0]), np.zeros((1, 2)), np.ones((1, 2)))
    num, den = AccumDiagGmm(1, 2), AccumDiagGmm(1, 2)
    num.accumulate_from_posteriors(rng.randn(500, 2) + 2.0, np.ones((500, 1)))
    den.accumulate_from_posteriors(rng.randn(300, 2) - 1.0, np.ones((300, 1)))
    new, _impr, cnt = tebw.update_ebw_diag_gmm(
        gmm, num, den, tebw.EbwOptions(E=2.0, tau=0.0))
    assert np.all(new.means > 0.5) and np.all(new.vars > 0) and cnt > 0
    w = tebw.update_ebw_weights_diag_gmm(new, num, den)
    assert abs(w.weights.sum() - 1.0) < 1e-8


def _spy(monkeypatch, module, sink):
    """Record the (num, den) statistics each EBW update of `module` gets."""
    real = module.update_ebw_am_diag_gmm

    def spy(am, num, den, *a, **kw):
        sink.append((num, den))
        return real(am, num, den, *a, **kw)

    monkeypatch.setattr(module, "update_ebw_am_diag_gmm", spy)


@jax.jit
def _jax_comp(x, packed):
    """JAX's component loglikes, as its `_aligned_posteriors` computes
    them."""
    ones = jnp.ones((x.shape[0], 1), jnp.float32)
    aug = jnp.concatenate([x, -0.5 * x * x, ones], axis=-1)
    return jnp.matmul(aug, packed, precision=jax.lax.Precision.HIGHEST)


def _side_bound(am, x, pdfs, u, bound, scale) -> float:
    """Add to `bound` and `scale` what one `accumulate_from_posteriors`
    call of weights u at rows x, pdfs can differ by between JAX and the
    port: each side's component loglikes at JAX's padded shape and the
    port's, the shift bound of the posteriors within each pdf
    (`chip_smoke.softmax_shift_bound`), the weights equal. -> the
    posteriors' largest difference over that bound (must be <= 1)."""
    N = len(x)
    Tp = 1 << max(5, int(np.ceil(np.log2(max(N, 1)))))
    packed, seg = am.pack()
    xp = np.pad(x, ((0, Tp - N), (0, 0)))
    jpost = np.asarray(jest._aligned_posteriors(
        jnp.asarray(xp), jnp.asarray(np.pad(pdfs, (0, Tp - N))),
        jnp.asarray(np.pad(np.ones(N, np.float32), (0, Tp - N))),
        jnp.asarray(packed), jnp.asarray(seg))[0])[:N].astype(np.float64)
    jcomp = np.asarray(_jax_comp(jnp.asarray(xp), jnp.asarray(packed))
                       )[:N].astype(np.float64)
    tcomp = torch.matmul(_augment(torch.as_tensor(x)),
                         torch.as_tensor(packed)).numpy().astype(np.float64)
    tpost = _posteriors_np(am, x, pdfs, np.ones(N, np.float32))
    B, _S = cs.softmax_shift_bound(jcomp, tcomp, jpost,
                                   seg[None, :] == pdfs[:, None])
    cs.weighted_stats_bound(u, np.zeros(N), jpost, B, x, bound, scale)
    return cs._worst(tpost, jpost, B)


def _jax_vs_port_bound(s, ll, align, opts, sil) -> tuple:
    """The bound on one iteration's num and den statistics, JAX's against
    the port's, from the same lattices, alignment and loglikes: their
    signed pdf posteriors are equal (host code), so only the gaussian
    posteriors within each pdf move. -> ({"num": (bound, scale), "den":
    ...}, the posteriors' largest ratio to their bound)."""
    am = s["model"].am
    G, D = am.total_gauss, s["feats"].shape[2]
    out = {side: ([np.zeros(G), np.zeros((G, D)), np.zeros((G, D))],
                  [np.zeros(G), np.zeros((G, D)), np.zeros((G, D))])
           for side in ("num", "den")}
    ratio = 0.0
    for b, lat in enumerate(s["jlats"]):
        if lat is None:
            continue
        post = cs._signed_post(lattice_from_jax(lat), ll[b], align[b][0],
                               s["model"].trans_model, opts, sil)
        for side, sign in (("num", 1.0), ("den", -1.0)):
            keys = [k for k in sorted(post) if sign * post[k] > 0]
            if not keys:
                continue
            x = s["feats"][b, [k[0] for k in keys]]
            u = np.array([sign * post[k] for k in keys])
            ratio = max(ratio, _side_bound(am, x, np.array(
                [k[1] for k in keys]), u, *out[side]))
    return out, ratio


@pytest.mark.parametrize("criterion", ["mmi", "smbr"])
def test_one_iteration_equals_jax(system, monkeypatch, criterion):
    """From the same model, the same (boosted) denominator lattices and
    the same loglikes: the same alignment and lattice posteriors, and so
    statistics that differ only by the gaussian posteriors within each
    pdf. Those are held to the bound that the two packages' component
    loglikes set (each within 1e-5 of its GEMM terms' magnitude, which
    on these narrow MFCC gaussians is up to 3.4e6: the f32 products
    differ by up to a nat, so the statistics cannot agree to 1e-5 of
    their terms). The port's EBW update of JAX's statistics is JAX's AM
    exactly, and the objective per frame is JAX's within 1e-6.

    JAX scores with the port's loglikes here: a lattice sums 0.1 of their
    difference over every frame of a path, which moves its posteriors
    further; those shifts have their own bound (`chip_smoke.
    disc_weight_bound`, `test_discriminative_bound_holds`, phase 21)."""
    s = system
    opts = dict(num_iters=1, boost=0.1, lattice_beam=7.0, criterion=criterion)
    sil = {s["lang"].phones["SIL"]}
    feats = s["feats"]
    ll = s["model"].am.loglikes_np(feats)
    jll = s["jmodel"].am.loglikes_np(feats)
    assert np.max(np.abs(ll - jll) / cs.gmm_term_scale(s["model"].am, feats)
                  ) <= 1e-5
    jlats = [copy.deepcopy(lat) for lat in s["jlats"]]
    monkeypatch.setattr(jmmi, "make_denlats",
                        lambda *a, **k: (None, jlats))
    monkeypatch.setattr(s["jmodel"].am, "loglikes_np",
                        lambda f, scale=1.0: ll)
    jseen, tseen = [], []
    _spy(monkeypatch, jmmi, jseen)
    _spy(monkeypatch, tmmi, tseen)
    jam, jhist = jmmi.train_discriminative(
        s["jmodel"], s["jden"], s["train"], jmmi.MmiTrainOpts(**opts),
        silence_phones=sil)
    stats: list = []
    tlats = [lattice_from_jax(lat) if lat is not None else None
             for lat in s["jlats"]]
    monkeypatch.setattr(tmmi, "make_denlats",
                        lambda *a, **k: (None, tlats))
    tam, thist = tmmi.train_discriminative(
        s["model"], s["den_graph"], s["train"], tmmi.MmiTrainOpts(**opts),
        silence_phones=sil, iter_stats=stats)
    assert tam.device.type == "cpu"
    assert stats[0]["lattices"] == sum(lat is not None for lat in jlats)
    assert stats[0]["align_none"] == 0
    # the boosted lattices are JAX's after its boost
    assert [cs.lattice_form(a) for a in tlats if a is not None] == \
        [cs.lattice_form(lattice_from_jax(a)) for a in jlats if a is not None]
    np.testing.assert_allclose(thist, jhist, rtol=1e-6)

    align = viterbi_align(
        compile_and_pad(s["lang"], s["model"].trans_model,
                             s["model"].ctx_dep, s["train"], 1.0, 0.1)[0],
        ll, s["nf"], 0.1, device="cpu")
    bounds, ratio = _jax_vs_port_bound(
        dict(s, jlats=[lattice_from_jax(a) if a is not None else None
                       for a in jlats]), ll, align,
        tmmi.MmiTrainOpts(**opts), sil)
    assert ratio <= 1.0
    for i, side in enumerate(("num", "den")):
        errs = cs.stats_errs(tseen[0][i], jseen[0][i], *bounds[side])
        assert errs["bound"] <= 1.0, (criterion, side, errs)
    ebw = tebw.update_ebw_am_diag_gmm(
        AmDiagGmm([DiagGmm(p.weights, p.means, p.vars)
                   for p in s["jmodel"].am.pdfs], "cpu"),
        jseen[0][0], jseen[0][1], tebw.EbwOptions())
    assert [_gmm_form(g) for g in ebw.pdfs] == \
        [_gmm_form(g) for g in jam.pdfs]


@pytest.mark.parametrize("criterion", ["mmi", "smbr"])
def test_discriminative_bound_holds(system, criterion):
    """`chip_smoke.disc_stats_card_vs_cpu` on the CPU, with a second AM
    whose weights moved by 1e-3 relative in place of the card's: the
    weights, each statistic and so the bound hold, and are not vacuous
    (the weights reach a tenth of it); with the same AM twice everything
    is equal."""
    s = system
    m = s["model"]
    opts = tmmi.MmiTrainOpts(boost=0.1, lattice_beam=7.0, criterion=criterion)
    sil = {s["lang"].phones["SIL"]}
    batch, feats, nf = compile_and_pad(
        m.lang, m.trans_model, m.ctx_dep, s["train"], 1.0, 0.1)
    align = viterbi_align(batch, m.am.loglikes(feats), nf, 0.1,
                               device="cpu")
    rng = np.random.RandomState(3)
    moved = AmDiagGmm([DiagGmm(p.weights * (1 + 1e-3 * rng.randn(
        p.num_gauss)), p.means, p.vars) for p in m.am.pdfs], "cpu")
    _st, same = cs.disc_stats_card_vs_cpu(m.am, m.am, m.trans_model,
                                          s["tlats"], align, feats, nf,
                                          opts, sil)
    assert same["weight ratio"] == same["num"]["bound"] == \
        same["den"]["bound"] == 0.0
    _st, errs = cs.disc_stats_card_vs_cpu(m.am, moved, m.trans_model,
                                          s["tlats"], align, feats, nf,
                                          opts, sil)
    assert 0.05 <= errs["weight ratio"] <= 1.0, errs
    assert errs["num"]["bound"] <= 1.0 and errs["den"]["bound"] <= 1.0
    assert errs["S"] > 0


def _decode_words(dec, am, feats, nf):
    return [list(r[0]) if r else None for r in dec.decode(
        am.loglikes_np(feats), nf)]


def test_whole_bmmi_run_equals_jax(system):
    """Three bMMI iterations (tests/test_discriminative.py's options) of
    each package from the same model on 8 utterances, each on its own
    denominator lattices: the objective history within 1e-4 of JAX's, and
    the same decoded words and WER on the test set, not worse than the
    model it started from."""
    s = system
    utts = s["train"][:8]
    sil = {s["lang"].phones["SIL"]}
    opts = dict(num_iters=3, boost=0.1, lattice_beam=8.0)
    jam, jhist = jmmi.train_discriminative(
        s["jmodel"], s["jden"], utts, jmmi.MmiTrainOpts(**opts),
        silence_phones=sil)
    tam, thist = tmmi.train_discriminative(
        s["model"], s["den_graph"], utts, tmmi.MmiTrainOpts(**opts),
        silence_phones=sil)
    assert len(thist) == 3 and thist[-1] >= thist[0] - 1e-3
    np.testing.assert_allclose(thist, jhist, rtol=0, atol=1e-4)
    feats, nf = cs.pad_batch([f for _u, f, _w in s["test"]])
    den = dict(beam=16.0, max_active=256, acoustic_scale=0.1)
    jdec = JBeam(jpack_graph(s["jden"].fst,
                             s["jmodel"].trans_model.id2pdf_array),
                 JBeamOpts(**den))
    tdec = BeamSearchDecoder(pack_graph(s["den_graph"].fst,
                                        s["model"].trans_model.id2pdf_array),
                             BeamSearchOpts(**den), device="cpu")
    jw = _decode_words(jdec, jam, feats, nf)
    tw = _decode_words(tdec, tam, feats, nf)
    assert tw == jw
    refs = [ws for _u, _f, ws in s["test"]]
    lang = s["lang"]
    base = cs.wer(refs, [[lang.words.sym(x) for x in w] if w else []
                         for w in _decode_words(tdec, s["model"].am, feats,
                                                nf)])
    got = cs.wer(refs, [[lang.words.sym(x) for x in w] if w else []
                        for w in tw])
    assert got <= base
