"""Port parity: the port's host copies of kaldi_tpu/fst/text_io.py,
special.py and factor.py against JAX's on the same FSTs: text files
byte-equal both ways, phi / rho composition, push-special and prop-final
with equal states, arcs and weights (1e-6), factoring on
tests/test_fstbin_cli.py's chains."""

import io

import numpy as np
import pytest

from kaldi_tpu.fst import factor as jfactor
from kaldi_tpu.fst import fst as jfst
from kaldi_tpu.fst import special as jspecial
from kaldi_tpu.fst import text_io as jtext
from kaldi_tpu_torch.fst import factor as tfactor
from kaldi_tpu_torch.fst import fst as tfst
from kaldi_tpu_torch.fst import special as tspecial
from kaldi_tpu_torch.fst import text_io as ttext

PHI = 99


def _build(mod, arcs, finals, start=0, n=None):
    f = mod.Fst()
    n = n or 1 + max([max(s, d) for (s, _i, _o, _w, d) in arcs]
                     + list(finals))
    for _ in range(n):
        f.add_state()
    f.start = start
    for (s, i, o, w, d) in arcs:
        f.add_arc(s, i, o, w, d)
    for s, w in finals.items():
        f.set_final(s, w)
    return f


def _both(arcs, finals, **kw):
    return _build(jfst, arcs, finals, **kw), _build(tfst, arcs, finals, **kw)


def _assert_fst_close(a, b, tol=1e-6):
    assert a.start == b.start and a.num_states == b.num_states
    for s in range(a.num_states):
        x, y = a.arcs[s], b.arcs[s]
        assert [(i, o, d) for (i, o, _w, d) in x] == \
            [(i, o, d) for (i, o, _w, d) in y], s
        np.testing.assert_allclose([w for (_i, _o, w, _d) in x],
                                   [w for (_i, _o, w, _d) in y],
                                   rtol=0, atol=tol)
    assert sorted(a.finals) == sorted(b.finals)
    for s in a.finals:
        assert a.finals[s] == pytest.approx(b.finals[s], abs=tol)


def _random_fst(mod, seed, n=12, labels=6):
    rng = np.random.RandomState(seed)
    arcs = [(int(rng.randint(n)), int(rng.randint(1, labels)),
             int(rng.randint(0, labels)), float(np.round(rng.rand() * 3, 3)),
             int(rng.randint(n))) for _ in range(3 * n)]
    finals = {int(s): float(np.round(rng.rand(), 3))
              for s in rng.choice(n, 3, replace=False)}
    return _build(mod, arcs, finals, n=n)


SYMS = "<eps> 0\na 1\nb 2\nc 3\nd 4\ne 5\n"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_io_round_trips_byte_equal(seed, tmp_path):
    syms = tmp_path / "syms.txt"
    syms.write_text(SYMS)
    assert ttext.read_symbols(str(syms)) == jtext.read_symbols(str(syms))
    table = ttext.read_symbols(str(syms))
    j, t = _random_fst(jfst, seed), _random_fst(tfst, seed)
    for isym, osym in ((None, None), (table, table)):
        bj, bt = io.StringIO(), io.StringIO()
        jtext.write_fst_text(bj, j, isym, osym)
        ttext.write_fst_text(bt, t, isym, osym)
        assert bt.getvalue() == bj.getvalue()
        # each package reads the other's text to the same FST
        rj = jtext.read_fst_text(io.StringIO(bt.getvalue()), isym, osym)
        rt = ttext.read_fst_text(io.StringIO(bj.getvalue()), isym, osym)
        assert (rt.start, rt.arcs, rt.finals) == (rj.start, rj.arcs,
                                                  rj.finals)
    pj, pt = str(tmp_path / "j.fst"), str(tmp_path / "t.fst")
    jtext.save_fst(pj, j)
    ttext.save_fst(pt, t)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    lj = jtext.load_fst(pt, str(syms), str(syms))
    lt = ttext.load_fst(pj, str(syms), str(syms))
    assert (lt.start, lt.arcs, lt.finals) == (lj.start, lj.arcs, lj.finals)


def _linear(mod, labels):
    return _build(mod, [(k, l, l, 0.0, k + 1) for k, l in enumerate(labels)],
                  {len(labels): 0.0})


BACKOFF = ([(0, 1, 1, 1.0, 1), (0, 2, 2, 2.0, 0), (1, 2, 2, 0.1, 0),
            (1, PHI, 0, 0.5, 0)], {0: 0.3})
PRICIER = ([(0, 1, 1, 1.0, 1), (0, 2, 2, 0.05, 0), (1, 2, 2, 0.9, 0),
            (1, PHI, 0, 0.0, 0)], {0: 0.0})


@pytest.mark.parametrize("g", [BACKOFF, PRICIER])
@pytest.mark.parametrize("labels", [[1, 2], [1, 1], [1], [2, 1, 2, 2]])
def test_phi_compose_equal(g, labels):
    jg, tg = _both(*g)
    out_j = jspecial.phi_compose(_linear(jfst, labels), jg, PHI)
    out_t = tspecial.phi_compose(_linear(tfst, labels), tg, PHI)
    _assert_fst_close(out_j, out_t)
    rj, rt = out_j.shortest_path(), out_t.shortest_path()
    assert rt[:2] == rj[:2] and rt[2] == pytest.approx(rj[2], abs=1e-6)


CYCLIC = ([(0, 1, 1, 2.0, 1), (1, 2, 2, 1.0, 1), (1, 3, 3, 3.0, 0)],
          {1: 4.0})


@pytest.mark.parametrize("which", ["cyclic", 3, 4])
def test_push_special_equal(which):
    if which == "cyclic":
        j, t = _both(*CYCLIC)
    else:
        j, t = _random_fst(jfst, which), _random_fst(tfst, which)
    _assert_fst_close(jspecial.push_special(j), tspecial.push_special(t))


def test_rho_compose_and_prop_final_equal():
    a = ([(0, 5, 5, 0.0, 1), (1, 7, 7, 0.0, 2)], {2: 0.0})
    b = ([(0, 5, 5, 0.5, 1), (1, 100, 100, 1.5, 2)], {2: 0.0})
    (ja, ta), (jb, tb) = _both(*a), _both(*b)
    out_j = jspecial.rho_compose(ja, jb, 100)
    out_t = tspecial.rho_compose(ta, tb, 100)
    _assert_fst_close(out_j, out_t)
    assert out_t.shortest_path()[1] == [5, 7]
    pf = ([(0, 42, 0, 0.5, 1), (1, 42, 0, 0.25, 2), (0, 3, 3, 1.0, 2)],
          {2: 1.0})
    j, t = _both(*pf)
    gj, gt = jspecial.prop_final(j, 42), tspecial.prop_final(t, 42)
    _assert_fst_close(gj, gt)
    assert gt.final(0) == pytest.approx(1.75)


def test_factor_equal():
    chains = [(0, 1, 1), (1, 2, 2), (2, 3, 3), (3, 4, 8), (0, 5, 4),
              (4, 6, 5), (5, 7, 8)]
    arcs = [(s, il, 0, 0.25, d) for (s, il, d) in chains]
    j, t = _both(arcs, {8: 0.0})
    (fj, ej), (ft, et) = jfactor.factor(j), tfactor.factor(t)
    _assert_fst_close(fj, ft)
    _assert_fst_close(ej, et)
    assert ft.num_arcs < t.num_arcs
    from kaldi_tpu_torch.fst.compose import compose
    recon = compose(et, ft)
    assert recon.shortest_path()[2] == pytest.approx(
        t.shortest_path()[2], abs=1e-9)
