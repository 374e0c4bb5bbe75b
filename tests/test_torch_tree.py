"""Port parity: the host copies of kaldi_tpu/tree/ (event maps, Gaussian
clustering, questions, tree building, tree statistics and the tree's
context dependency) give JAX's results exactly, on seeded statistics and
on the same alignments. The trees are compared node for node (kind, key,
question set, table order, answers): the greedy splits depend on the heap
and dict orders, so any drift in them shows here."""

import numpy as np
import pytest

import chip_smoke as cs
from kaldi_tpu.decoder.graph_pack import pack_graphs as jpack_graphs
from kaldi_tpu.decoder.viterbi import equal_align as jequal_align
from kaldi_tpu.fst.graph import TrainingGraphCompiler as JCompiler
from kaldi_tpu.fst.lang import Lexicon as JLexicon, prepare_lang as jprepare
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.tree import build_tree as jbt
from kaldi_tpu.tree import clustering as jcl
from kaldi_tpu.tree import context_dep as jctx
from kaldi_tpu.tree import event_map as jem
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.params import event_map_from_jax
from kaldi_tpu_torch.tree import build_tree as tbt
from kaldi_tpu_torch.tree import clustering as tcl
from kaldi_tpu_torch.tree import context_dep as tctx
from kaldi_tpu_torch.tree import event_map as tem

PHONES = list(range(1, 9))


def assert_trees_equal(a, b):
    """Node for node: the same kinds, keys, question sets, table orders
    and answers (`chip_smoke.trees_equal`)."""
    assert cs.trees_equal(a, b)


def _random_tree(mod, rng, depth=0):
    """A random event map of `mod`'s classes, the draws from `rng`."""
    r = rng.randint(3) if depth < 4 else 0
    if r == 0:
        return mod.ConstantEventMap(int(rng.randint(50)))
    key = int(rng.randint(-1, 3))
    if r == 1:
        vals = rng.choice(9, rng.randint(1, 4), replace=False)
        return mod.TableEventMap(key, {int(v): _random_tree(mod, rng, depth + 1)
                                       for v in vals})
    yes = frozenset(int(v) for v in rng.choice(9, 3, replace=False))
    return mod.SplitEventMap(key, yes, _random_tree(mod, rng, depth + 1),
                             _random_tree(mod, rng, depth + 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_maps_equal(seed):
    jt = _random_tree(jem, np.random.RandomState(seed))
    tt = _random_tree(tem, np.random.RandomState(seed))
    assert_trees_equal(jt, tt)
    assert_trees_equal(jt, event_map_from_jax(jt))
    other = _random_tree(tem, np.random.RandomState(seed + 10))
    assert not cs.trees_equal(jt, other)
    assert not cs.trees_equal(jt, tem.map_leaves(tt, lambda a: a + 1))
    rng = np.random.RandomState(100 + seed)
    for _ in range(200):
        keys = [k for k in (-1, 0, 1, 2) if rng.rand() < 0.8]
        ev = {k: int(rng.randint(9)) for k in keys}
        assert tt.map(ev) == jt.map(ev)
        assert tt.multi_map(ev) == jt.multi_map(ev)
    assert tt.max_answer() == jt.max_answer()
    assert tem.collect_leaves(tt) == jem.collect_leaves(jt)
    assert_trees_equal(jem.map_leaves(jt, lambda a: 3 * a + 1),
                       tem.map_leaves(tt, lambda a: 3 * a + 1))
    assert tem.KPDF_CLASS == jem.KPDF_CLASS == -1


def _gauss_stats(seed: int, n: int, dim: int = 4):
    """n (count, x, x2) triples of samples around a few centres."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        c = rng.randn(dim) * 3.0 * (i % 3)
        x = c + rng.randn(40, dim) * rng.uniform(0.2, 1.0)
        out.append((40.0, x.sum(0), (x * x).sum(0)))
    return out


def _as_stats(mod, triples):
    return [mod.GaussStats(count=c, x=x.copy(), x2=x2.copy())
            for c, x, x2 in triples]


def _stats_equal(a, b):
    assert a.count == b.count and a.var_floor == b.var_floor
    assert np.array_equal(a.x, b.x) and np.array_equal(a.x2, b.x2)


@pytest.mark.parametrize("fn", ["cluster_bottom_up", "cluster_kmeans",
                                "tree_cluster"])
def test_clustering_equal(fn):
    triples = _gauss_stats(3, 14)
    kw = {"cluster_bottom_up": dict(min_clust=3),
          "cluster_kmeans": dict(num_clust=4, seed=5),
          "tree_cluster": dict(max_clust=6)}[fn]
    j = getattr(jcl, fn)(_as_stats(jcl, triples), **kw)
    t = getattr(tcl, fn)(_as_stats(tcl, triples), **kw)
    if fn == "tree_cluster":
        assert t == j
        return
    assert t[1] == j[1]
    assert len(t[0]) == len(j[0])
    for a, b in zip(j[0], t[0]):
        _stats_equal(a, b)
    js, ts = _as_stats(jcl, triples), _as_stats(tcl, triples)
    assert ts[0].objf() == js[0].objf()
    assert ts[0].distance(ts[1]) == js[0].distance(js[1])
    _stats_equal(jcl.sum_stats(js), tcl.sum_stats(ts))


def _tree_stats(mod, seed: int = 7, dim: int = 5):
    """Seeded tree statistics {event: GaussStats} over PHONES in triphone
    windows (0 = the utterance edge), pdf classes 0-2; phone 8 is a
    silence (context-independent windows). The means depend on the
    centre phone's group, the pdf class and the left context."""
    rng = np.random.RandomState(seed)
    stats = {}
    for _ in range(160):
        left, right = (int(v) for v in rng.randint(0, 9, 2))
        centre = int(rng.randint(1, 9))
        if centre == 8:
            left = right = 0
        for pc in range(3):
            ev = frozenset([(jem.KPDF_CLASS, pc), (0, left), (1, centre),
                            (2, right)])
            n = int(rng.randint(5, 30))
            mean = (np.full(dim, 2.0 * (centre % 3) + pc)
                    + 0.7 * (left % 2))
            x = mean + rng.randn(n, dim) * 0.5
            st = stats.get(ev)
            new = mod.GaussStats(count=float(n), x=x.sum(0),
                                 x2=(x * x).sum(0))
            stats[ev] = new if st is None else st.add(new)
    return stats


def test_obtain_questions_equal():
    assert (tbt.obtain_questions(_tree_stats(tcl))
            == jbt.obtain_questions(_tree_stats(jcl)))


BUILDS = [dict(max_leaves=12, thresh=5.0, cluster_thresh=-1.0),
          dict(max_leaves=60, thresh=1.0, cluster_thresh=0.0),
          dict(max_leaves=30, thresh=2.0, cluster_thresh=None, sil=True)]


def _build(mod, cl, kw):
    kw = dict(kw)
    sil = kw.pop("sil", False)
    stats = _tree_stats(cl)
    questions = mod.Questions(mod.obtain_questions(stats),
                              num_pdf_classes=3)
    phone_sets = [[p] for p in PHONES]
    do_split = [not (sil and p == 8) for p in PHONES]
    return mod.build_tree(stats, questions, phone_sets,
                          {p: 3 for p in PHONES}, None, do_split, **kw)


@pytest.mark.parametrize("kw", BUILDS, ids=["clustered", "unclustered",
                                            "silence-not-split"])
def test_build_tree_equal(kw):
    jtree, jn = _build(jbt, jcl, kw)
    ttree, tn = _build(tbt, tcl, kw)
    assert tn == jn > 3
    assert_trees_equal(jtree, ttree)


def test_tree_context_dependency_compute_equal():
    jtree, n = _build(jbt, jcl, BUILDS[0])
    j = jctx.TreeContextDependency(3, 1, jtree, n)
    t = tctx.TreeContextDependency(3, 1, event_map_from_jax(jtree), n)
    assert (t.context_width, t.central_position, t.num_pdfs) == \
        (j.context_width, j.central_position, j.num_pdfs)
    seen = set()
    for left in range(9):
        for centre in range(9):
            for right in range(9):
                for pc in range(3):
                    w = [left, centre, right]
                    try:
                        want = j.compute(w, pc)
                    except ValueError:
                        with pytest.raises(ValueError):
                            t.compute(w, pc)
                        continue
                    assert t.compute(w, pc) == want
                    seen.add(want)
    assert seen == set(range(n))


def test_accumulate_tree_stats_equal():
    """The same alignments (JAX's equal alignment of yesno-like triphone
    training graphs) and features through both packages' statistics."""
    rng = np.random.RandomState(11)
    utts = cs.tri_corpus(rng, 6, lambda w: cs.mfcc_deltas(w, "cpu"))
    jl = jprepare(JLexicon.parse(cs.TRI_LEXICON), ["SIL"], "SIL",
                  num_sil_states=3)
    tl = prepare_lang(Lexicon.parse(cs.TRI_LEXICON), ["SIL"], "SIL",
                      num_sil_states=3)
    jc = jctx.MonophoneContextDependency.from_topo(jl.topo)
    jtm = JTm(jl.topo, lambda ph, pc: jc.compute([ph], pc))
    tc = tctx.MonophoneContextDependency.from_topo(tl.topo)
    ttm = TransitionModel(tl.topo, lambda ph, pc: tc.compute([ph], pc))
    comp = JCompiler(jl, jtm, jc)
    feats, nf = cs.pad_batch([f for _u, f, _w in utts])
    batch = jpack_graphs([comp.compile_transcript(w) for _u, _f, w in utts],
                         jtm.id2pdf_array)
    sil = {jl.phones["SIL"]}
    jstats, tstats = {}, {}
    for b, res in enumerate(jequal_align(batch, nf)):
        tids = res[0]
        jbt.accumulate_tree_stats(feats[b, :nf[b]], tids, jtm,
                                  ci_phones=sil, stats=jstats)
        tbt.accumulate_tree_stats(feats[b, :nf[b]], tids, ttm,
                                  ci_phones=sil, stats=tstats)
    assert list(tstats) == list(jstats) and len(jstats) > 20
    for ev in jstats:
        _stats_equal(jstats[ev], tstats[ev])
