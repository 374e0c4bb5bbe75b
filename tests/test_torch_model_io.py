"""Port parity: model files (kaldi_tpu_torch/io/model_io.py) cross between
the JAX package and the port, on the CPU.

For every kind of file that kaldi_tpu/io/model_io.py writes (GMM system,
HCLG, AmNnet with and without mixed-up rows, raw nnet, AmNnet3, i-vector
extractor, const ARPA, diagonal and full UBM, PLDA, GMM accs, tree stats,
tree, SGMM2 and SGMM2 accs):
- JAX's `save_*` -> the port's `load_*(device="cpu")`: the port's object
  holds JAX's arrays bit for bit and computes what JAX's loaded object
  computes, within the tolerance of that module's own parity test (GMM
  loglikes rtol 1e-5 as tests/test_torch_am_gmm.py, TDNN and nnet3 1e-5
  of the output, f64 host objects 1e-12, SGMM 1e-9 as
  tests/test_torch_sgmm.py);
- the port's `save_*` of that object -> the same npz, key for key: the
  same names, dtypes and bytes of every array; pickled
  host payloads (`__host__`) unpickle in JAX to equal objects;
- JAX's `load_*` of the port's file equals JAX's own object.
Pickled host objects also cross from port-native objects (the port's own
lang, monophone context and tree), and an unknown pickled class is
refused both ways.
"""

import io
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.decoder.biggraph import (BigGraphConfig as JBigGraphConfig,
                                        make_big_hclg as jmake_big_hclg)
from kaldi_tpu.fst.fst import SymbolTable as JSymbolTable
from kaldi_tpu.fst.lang import Lexicon as JLexicon, prepare_lang as jprepare
from kaldi_tpu.gmm.am_gmm import AmDiagGmm as JAmDiagGmm
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiagGmm
from kaldi_tpu.gmm.estimation import AccumAmDiagGmm as JAccAm
from kaldi_tpu.gmm.full_gmm import FullGmm as JFullGmm
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.io import model_io as J
from kaldi_tpu.ivector.extractor import IvectorExtractor as JExtractor
from kaldi_tpu.ivector.plda import Plda as JPlda
from kaldi_tpu.lm.arpa import ArpaLm as JArpa
from kaldi_tpu.lm.const_arpa import ConstArpaLm as JConstArpa
from kaldi_tpu.nnet.am_nnet import AmNnet as JAmNnet
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu.nnet3 import training as jtrain
from kaldi_tpu.nnet3.network import Nnet3 as JNnet3
from kaldi_tpu.sgmm.estimate import Sgmm2Accs as JSgmmAccs
from kaldi_tpu.steps.mono import MonoModel as JMonoModel
from kaldi_tpu.steps.sgmm_steps import SgmmAm as JSgmmAm
from kaldi_tpu.tree import build_tree as jbt
from kaldi_tpu.tree import clustering as jcl
from kaldi_tpu.tree import context_dep as jctx
from kaldi_tpu.tree.context_dep import MonophoneContextDependency as JMono
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.io import model_io as T
from kaldi_tpu_torch.nnet3 import configs as tconfigs
from kaldi_tpu_torch.params import (params_to_jax, random_tdnn_params,
                                    sgmm2_to_lists)
from kaldi_tpu_torch.tree import clustering as tcl
from kaldi_tpu_torch.tree.context_dep import (MonophoneContextDependency,
                                              TreeContextDependency)
from test_torch_sgmm import _jax_model as jax_sgmm
from test_torch_tree import BUILDS, _build, _tree_stats

torch.set_num_threads(2)

TDNN = dict(feat_dim=6, num_pdfs=16, hidden_dim=12, pnorm_output_dim=4,
            nonlinearity="pnorm", splice_indexes=((-1, 0, 1), (-1, 2), (0,)))
ARPA = ("\\data\\\nngram 1=5\nngram 2=3\n\n\\1-grams:\n-1.0\t<s>\t-0.3\n"
        "-0.7\ta\t-0.2\n-0.9\tb\t-0.1\n-1.2\tc\n-0.8\t</s>\n\n"
        "\\2-grams:\n-0.3\t<s> a\n-0.4\ta b\n-0.2\tb </s>\n\n\\end\\\n")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-30))


def _jlang():
    return jprepare(JLexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                    num_sil_states=3)


def _feats(dim: int, T: int = 17, B: int = 2, seed: int = 5):
    return np.random.RandomState(seed).randn(B, T, dim).astype(np.float32)


# ----------------------------------------------------------------- kinds
#
# Each kind: make() -> JAX object; save(mod, path, obj); load(mod, path)
# (the port's loads on the CPU); check(port_obj, jax_obj): the port's
# object computes what JAX's does; same(jax_a, jax_b): two JAX objects
# hold the same data.

def _gmm_make():
    lang = _jlang()
    ctx = JMono.from_topo(lang.topo)
    tm = JTm(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    rng = np.random.RandomState(0)
    tm.load_log_probs(tm.log_probs + rng.uniform(-0.1, 0.0,
                                                 tm.log_probs.shape))
    am = JAmDiagGmm([JDiagGmm(rng.dirichlet(np.ones(k)), rng.randn(k, 39),
                              rng.uniform(0.5, 2.0, (k, 39)))
                     for k in rng.randint(1, 4, tm.num_pdfs)])
    return JMonoModel(am, tm, ctx, lang)


def _gmm_check(t, j):
    x = _feats(39)
    np.testing.assert_allclose(t.am.loglikes_np(x), j.am.loglikes_np(x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.trans_model.log_probs,
                                  j.trans_model.log_probs)
    np.testing.assert_array_equal(t.trans_model.id2pdf_array,
                                  j.trans_model.id2pdf_array)
    assert t.lang.words._i2s == j.lang.words._i2s
    assert isinstance(t.ctx_dep, MonophoneContextDependency)


def _gmm_same(a, b):
    for p, q in zip(a.am.pdfs, b.am.pdfs):
        for k in ("weights", "means", "vars"):
            np.testing.assert_array_equal(getattr(p, k), getattr(q, k))
    np.testing.assert_array_equal(a.trans_model.log_probs,
                                  b.trans_model.log_probs)
    assert a.lang.words._i2s == b.lang.words._i2s
    assert a.lang.phones._i2s == b.lang.phones._i2s
    assert type(a.ctx_dep).__module__ == "kaldi_tpu.tree.context_dep"


def _graph_make():
    return jmake_big_hclg(JBigGraphConfig(vocab=30, avg_bigram_succ=4,
                                          num_pdfs=16, seed=3))[0]


_GRAPH_KEYS = ("arc_start", "ilabel", "olabel", "cost", "nextstate", "pdf",
               "final")


def _graph_same(a, b):
    assert a.start == b.start
    for k in _GRAPH_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _am_make(mixed: bool):
    cfg = dict(TDNN, num_pdfs=20 if mixed else 16)
    params = random_tdnn_params(JTdnnConfig(**cfg), np.random.default_rng(0))
    gid = (np.array(list(range(16)) + [3, 5, 7, 9], np.int32) if mixed
           else None)
    am = JAmNnet(JTdnn(JTdnnConfig(**cfg)),
                 jax.tree.map(jnp.asarray, params),
                 priors=np.random.default_rng(1).dirichlet(np.ones(16)),
                 group_ids=gid,
                 lr_scales={"layer0": 0.5} if mixed else None)
    if mixed:
        am.meta = {"preconditioner": "ng", "rank": 4}
    return am


def _am_check(t, j):
    x = _feats(6)
    assert _rel(t.loglikes_np(x), j.loglikes_np(x)) <= 1e-5
    np.testing.assert_array_equal(t.priors, j.priors)
    assert t.lr_scales == j.lr_scales and t.meta == j.meta


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _am_same(a, b):
    np.testing.assert_array_equal(a.priors, b.priors)
    jax.tree.map(np.testing.assert_array_equal, _tree_np(a.params),
                 _tree_np(b.params))
    assert a.model.config == b.model.config
    assert (a.group_ids is None) == (b.group_ids is None)
    if a.group_ids is not None:
        np.testing.assert_array_equal(a.group_ids, b.group_ids)
    assert a.lr_scales == b.lr_scales and a.meta == b.meta


def _raw_make():
    params = random_tdnn_params(JTdnnConfig(**TDNN), np.random.default_rng(2))
    return JTdnn(JTdnnConfig(**TDNN)), params


def _raw_check(t, j):
    model, params = t
    x = _feats(6)
    want = np.asarray(j[0].apply(jax.tree.map(jnp.asarray, j[1]), x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(params), j[1])


def _raw_same(a, b):
    assert a[0].config == b[0].config
    jax.tree.map(np.testing.assert_array_equal, _tree_np(a[1]),
                 _tree_np(b[1]))


def _nnet3_make():
    cfg = tconfigs.make_tdnn_config(**cs.NNET_SMALL["tdnn"])
    net = JNnet3(cfg)
    params = net.init(jax.random.PRNGKey(3))
    return jtrain.AmNnet3(net, params, np.random.RandomState(0).dirichlet(
        np.ones(net.dims["output"])))


def _nnet3_check(t, j):
    x = _feats(8, T=12)
    assert _rel(t.loglikes_np(x), j.loglikes_np(x)) <= 1e-5
    np.testing.assert_array_equal(t.priors, j.priors)


def _nnet3_same(a, b):
    assert a.model.config_text == b.model.config_text
    np.testing.assert_array_equal(a.priors, b.priors)
    jax.tree.map(np.testing.assert_array_equal, _tree_np(a.params),
                 _tree_np(b.params))


def _ext_make():
    rng = np.random.RandomState(4)
    ubm = JDiagGmm(rng.dirichlet(np.ones(4)), rng.randn(4, 5),
                   rng.uniform(0.5, 2.0, (4, 5)))
    ext = JExtractor(ubm, ivector_dim=3, prior_offset=50.0)
    ext.M = rng.randn(*ext.M.shape) * 0.3
    return ext


def _ext_check(t, j):
    x = np.random.RandomState(6).randn(40, 5)
    pt, pj = t.frame_posteriors(x, num_gselect=3), j.frame_posteriors(
        x, num_gselect=3)
    assert _rel(pt, pj) <= 1e-12
    st, sj = t.utterance_stats(x, pj), j.utterance_stats(x, pj)
    assert all(_rel(a, b) <= 1e-12 for a, b in zip(st, sj))
    assert all(_rel(a, b) <= 1e-12
               for a, b in zip(t.extract(*sj), j.extract(*sj)))


def _ext_same(a, b):
    for k in ("means", "inv_covars", "weights", "M"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.prior_offset == b.prior_offset


def _words(names):
    w = JSymbolTable()
    for n in names:
        w.add(n)
    return w


def _clm_make():
    return JConstArpa(JArpa.parse(ARPA), _words(["a", "b", "c", "<s>",
                                                 "</s>"]))


_SENTENCES = ([1, 2], [1, 2, 3], [3, 3, 1], [2], [])


def _clm_check(t, j):
    for s in _SENTENCES:
        assert t.sentence_logprob(s) == j.sentence_logprob(s)
    _clm_same(t, j)


def _clm_same(a, b):
    for k in T._CLM_ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for k in ("_hist_index", "_ext_index", "_state_hist", "order", "bos",
              "eos", "unk_cost"):
        assert getattr(a, k) == getattr(b, k), k


def _ubm_make(full: bool):
    rng = np.random.RandomState(7)
    w, mu = rng.dirichlet(np.ones(3)), rng.randn(3, 4)
    if full:
        A = rng.randn(3, 4, 4)
        return JFullGmm(w, mu, A @ A.transpose(0, 2, 1) + np.eye(4))
    return JDiagGmm(w, mu, rng.uniform(0.5, 2.0, (3, 4)))


def _ubm_check(t, j):
    x = np.random.RandomState(8).randn(20, 4)
    assert type(t).__name__ == type(j).__name__
    assert _rel(t.loglikes(x), j.loglikes(x)) <= 1e-12


def _ubm_same(a, b):
    assert type(a) is type(b)
    for k in ("weights", "means", "covars" if hasattr(a, "covars")
              else "vars"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _plda_make():
    rng = np.random.RandomState(9)
    return JPlda(mean=rng.randn(4), transform=rng.randn(4, 4),
                 psi=rng.uniform(0.1, 2.0, 4))


def _plda_check(t, j):
    x = np.random.RandomState(10).randn(4)
    assert _rel(t.transform_ivector(x), j.transform_ivector(x)) <= 1e-12
    _plda_same(t, j)


def _plda_same(a, b):
    for k in ("mean", "transform", "psi"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _accs_make():
    m = _gmm_make()
    acc = JAccAm(m.am)
    rng = np.random.RandomState(11)
    for a in acc.accs:
        a.occ = rng.uniform(0, 9, a.occ.shape)
        a.mean_acc = rng.randn(*a.mean_acc.shape)
        a.var_acc = rng.uniform(0, 9, a.var_acc.shape)
    acc.tot_like, acc.tot_frames = -1234.5, 321.0
    return acc, rng.uniform(0, 5, m.trans_model.num_transition_ids + 1)


def _accs_same(a, b):
    (acc_a, tc_a), (acc_b, tc_b) = a, b
    for p, q in zip(acc_a.accs, acc_b.accs):
        for k in ("occ", "mean_acc", "var_acc"):
            np.testing.assert_array_equal(getattr(p, k), getattr(q, k))
    assert (acc_a.tot_like, acc_a.tot_frames) == \
        (acc_b.tot_like, acc_b.tot_frames)
    np.testing.assert_array_equal(tc_a, tc_b)


def _stats_same(a, b):
    (sa, na, pa), (sb, nb, pb) = a, b
    assert (na, pa) == (nb, pb) and list(sa) == list(sb)
    for ev in sa:
        for k in ("count", "x", "x2", "var_floor"):
            np.testing.assert_array_equal(getattr(sa[ev], k),
                                          getattr(sb[ev], k))


def _tree_make():
    jtree, n = _build(jbt, jcl, BUILDS[0])
    return jctx.TreeContextDependency(3, 1, jtree, n)


def _tree_same(a, b):
    assert cs.trees_equal(a.event_map, b.event_map)
    assert (a.context_width, a.central_position, a.num_pdfs) == \
        (b.context_width, b.central_position, b.num_pdfs)


def _tree_check(t, j):
    assert isinstance(t, TreeContextDependency)
    _tree_same(t, j)
    for w in ([1, 2, 3], [0, 4, 5], [2, 8, 0]):
        for pc in range(3):
            assert t.compute(w, pc) == j.compute(w, pc)


def _sgmm_make():
    jm, _f, _x, _p = jax_sgmm()
    am = JSgmmAm(jm, 3)
    am.pre_xform = np.random.RandomState(12).randn(4, 5)
    return am


def _sgmm_check(t, j):
    x = _feats(4, T=30, B=1)
    assert _rel(t.loglikes_np(x), j.loglikes_np(x)) <= 1e-9
    assert t.kind == "sgmm2" and t.num_gselect == j.num_gselect
    np.testing.assert_array_equal(t.pre_xform, j.pre_xform)
    v, c = sgmm2_to_lists(t.sgmm)
    for a, b in zip(v + c, j.sgmm.v + j.sgmm.c):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _sgmm_same(a, b):
    for k in ("Sigma_inv", "M", "w", "N"):
        np.testing.assert_array_equal(getattr(a.sgmm, k), getattr(b.sgmm, k))
    for x, y in zip(a.sgmm.v + a.sgmm.c, b.sgmm.v + b.sgmm.c):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a.num_gselect == b.num_gselect and a.kind == b.kind
    np.testing.assert_array_equal(a.pre_xform, b.pre_xform)


def _sgmm_accs_make():
    jm, _f, feats, post = jax_sgmm()
    accs = JSgmmAccs(jm)
    accs.accumulate(jm, feats, post, num_gselect=3)
    return accs


_SGMM_ACC_KEYS = ("Y", "Q", "S_centered")


def _sgmm_accs_check(t, j):
    for k in _SGMM_ACC_KEYS:
        np.testing.assert_array_equal(getattr(t, k).numpy(), getattr(j, k))
    o = t._offsets
    for s in range(len(j.gamma)):
        np.testing.assert_array_equal(t.gamma[o[s]:o[s + 1]].numpy(),
                                      j.gamma[s])
        np.testing.assert_array_equal(t.y[o[s]:o[s + 1]].numpy(), j.y[s])
    assert (t.tot_like, t.tot_frames) == (j.tot_like, j.tot_frames)
    np.testing.assert_array_equal(
        t.state_occs(), [g.sum() for g in j.gamma])


def _sgmm_accs_same(a, b):
    for k in _SGMM_ACC_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for x, y in zip(a.gamma + a.y, b.gamma + b.y):
        np.testing.assert_array_equal(x, y)
    assert (a.tot_like, a.tot_frames) == (b.tot_like, b.tot_frames)


def _plain(name):
    """save/load by the module's save_<name> / load_<name>."""
    return (lambda mod, path, obj: getattr(mod, f"save_{name}")(path, obj),
            lambda mod, path: getattr(mod, f"load_{name}")(path))


def _on_cpu(name):
    """save/load whose port load takes a device."""
    def load(mod, path):
        fn = getattr(mod, f"load_{name}")
        return fn(path, device="cpu") if mod is T else fn(path)
    return (lambda mod, path, obj: getattr(mod, f"save_{name}")(path, obj),
            load)


def _raw_io():
    def save(mod, path, obj):
        mod.save_raw_nnet(path, *obj)

    def load(mod, path):
        return (mod.load_raw_nnet(path, device="cpu") if mod is T
                else mod.load_raw_nnet(path))
    return save, load


def _accs_io():
    def save(mod, path, obj):
        mod.save_gmm_accs(path, obj[0], trans_counts=obj[1])
    return save, lambda mod, path: mod.load_gmm_accs(path)


def _stats_io():
    def save(mod, path, obj):
        mod.save_tree_stats(path, *obj)
    return save, lambda mod, path: mod.load_tree_stats(path)


KINDS = {
    "gmm_system": (_gmm_make, _on_cpu("gmm_system"), _gmm_check, _gmm_same),
    "hclg": (_graph_make, _plain("hclg"), _graph_same, _graph_same),
    "am_nnet": (lambda: _am_make(False), _on_cpu("am_nnet"), _am_check,
                _am_same),
    "am_nnet_mixed": (lambda: _am_make(True), _on_cpu("am_nnet"), _am_check,
                      _am_same),
    "raw_nnet": (_raw_make, _raw_io(), _raw_check, _raw_same),
    "am_nnet3": (_nnet3_make, _on_cpu("am_nnet3"), _nnet3_check,
                 _nnet3_same),
    "ivector_extractor": (_ext_make, _plain("ivector_extractor"),
                          _ext_check, _ext_same),
    "const_arpa": (_clm_make, _plain("const_arpa"), _clm_check, _clm_same),
    "diag_ubm": (lambda: _ubm_make(False), _plain("ubm"), _ubm_check,
                 _ubm_same),
    "full_ubm": (lambda: _ubm_make(True), _plain("ubm"), _ubm_check,
                 _ubm_same),
    "plda": (_plda_make, _plain("plda"), _plda_check, _plda_same),
    "gmm_accs": (_accs_make, _accs_io(), _accs_same, _accs_same),
    "tree_stats": (lambda: (_tree_stats(jcl), 3, 1), _stats_io(),
                   _stats_same, _stats_same),
    "tree": (_tree_make, _plain("tree"), _tree_check, _tree_same),
    "sgmm2": (_sgmm_make, _on_cpu("sgmm2"), _sgmm_check, _sgmm_same),
    "sgmm2_accs": (_sgmm_accs_make, _on_cpu("sgmm2_accs"), _sgmm_accs_check,
                   _sgmm_accs_same),
}


@pytest.fixture(scope="module")
def made():
    return {}


def _jax_obj(made, kind):
    if kind not in made:
        made[kind] = KINDS[kind][0]()
    return made[kind]


def _npz_equal(a_path, b_path):
    """Key for key: the same names (a layer's keys follow its params
    dict's order, which a pytree map sorts), dtypes, shapes and bytes;
    __host__ payloads unpickled by JAX's plain pickle.loads and compared
    structurally."""
    assert cs.npz_same(a_path, b_path, loads=pickle.loads)


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_file_loads_into_the_port(kind, made, tmp_path):
    make, (save, load), check, _same = KINDS[kind]
    j = _jax_obj(made, kind)
    path = str(tmp_path / "jax.mdl")
    save(J, path, j)
    t = load(T, path)
    assert not type(t).__module__.startswith("kaldi_tpu.")
    check(t, load(J, path))


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_file_equals_jax_file_key_for_key(kind, made, tmp_path):
    _make, (save, load), _check, _same = KINDS[kind]
    j = _jax_obj(made, kind)
    jpath, tpath = str(tmp_path / "jax.mdl"), str(tmp_path / "port.mdl")
    save(J, jpath, j)
    save(T, tpath, load(T, jpath))
    _npz_equal(jpath, tpath)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_file_loads_in_jax(kind, made, tmp_path):
    _make, (save, load), _check, same = KINDS[kind]
    j = _jax_obj(made, kind)
    jpath, tpath = str(tmp_path / "jax.mdl"), str(tmp_path / "port.mdl")
    save(J, jpath, j)
    save(T, tpath, load(T, jpath))
    same(load(J, tpath), load(J, jpath))


def test_no_npz_suffix_is_added(made, tmp_path):
    path = str(tmp_path / "final.mdl")
    T.save_hclg(path, _jax_obj(made, "hclg"))
    assert (tmp_path / "final.mdl").exists()
    assert not (tmp_path / "final.mdl.npz").exists()


def test_port_native_host_objects_load_in_jax(tmp_path):
    """The port's own lang, monophone context, transition model and tree
    (never a JAX object) pickle as the JAX package's classes."""
    tlang = prepare_lang(Lexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                         num_sil_states=3)
    tctx = MonophoneContextDependency.from_topo(tlang.topo)
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.steps.mono import MonoModel
    tm = TransitionModel(tlang.topo, lambda ph, pc: tctx.compute([ph], pc))
    am = cs.random_am([2] * tm.num_pdfs, 39, 0, "cpu")
    path = str(tmp_path / "mono.mdl")
    T.save_gmm_system(path, MonoModel(am, tm, tctx, tlang))
    j = J.load_gmm_system(path)
    jl = _jlang()
    assert type(j.lang).__module__ == "kaldi_tpu.fst.lang"
    assert j.lang.words._i2s == jl.words._i2s
    assert j.lang.phones._i2s == jl.phones._i2s
    np.testing.assert_array_equal(j.trans_model.id2pdf_array,
                                  JTm(jl.topo, lambda ph, pc: JMono.from_topo(
                                      jl.topo).compute([ph], pc)).id2pdf_array)
    x = _feats(39)
    np.testing.assert_allclose(j.am.loglikes_np(x), am.loglikes_np(x),
                               rtol=1e-5, atol=1e-5)
    from kaldi_tpu_torch.tree import build_tree as tbt
    ttree, n = _build(tbt, tcl, BUILDS[1])
    tpath = str(tmp_path / "tree")
    T.save_tree(tpath, TreeContextDependency(3, 1, ttree, n))
    jt = J.load_tree(tpath)
    assert type(jt).__module__ == "kaldi_tpu.tree.context_dep"
    assert cs.trees_equal(jt.event_map, ttree) and jt.num_pdfs == n
    spath = str(tmp_path / "stats")
    T.save_tree_stats(spath, _tree_stats(tcl), 3, 1)
    _stats_same(J.load_tree_stats(spath), (_tree_stats(jcl), 3, 1))


class _Evil:
    def __reduce__(self):
        return (print, ("unpickled",))


def test_unknown_pickled_class_is_refused(tmp_path):
    for payload in (pickle.dumps(_Evil()),
                    pickle.dumps({"x": io.BytesIO()}),
                    pickle.dumps(JSymbolTable, protocol=2).replace(
                        b"kaldi_tpu.fst.fst", b"kaldi_tpu.io.wave"
                    ).replace(b"SymbolTable", b"read_wave")):
        path = str(tmp_path / "tree")
        with open(path, "wb") as f:
            np.savez(f, __version__=np.int64(1),
                     __kind__=np.frombuffer(b"tree", np.uint8),
                     __host__=np.frombuffer(payload, np.uint8))
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            T.load_tree(path)
    with pytest.raises(pickle.PicklingError, match="not a host class"):
        T.save_tree(str(tmp_path / "bad"), {"x": io.BytesIO()})


def test_device_loads_default_to_the_card():
    import inspect
    for fn in (T.load_gmm_system, T.load_am_nnet, T.load_raw_nnet,
               T.load_am_nnet3, T.load_sgmm2, T.load_sgmm2_accs):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_device_load_raises_without_a_card(made, tmp_path):
    path = str(tmp_path / "am")
    J.save_am_nnet(path, _jax_obj(made, "am_nnet"))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.load_am_nnet(path)
