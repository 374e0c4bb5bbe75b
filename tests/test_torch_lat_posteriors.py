"""Port parity: the lattice functions (kaldi_tpu_torch.lat.functions), the
lattice posteriors of discriminative training (lat.posteriors) and the
Posterior tools (hmm.posterior) against kaldi_tpu's, on the CPU.

The system is tests/test_discriminative.py's yesno `mmi_system` built by
the port (`chip_smoke.mmi_system`: 16 training and 6 test utterances, a
monophone of 40 gaussians, the yesno HCLG as the denominator graph) and
carried to JAX (`jax_model`). Both packages' padded decoders make
lattices from the same loglikes: the port's equal JAX's in structure,
with costs within 1e-4 (as tests/test_torch_lattice.py holds them). Every
function is then run on a JAX lattice and on its copy made by
`params.lattice_from_jax` (and on `_toy_lattice`), and the two results
must be equal exactly: the functions are host code, copied verbatim.
"""

import copy
import io

import numpy as np
import pytest

import chip_smoke as cs
from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder as JBeam,
                                           BeamSearchOpts as JBeamOpts)
from kaldi_tpu.decoder.graph_pack import pack_graph as jpack_graph
from kaldi_tpu.fst.graph import make_hclg as jmake_hclg
from kaldi_tpu.fst.lang import Lexicon as JLexicon, prepare_lang as jprepare
from kaldi_tpu.gmm.am_gmm import AmDiagGmm as JAm
from kaldi_tpu.gmm.diag_gmm import DiagGmm as JDiag
from kaldi_tpu.hmm import posterior as jhp
from kaldi_tpu.hmm.transition_model import TransitionModel as JTm
from kaldi_tpu.lat import functions as jfun
from kaldi_tpu.lat import posteriors as jpost
from kaldi_tpu.lat.generate import decode_to_lattices as jdecode_to_lattices
from kaldi_tpu.lat.lattice import Lattice as JLattice
from kaldi_tpu.lm.arpa import ArpaLm as JArpa, arpa_to_g as jarpa_to_g
from kaldi_tpu.steps import mono as jmono
from kaldi_tpu.tree.context_dep import MonophoneContextDependency as JMonoCtx
from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                 BeamSearchOpts)
from kaldi_tpu_torch.decoder.graph_pack import pack_graph
from kaldi_tpu_torch.hmm import posterior as thp
from kaldi_tpu_torch.lat import functions as tfun
from kaldi_tpu_torch.lat import posteriors as tpost
from kaldi_tpu_torch.lat.generate import decode_to_lattices
from kaldi_tpu_torch.lat.lattice import Lattice
from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
from kaldi_tpu_torch.params import lattice_from_jax

DEN = dict(beam=16.0, max_active=512, acoustic_scale=0.1)


def jax_model(model, jlang):
    """The port's monophone `MonoModel` as a kaldi_tpu one over `jlang`
    (the JAX Lang of the same lexicon): the pdfs and transition
    log-probs copied."""
    ctx = JMonoCtx.from_topo(jlang.topo)
    tm = JTm(jlang.topo, lambda ph, pc: ctx.compute([ph], pc))
    tm.load_log_probs(np.array(model.trans_model.log_probs))
    am = JAm([JDiag(p.weights, p.means, p.vars) for p in model.am.pdfs])
    return jmono.MonoModel(am, tm, ctx, jlang)


def lattice_to_jax(lat):
    """A port lattice as a kaldi_tpu one, arc for arc (the inverse of
    `params.lattice_from_jax`, which the port has no use for)."""
    if lat is None:
        return None
    out = JLattice()
    for s, arcs in enumerate(lat.arcs):
        out.add_state()
        for a in arcs:
            out.add_arc(s, a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost,
                        a.nextstate)
            out.arcs[s][-1].tids = tuple(a.tids)
    out.start = lat.start
    out.finals = dict(lat.finals)
    return out


def build_system(jax_decode: bool = True) -> dict:
    """chip_smoke.mmi_system on the CPU with its JAX twin: the JAX model
    carried across, JAX's HCLG of the same LM, and the denominator
    lattices of the training set from the port's loglikes: the port's
    ("tlats") and JAX's ("jlats"), decoded by JAX's own decoder, or with
    jax_decode=False the port's copied into JAX's class (the files that
    need JAX's lattices only as inputs skip JAX's slow CPU decode)."""
    s = cs.mmi_system("cpu")
    jlang = jprepare(JLexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                     num_sil_states=3)
    jm = jax_model(s["model"], jlang)
    jg = jarpa_to_g(JArpa.parse(cs.YESNO_ARPA), jlang.words)
    jden = jmake_hclg(jlang, jg, jm.trans_model, jm.ctx_dep,
                      self_loop_scale=0.1)
    feats, nf = cs.pad_batch([f for _u, f, _w in s["train"]])
    ll = s["model"].am.loglikes_np(feats)
    jdec = JBeam(jpack_graph(jden.fst, jm.trans_model.id2pdf_array),
                 JBeamOpts(**DEN)) if jax_decode else None
    tdec = BeamSearchDecoder(pack_graph(s["den_graph"].fst,
                                        s["model"].trans_model.id2pdf_array),
                             BeamSearchOpts(**DEN), device="cpu")
    tlats = decode_to_lattices(tdec, ll, nf, lattice_beam=7.0)
    return dict(s, jlang=jlang, jmodel=jm, jden=jden, feats=feats, nf=nf,
                ll=ll, tlats=tlats,
                jlats=(jdecode_to_lattices(jdec, ll, nf, lattice_beam=7.0)
                       if jax_decode else [lattice_to_jax(lat)
                                           for lat in tlats]))


@pytest.fixture(scope="module")
def system():
    return build_system()


def _toy_lattice(cls):
    """tests/test_discriminative.py's `_toy_lattice`: two 2-frame paths
    sharing start and end, tids 1 and 2."""
    lat = cls()
    s0, a1, a2, b1, b2 = (lat.add_state() for _ in range(5))
    lat.start = s0
    lat.add_arc(s0, 1, 5, 0.5, 0.0, a1)
    lat.add_arc(a1, 1, 0, 0.5, 0.0, a2)
    lat.add_arc(s0, 2, 6, 1.0, 0.0, b1)
    lat.add_arc(b1, 2, 0, 1.0, 0.0, b2)
    lat.set_final(a2)
    lat.set_final(b2)
    return lat


class _TmStub:
    """The JAX test's identity transition model."""

    def transition_id_to_pdf(self, tid):
        return tid

    def transition_id_to_phone(self, tid):
        return tid


def form(x):
    """A result of either package in a comparable form: lattices as
    (start, finals, per-state arcs with their tid strings), containers
    element by element, arrays as lists."""
    if isinstance(x, (Lattice, JLattice)):
        return ("lattice", x.start, sorted(x.finals.items()),
                [[(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost,
                   a.nextstate, tuple(a.tids)) for a in arcs]
                 for arcs in x.arcs])
    if isinstance(x, dict):
        return sorted((k, form(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [form(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _lm(pkg_words, arpa_cls, to_g):
    return to_g(arpa_cls.parse(cs.YESNO_ARPA), pkg_words)


# name -> f(package, lattice, side) where side carries the package's
# transition model, lang and G
LATTICE_FUNCTIONS = {
    "lattice_scale": lambda m, lat, s: m.lattice_scale(lat, 0.5, 2.0),
    "add_word_ins_penalty": lambda m, lat, s: m.add_word_ins_penalty(
        lat, 0.7),
    "lattice_best_path": lambda m, lat, s: m.lattice_best_path(lat),
    "lattice_forward_backward": lambda m, lat, s:
        m.lattice_forward_backward(lat),
    "prune_lattice": lambda m, lat, s: m.prune_lattice(lat, 2.0),
    "determinize_lattice": lambda m, lat, s: m.determinize_lattice(lat),
    "determinize_lattice_beam": lambda m, lat, s: m.determinize_lattice(
        lat, beam=3.0),
    "nbest": lambda m, lat, s: m.nbest(lat, 5),
    "compose_lattice_with_lm": lambda m, lat, s: m.compose_lattice_with_lm(
        lat, s["g"], s["lang"].words["#0"], lm_scale=-1.0),
    "rescore_nbest": lambda m, lat, s: m.rescore_nbest(
        m.nbest(lat, 4), s["lm"], s["lang"].words, lm_scale=0.5),
    "best_path_ctm": lambda m, lat, s: m.best_path_ctm(lat),
}
POSTERIOR_FUNCTIONS = {
    "lattice_state_times": lambda m, lat, s, ali, ll:
        m.lattice_state_times(lat),
    "lattice_to_post": lambda m, lat, s, ali, ll: m.lattice_to_post(lat),
    "rescore_lattice": lambda m, lat, s, ali, ll: m.rescore_lattice(
        lat, ll, s["tm"], 0.1),
    "alignment_to_post": lambda m, lat, s, ali, ll: m.alignment_to_post(
        ali, 0.5),
    "posterior_to_pdf_post": lambda m, lat, s, ali, ll:
        m.posterior_to_pdf_post(m.lattice_to_post(lat)[0], s["tm"]),
    "lattice_boost": lambda m, lat, s, ali, ll: m.lattice_boost(
        lat, ali, s["tm"], 0.1, s["sil"]),
    "lattice_boost_sil_error": lambda m, lat, s, ali, ll: m.lattice_boost(
        lat, ali, s["tm"], 0.1, s["sil"], max_silence_error=0.25),
    "mmi": lambda m, lat, s, ali, ll: m.lattice_forward_backward_mmi(
        lat, ali, s["tm"]),
    "mmi_no_drop_no_cancel": lambda m, lat, s, ali, ll:
        m.lattice_forward_backward_mmi(lat, ali, s["tm"], False, False),
    "smbr": lambda m, lat, s, ali, ll:
        m.lattice_forward_backward_mpe_variants(lat, ali, s["tm"], "smbr",
                                                s["sil"]),
    "mpfe": lambda m, lat, s, ali, ll:
        m.lattice_forward_backward_mpe_variants(lat, ali, s["tm"], "mpfe",
                                                s["sil"]),
    "smbr_silence_classes": lambda m, lat, s, ali, ll:
        m.lattice_forward_backward_mpe_variants(
            lat, ali, s["tm"], "smbr", s["sil"], one_silence_class=False),
}


def _sides(system):
    """Per package: its lattice and posterior modules and what the
    functions take (transition model, lang, G, ARPA LM, silence phones)."""
    jl, tl = system["jlang"], system["lang"]
    return (
        (jfun, jpost, dict(tm=system["jmodel"].trans_model, lang=jl,
                           g=_lm(jl.words, JArpa, jarpa_to_g),
                           lm=JArpa.parse(cs.YESNO_ARPA),
                           sil={jl.phones["SIL"]})),
        (tfun, tpost, dict(tm=system["model"].trans_model, lang=tl,
                           g=_lm(tl.words, ArpaLm, arpa_to_g),
                           lm=ArpaLm.parse(cs.YESNO_ARPA),
                           sil={tl.phones["SIL"]})))


def _alignments(system):
    """Each training utterance's best path in its JAX lattice, as its
    reference tids (every frame has an emitting arc on it)."""
    out = []
    for lat, T in zip(system["jlats"], system["nf"]):
        if lat is None:
            out.append(None)
            continue
        tids = jfun.lattice_best_path(lat)[1]
        assert len(tids) == T
        out.append(np.asarray(tids, np.int32))
    return out


def test_decoder_lattices_equal_jax(system):
    """From the same loglikes, the port's denominator lattices equal
    JAX's: the same arcs in the same order, costs within 1e-4; and the
    copy by `lattice_from_jax` equals JAX's exactly."""
    n = 0
    for b, (j, t) in enumerate(zip(system["jlats"], system["tlats"])):
        assert (j is None) == (t is None), b
        if j is None:
            continue
        n += 1
        fj, ft = form(j), form(t)
        assert fj[0] == ft[0] and len(fj[3]) == len(ft[3]), b
        assert [k for k, _v in fj[2]] == [k for k, _v in ft[2]], b
        for aj, at in zip(fj[3], ft[3]):
            assert [a[:2] + a[4:] for a in aj] == [a[:2] + a[4:] for a in at]
            np.testing.assert_allclose([a[2:4] for a in aj],
                                       [a[2:4] for a in at], rtol=0,
                                       atol=1e-4, err_msg=str(b))
        assert form(lattice_from_jax(j)) == fj
    assert n >= 12


@pytest.mark.parametrize("name", sorted(LATTICE_FUNCTIONS))
def test_lattice_function_equals_jax(system, name):
    """Each function of lat/functions.py on the toy lattice and on every
    denominator lattice: the same result in both packages."""
    fn = LATTICE_FUNCTIONS[name]
    (jm, _jp, js), (tm, _tp, ts) = _sides(system)
    lats = [lat for lat in system["jlats"] if lat is not None]
    for lat in lats:
        want = fn(jm, copy.deepcopy(lat), js)
        got = fn(tm, lattice_from_jax(lat), ts)
        assert form(got) == form(want), name
    if name not in ("compose_lattice_with_lm", "rescore_nbest"):
        assert form(fn(tm, _toy_lattice(Lattice), ts)) == \
            form(fn(jm, _toy_lattice(JLattice), js))


@pytest.mark.parametrize("name", sorted(POSTERIOR_FUNCTIONS))
def test_posterior_function_equals_jax(system, name):
    """Each function of lat/posteriors.py on every denominator lattice,
    with the utterance's loglikes and a reference alignment: the same
    result, and the same lattice after it (rescoring and boosting work in
    place)."""
    fn = POSTERIOR_FUNCTIONS[name]
    (_jm, jp, js), (_tm, tp, ts) = _sides(system)
    for b, (lat, ali) in enumerate(zip(system["jlats"],
                                       _alignments(system))):
        if lat is None:
            continue
        ll = system["ll"][b, : system["nf"][b]]
        jl, tl = copy.deepcopy(lat), lattice_from_jax(lat)
        want = fn(jp, jl, js, ali, ll)
        got = fn(tp, tl, ts, ali, ll)
        assert form(got) == form(want), (name, b)
        assert form(tl) == form(jl), (name, b)


def test_toy_lattice_posteriors_equal_jax():
    """tests/test_discriminative.py's toy checks, in both packages: the
    same posteriors, MMI and MPE gammas and state times."""
    for fn in (lambda m, lat: m.lattice_state_times(lat),
               lambda m, lat: m.lattice_to_post(lat),
               lambda m, lat: m.lattice_forward_backward_mmi(
                   lat, [1, 1], _TmStub(), drop_frames=False, cancel=False),
               lambda m, lat: m.lattice_forward_backward_mpe_variants(
                   lat, [1, 1], _TmStub(), "smbr",
                   silence_phones=frozenset(), one_silence_class=False)):
        assert form(fn(tpost, _toy_lattice(Lattice))) == \
            form(fn(jpost, _toy_lattice(JLattice)))
    post, _tot = tpost.lattice_to_post(_toy_lattice(Lattice))
    pa = np.exp(-1) / (np.exp(-1) + np.exp(-2))
    assert abs(dict(post[0])[1] - pa) < 1e-6


def test_posterior_tools_equal_jax(system, tmp_path):
    """hmm/posterior.py on the lattices' posteriors and the reference
    alignments: every tool gives JAX's result, and the text archive
    round-trips between the packages."""
    jtm, ttm = system["jmodel"].trans_model, system["model"].trans_model
    sil = [system["lang"].phones["SIL"]]
    for lat, ali in zip(system["jlats"], _alignments(system)):
        if lat is None:
            continue
        post = jpost.lattice_to_post(lat)[0]
        weights = np.linspace(0.0, 1.0, len(post))
        cases = [
            lambda m, tm: m.ali_to_post(ali, 0.5),
            lambda m, tm: m.scale_post(post, 0.3),
            lambda m, tm: m.weight_post(post, weights),
            lambda m, tm: m.sum_post(post, m.ali_to_post(ali)),
            lambda m, tm: m.post_to_weights(post),
            lambda m, tm: m.post_to_pdf_post(post, tm),
            lambda m, tm: m.post_to_phone_post(post, tm),
            lambda m, tm: m.weight_silence_post(post, tm, sil, 0.0),
            lambda m, tm: m.weight_silence_post(post, tm, sil, 0.5),
            lambda m, tm: m.merge_posteriors(post + post)]
        for case in cases:
            assert form(case(thp, ttm)) == form(case(jhp, jtm))
        for writer, reader in ((jhp, thp), (thp, jhp)):
            f = io.StringIO()
            writer.write_post_line(f, "utt", post)
            path = tmp_path / "post.txt"
            path.write_text(f.getvalue())
            got = list(reader.read_post_ark(str(path)))
            want = list(writer.read_post_ark(str(path)))
            assert form(got) == form(want)
