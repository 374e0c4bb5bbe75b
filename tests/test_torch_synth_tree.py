"""Port parity: kaldi_tpu_torch/tree/synth.py, the port's copy of
scripts/mkgraph_scale.py's `build` (kaldi_tpu_torch/scripts/) and
kaldi_tpu_torch/hmm/hmm_utils.py against kaldi_tpu's on the CPU.

- `synth_triphone_tree` from the same `default_rng` state gives JAX's tree
  leaf for leaf (every phone window and pdf class maps to the same pdf),
  and leaves the generator in the same state;
- the port's `build` at vocab 300 (2,000 bigrams, 1,000 trigrams) gives
  the packed arrays of scripts/mkgraph_scale.py's `build` with the same
  arguments, and the same pdf count and graph stats;
- `split_to_phones` and `convert_alignment` (monophone -> the synthetic
  triphone tree, the ladder's mono -> tri step) equal JAX's on seeded
  alignments walked through the topology of tests/test_torch_graph.py's
  lexicons.
"""

import importlib.util
import itertools
import os

import numpy as np
import pytest

import chip_smoke as cs
from kaldi_tpu.fst import lang as jlang
from kaldi_tpu.hmm import hmm_utils as jhu
from kaldi_tpu.hmm import transition_model as jtm
from kaldi_tpu.steps.deltas import transition_model_from_tree as jtree_tm
from kaldi_tpu.tree import context_dep as jctx
from kaldi_tpu.tree import synth as jsynth
from kaldi_tpu_torch.fst import lang as tlang
from kaldi_tpu_torch.hmm import hmm_utils as thu
from kaldi_tpu_torch.hmm import transition_model as ttm
from kaldi_tpu_torch.steps.deltas import transition_model_from_tree
from kaldi_tpu_torch.tree import context_dep as tctx
from kaldi_tpu_torch.tree import synth as tsynth

from test_torch_graph import LEXICONS, jax_fst_ops


def _langs(name):
    lex = LEXICONS[name][0]
    return (jlang.prepare_lang(jlang.Lexicon.parse(lex), ["SIL"], "SIL",
                               num_sil_states=3),
            tlang.prepare_lang(tlang.Lexicon.parse(lex), ["SIL"], "SIL",
                               num_sil_states=3))


def _trees(name, groups, seed):
    jl, tl = _langs(name)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    jt = jsynth.synth_triphone_tree(jl.topo, [jl.phones["SIL"]], *groups,
                                    rng=jr)
    tt = tsynth.synth_triphone_tree(tl.topo, [tl.phones["SIL"]], *groups,
                                    rng=tr)
    assert jr.integers(1 << 30) == tr.integers(1 << 30)
    return (jl, jt), (tl, tt)


@pytest.mark.parametrize("name,groups,seed", [
    ("tri", (2, 3), 0), ("rm_like", (6, 7), 0), ("rm_like", (3, 2), 5),
    ("yesno", (1, 1), 1)])
def test_synth_triphone_tree_equals_jax_leaf_for_leaf(name, groups, seed):
    (jl, jt), (tl, tt) = _trees(name, groups, seed)
    assert tt.num_pdfs == jt.num_pdfs
    assert (tt.context_width, tt.central_position) == \
        (jt.context_width, jt.central_position)
    phones = [0] + sorted(jl.topo.phones)
    for p in sorted(jl.topo.phones):
        classes = {s.pdf_class for s in jl.topo.entry(p)
                   if s.pdf_class is not None}
        for left, right in itertools.product(phones, phones):
            for pc in classes:
                w = [left, p, right]
                assert tt.compute(w, pc) == jt.compute(w, pc), (w, pc)


def _jax_build():
    spec = importlib.util.spec_from_file_location(
        "mkgraph_scale_jax", os.path.join(cs.ROOT, "scripts",
                                          "mkgraph_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build


def test_build_equals_mkgraph_scale(tmp_path, monkeypatch):
    from kaldi_tpu_torch.scripts.mkgraph_scale import build
    jax_fst_ops(monkeypatch)
    out = str(tmp_path / "g.npz")
    jstats = _jax_build()(vocab=300, n_bigrams=2000, n_trigrams=1000,
                          out_npz=out)
    packed, num_pdfs, stats = build(vocab=300, n_bigrams=2000,
                                    n_trigrams=1000)
    z = np.load(out)
    for k in ("arc_start", "ilabel", "olabel", "cost", "nextstate", "final",
              "pdf"):
        got = np.asarray(getattr(packed, k))
        assert np.array_equal(got, z[k]) and got.dtype == z[k].dtype, k
    assert packed.start == int(z["start"]) and num_pdfs == int(z["num_pdfs"])
    for k, v in jstats.items():
        if not k.endswith("_s"):
            assert stats[k] == v, k
    assert stats["states"] == packed.num_states > 0


def _walk(tm, ctx, topo, phones, rng):
    """A seeded transition-id alignment of `phones`: each emitting state
    stays 1-3 frames (self-loops), then takes its first forward
    transition."""
    ali = []
    for p in phones:
        entry = topo.entry(p)
        s = 0
        while entry[s].pdf_class is not None:
            trans = entry[s].transitions
            pdf = ctx.compute([p], entry[s].pdf_class)
            ts = tm.tuple_to_transition_state(p, s, pdf)
            loop = [i for i, (d, _p) in enumerate(trans) if d == s]
            fwd = min((d, i) for i, (d, _p) in enumerate(trans) if d > s)
            for _ in range(int(rng.randint(0, 3)) if loop else 0):
                ali.append(tm.pair_to_transition_id(ts, loop[0]))
            ali.append(tm.pair_to_transition_id(ts, fwd[1]))
            s = fwd[0]
    return np.array(ali, np.int32)


@pytest.mark.parametrize("name", ["tri", "rm_like"])
def test_split_and_convert_alignment_equal_jax(name):
    (jl, jt), (tl, tt) = _trees(name, (2, 3), 0)
    jmono = jctx.MonophoneContextDependency.from_topo(jl.topo)
    tmono = tctx.MonophoneContextDependency.from_topo(tl.topo)
    jold = jtm.TransitionModel(jl.topo,
                               lambda ph, pc: jmono.compute([ph], pc))
    told = ttm.TransitionModel(tl.topo,
                               lambda ph, pc: tmono.compute([ph], pc))
    jnew, tnew = jtree_tm(jl, jt), transition_model_from_tree(tl, tt)
    rng = np.random.RandomState(3)
    phones = sorted(jl.topo.phones)
    sil = jl.phones["SIL"]
    for _ in range(6):
        seq = [sil] + list(rng.choice(phones, 8)) + [sil]
        ali = _walk(jold, jmono, jl.topo, seq, rng)
        assert thu.split_to_phones(ali, told) == \
            jhu.split_to_phones(ali, jold)
        got = thu.convert_alignment(ali, told, tnew, tt)
        want = jhu.convert_alignment(ali, jold, jnew, jt)
        np.testing.assert_array_equal(got, want)
        assert [tnew.transition_id_to_phone(int(t)) for t in got] == \
            [told.transition_id_to_phone(int(t)) for t in ali]
