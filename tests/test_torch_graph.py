"""Port parity: the port's numpy copies of the decoder's host code produce
arrays equal to kaldi_tpu's (graph build, CSR split, eps folding, corpus
synthesis, tier-table packing)."""

import dataclasses

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder import biggraph as jbig
from kaldi_tpu.decoder import csr_beam as jcsr
from kaldi_tpu.decoder import graph_pack as jgp
from kaldi_tpu.decoder import simulate as jsim
from kaldi_tpu_torch.decoder import biggraph as tbig
from kaldi_tpu_torch.decoder import csr_beam as tcsr
from kaldi_tpu_torch.decoder import graph_pack as tgp
from kaldi_tpu_torch.decoder import simulate as tsim

torch.set_num_threads(2)

CONFIGS = [dict(vocab=300, avg_bigram_succ=20, num_pdfs=64, seed=1),
           dict(vocab=200, avg_bigram_succ=12, num_pdfs=64, seed=3)]


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        else:
            assert x == y, f.name


@pytest.fixture(scope="module", params=range(len(CONFIGS)))
def graphs(request):
    kw = CONFIGS[request.param]
    jg, jn = jbig.make_big_hclg(jbig.BigGraphConfig(**kw))
    tg, tn = tbig.make_big_hclg(tbig.BigGraphConfig(**kw))
    assert jn == tn
    return jg, tg


def test_make_big_hclg_equal(graphs):
    _assert_fields_equal(*graphs)


def test_split_csr_and_eps_depth_equal(graphs):
    jg, tg = graphs
    _assert_fields_equal(jgp.split_csr(jg), tgp.split_csr(tg))
    assert jgp.eps_depth(jg) == tgp.eps_depth(tg) == 1


def test_fold_epsilons_equal(graphs):
    jg, tg = graphs
    jf, tf = jgp.fold_epsilons(jg), tgp.fold_epsilons(tg)
    assert jf is not None and tf is not None
    _assert_fields_equal(jf, tf)
    assert tgp.eps_depth(tf) == 0


def test_make_corpus_equal(graphs):
    jg, tg = graphs
    jw, js, jwords = jsim.make_corpus(jg, 2, 120, np.random.default_rng(0),
                                      noise=0.25)
    tw, ts, twords = tsim.make_corpus(tg, 2, 120, np.random.default_rng(0),
                                      noise=0.25)
    np.testing.assert_array_equal(jw, tw)
    np.testing.assert_array_equal(js, ts)
    assert jwords == twords
    np.testing.assert_array_equal(jsim.fbank_targets(js[0], 118),
                                  tsim.fbank_targets(ts[0], 118))


@pytest.mark.parametrize("force_triple", [False, True])
@pytest.mark.parametrize("hub_threshold", [1024, 64])
@pytest.mark.parametrize("fold", [True, False])
def test_build_tier_tables_equal(graphs, force_triple, hub_threshold, fold):
    jg, tg = graphs
    if fold:
        jg, tg = jgp.fold_epsilons(jg), tgp.fold_epsilons(tg)
    jt = jcsr.build_tier_tables(jgp.split_csr(jg), hub_threshold,
                                force_triple=force_triple)
    tt = tcsr.build_tier_tables(tgp.split_csr(tg), hub_threshold,
                                force_triple=force_triple, device="cpu")
    assert tt.b_apr == jt.b_apr == (3 if force_triple else 4)
    for f in dataclasses.fields(jt):
        x, y = getattr(jt, f.name), getattr(tt, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif isinstance(y, torch.Tensor):
            assert np.array_equal(np.asarray(x), y.numpy()), f.name
            assert np.asarray(x).dtype == y.numpy().dtype, f.name
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    if hub_threshold == 64:
        assert len(tt.hub_bounds) > 1 and tt.hub_onehot is not None


def test_one_row_tier_b_is_padded_to_two_rows():
    """A tier B that packs into exactly one row still gets two rows, so it
    is not mistaken for the empty-tier dummy (the padding row is dead)."""
    arc_start = np.array([0, 3, 4, 5, 6], np.int32)
    g = tgp.PackedGraph(
        arc_start=arc_start, ilabel=np.array([1, 2, 3, 1, 2, 3], np.int32),
        olabel=np.zeros(6, np.int32), cost=np.ones(6, np.float32),
        nextstate=np.array([1, 2, 3, 0, 0, 0], np.int32),
        final=np.zeros(4, np.float32), start=0,
        pdf=np.array([0, 1, 2, 0, 1, 2], np.int32))
    tt = tcsr.build_tier_tables(tgp.split_csr(g), 1024, device="cpu")
    jt = jcsr.build_tier_tables(jgp.split_csr(g), 1024)
    assert tuple(tt.brow.shape) == (2, 16)
    np.testing.assert_array_equal(tt.brow.numpy(), np.asarray(jt.brow))
