"""Port parity: train_lda_mllt (kaldi_tpu_torch.steps.lda_mllt) against
kaldi_tpu's on the CPU, on tests/test_sat_lda.py's LDA+MLLT corpus and
options (chip_smoke.lda_corpus: yesno, the port's MFCC fed to both
packages), from the same monophone (JAX's, carried across by
`params.mono_model_from_jax`): the same leaf and gaussian counts, a
[20, 92] transform, identical words and WER 0 as test_sat_lda.py asks;
and `LdaMlltModel.transform_feats` (splice + projection) against JAX's.
The MLLT statistics are held to JAX's in
tests/test_torch_lda_mllt_sat.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.steps import lda_mllt as jlda
from kaldi_tpu.steps import mono as jmono
from kaldi_tpu_torch.params import mono_model_from_jax
from kaldi_tpu_torch.steps import lda_mllt as tlda
from test_torch_lda_mllt_sat import _decoder, _langs, _rel_to, _words

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lda():
    train_d, train_r, test = cs.lda_corpus("cpu")
    jl, tl = _langs()
    jm = jmono.train_mono(jl, train_d, jmono.MonoTrainOpts(**cs.SAT_LDA_MONO))
    jres = jlda.train_lda_mllt(jl, train_d, train_r, jm,
                               jlda.LdaMlltTrainOpts(**cs.LDA_SMALL))
    tres = tlda.train_lda_mllt(tl, train_d, train_r,
                               mono_model_from_jax(jm, tl, "cpu"),
                               tlda.LdaMlltTrainOpts(**cs.LDA_SMALL))
    return dict(test=test, jl=jl, tl=tl, jres=jres, tres=tres)


def test_transform_feats_matches_jax(lda):
    """Splice +-3 and the LDA+MLLT projection of one raw test utterance
    by JAX's transform: within 1e-6 of the sum of the absolute terms."""
    opts = tlda.LdaMlltTrainOpts(**cs.LDA_SMALL)
    feats = lda["test"][0][1]
    jres, tres = lda["jres"], lda["tres"]
    jt = jres.transform_feats(feats, jlda.LdaMlltTrainOpts(**cs.LDA_SMALL))
    tt = tlda.LdaMlltModel(tres.model, jres.transform).transform_feats(
        feats, opts)
    assert tt.dtype == np.float32 and tt.shape == jt.shape
    spliced = np.concatenate([feats[np.clip(np.arange(len(feats)) + k, 0,
                                            len(feats) - 1)]
                              for k in range(-3, 4)], axis=1)
    assert _rel_to(tt, jt,
                   cs.affine_term_scale(spliced, jres.transform)) <= 1e-6


def test_train_lda_mllt_matches_jax(lda):
    jres, tres = lda["jres"], lda["tres"]
    assert tres.transform.shape == jres.transform.shape == (20, 13 * 7 + 1)
    assert tres.model.am.num_pdfs == jres.model.am.num_pdfs
    assert tres.model.am.total_gauss == jres.model.am.total_gauss
    refs = [ws for _u, _f, ws in lda["test"]]
    hyps = {}
    for side, res, mod in (("j", jres, jlda), ("t", tres, tlda)):
        opts = mod.LdaMlltTrainOpts(**cs.LDA_SMALL)
        feats, nf = cs.pad_batch([res.transform_feats(f, opts)
                                  for _u, f, _w in lda["test"]])
        dec = _decoder(res.model, side)
        ll = (res.model.am.loglikes_np(feats) if side == "j"
              else res.model.am.loglikes(feats))
        hyps[side] = _words(res.model.lang, dec.decode(ll, nf))
    assert hyps["t"] == hyps["j"]
    assert cs.wer(refs, hyps["t"]) == 0.0
