"""Port parity: hybrid TDNN training from GMM alignments
(kaldi_tpu_torch.steps.tdnn) against kaldi_tpu's on the CPU, on a small
yesno corpus (the port's MFCC fed to both packages) with a JAX monophone
carried across by `params.mono_model_from_jax`.

- `align_with_gmm`: the same (features, pdf ids) per utterance as JAX's,
  and `make_egs` of them the same arrays.
- `train_tdnn` (its init drawn by a torch.Generator from `seed`, so not
  JAX's draws): the loss falls, the priors are JAX's alignment-count
  priors, the hybrid aligns every utterance, and one seed trains one
  net.
- a `mesh=` that is not a parallel.mesh DeviceMesh is refused, as the
  train step refuses it (training on a mesh:
  tests/test_torch_parallel_train.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kaldi_tpu.fst.lang import Lexicon as JLexicon, prepare_lang as jprepare
from kaldi_tpu.nnet.train import make_egs as jmake_egs
from kaldi_tpu.steps import mono as jmono
from kaldi_tpu.steps import tdnn as jtdnn
from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
from kaldi_tpu_torch.nnet.train import NnetTrainOpts, make_egs
from kaldi_tpu_torch.params import mono_model_from_jax
from kaldi_tpu_torch.steps import tdnn as ttdnn
from kaldi_tpu_torch.steps.mono import MonoModel

torch.set_num_threads(2)

CONFIG = TdnnConfig(feat_dim=0, num_pdfs=0, hidden_dim=32, pnorm_output_dim=8,
                    nonlinearity="relu",
                    splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))


@pytest.fixture(scope="module")
def yesno():
    rng = np.random.RandomState(8)
    utts = []
    for i in range(12):
        ws = [str(rng.choice(["YES", "NO"])) for _ in range(rng.randint(2, 5))]
        utts.append((f"u{i}", cs.mfcc_deltas(cs.yesno_synth(ws, rng), "cpu"),
                     ws))
    jl = jprepare(JLexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                  num_sil_states=3)
    tl = prepare_lang(Lexicon.parse(cs.YESNO_LEXICON), ["SIL"], "SIL",
                      num_sil_states=3)
    jm = jmono.train_mono(jl, utts, jmono.MonoTrainOpts(
        num_iters=6, totgauss=30, max_iter_inc=4,
        realign_iters=tuple(range(1, 6))))
    return dict(utts=utts, jm=jm, tm=mono_model_from_jax(jm, tl, "cpu"))


def test_align_with_gmm_and_egs_match_jax(yesno):
    ja = jtdnn.align_with_gmm(yesno["jm"], yesno["utts"])
    ta = ttdnn.align_with_gmm(yesno["tm"], yesno["utts"])
    assert len(ta) == len(ja) == len(yesno["utts"])
    for (jf, jp), (tf, tp) in zip(ja, ta):
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tp, jp)
    for chunk in (8, 5):
        je, te = jmake_egs(ja, 2, 2, chunk), make_egs(ta, 2, 2, chunk)
        for k in ("feats", "targets", "weights"):
            np.testing.assert_array_equal(te[k], np.asarray(je[k]))
            assert te[k].dtype == np.asarray(je[k]).dtype


def test_train_tdnn_trains_on_gmm_alignments(yesno):
    tm = yesno["tm"]
    res = ttdnn.train_tdnn(tm, yesno["utts"], config=CONFIG,
                           train_opts=NnetTrainOpts(initial_lr=0.05,
                                                    final_lr=0.01,
                                                    num_epochs=6,
                                                    minibatch_size=32),
                           seed=3)
    losses = [loss for _e, _k, loss, _a in res.history]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < 0.7 * losses[0], losses
    am = res.am
    assert am.model.config.feat_dim == 39
    assert am.model.config.num_pdfs == tm.am.num_pdfs
    assert next(am.model.parameters()).device.type == "cpu"
    # the priors: JAX's rule over the same alignments
    counts = np.zeros(tm.am.num_pdfs)
    for _f, pdfs in ttdnn.align_with_gmm(tm, yesno["utts"]):
        np.add.at(counts, pdfs, 1.0)
    np.testing.assert_allclose(am.priors, (counts + 0.5)
                               / (counts + 0.5).sum(), rtol=1e-12)
    # the hybrid model (AmNnet in the GMM's place) aligns every utterance
    hybrid = MonoModel(am, tm.trans_model, tm.ctx_dep, tm.lang)
    assert am.device.type == "cpu"
    assert len(ttdnn.align_with_gmm(hybrid, yesno["utts"])) == \
        len(yesno["utts"])
    # the same seed draws the same init and trains the same net
    again = ttdnn.train_tdnn(tm, yesno["utts"][:3], config=CONFIG,
                             train_opts=NnetTrainOpts(num_epochs=1), seed=3)
    twice = ttdnn.train_tdnn(tm, yesno["utts"][:3], config=CONFIG,
                             train_opts=NnetTrainOpts(num_epochs=1), seed=3)
    for k, v in again.am.model.state_dict().items():
        torch.testing.assert_close(twice.am.model.state_dict()[k], v,
                                   rtol=0, atol=0)


def test_train_tdnn_mesh_raises(yesno):
    """A mesh that is not a parallel.mesh DeviceMesh is refused (mesh
    training: tests/test_torch_parallel_train.py)."""
    with pytest.raises(TypeError):
        ttdnn.train_tdnn(yesno["tm"], yesno["utts"][:2], config=CONFIG,
                         mesh=object())
