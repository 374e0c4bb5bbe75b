"""The DBN witness: JAX's CD-1 step and fine-tuning step against the
card's, on the card's inputs.

    python tests/test_torch_dbn_witness.py chiprun_out/dbn_witness.pkl

`chip_smoke.py` phase 24 (c) records the DBN's first RBM's first CD-1
minibatch (`cd1_witness_step`: the RbmConfig, the minibatch, the card's
hidden sample, the parameters before, the reconstruction error and the
parameters after) and its first fine-tuning minibatch at the top layer
(`top_witness_step`: the activations entering the top AffineTransform,
the targets, its weights before and after one SGD step; of the updated
weights the first rows). This script
replays both through kaldi_tpu/nnet1 on the CPU: JAX's `Rbm.cd1_step`
with its uniform draw replaced by one that reproduces the card's hidden
sample, and JAX's `train_frmshuff` over the top layer and its softmax.
It reports each updated array's largest difference from the card's
relative to the largest entry of JAX's step, and the reconstruction
errors. The test below records and replays a CPU run of the same two
steps at a small size, the port on the CPU standing in for the card.
"""

import json
import pickle
import sys
from unittest import mock

import numpy as np

import jax
import jax.numpy as jnp

from kaldi_tpu.nnet1 import nnet as jnn
from kaldi_tpu.nnet1 import rbm as jrbm

# each step's difference from JAX's over the largest entry of JAX's step:
# the f32 GEMMs of a minibatch (100-256 terms) in another order
STEP_REL = 1e-4


def _step_rel(got_after, want_after, before) -> float:
    step = np.asarray(want_after, np.float64) - before
    return float(np.abs(np.asarray(got_after, np.float64) - want_after).max()
                 / max(np.abs(step).max(), 1e-30))


def replay_rbm(r: dict) -> dict:
    """JAX's CD-1 step from the recorded parameters on the recorded
    minibatch, its hidden sample the card's."""
    cfg = jrbm.RbmConfig(**r["cfg"])
    rbm = jrbm.Rbm(cfg)
    rbm.W = jnp.asarray(r["W"])
    rbm.vis_bias = jnp.asarray(r["vis_bias"])
    rbm.hid_bias = jnp.asarray(r["hid_bias"])
    sample = jnp.asarray(r["h_sample"])
    if cfg.hidden_type == "bernoulli":
        # uniform draws under which `u < h_pos` is the card's sample
        fake = ("uniform", lambda key, shape: jnp.where(sample > 0, 0.0, 1.0))
    else:
        fake = ("normal", lambda key, shape: sample - rbm.propagate(
            jnp.asarray(r["v"])))
    with mock.patch.object(jrbm.jax.random, fake[0], fake[1]):
        mse = rbm.cd1_step(jnp.asarray(r["v"]), jax.random.PRNGKey(0))
    n = len(r["W_after"])
    return dict(
        mse_card=float(r["mse"]), mse_jax=float(mse),
        W=_step_rel(r["W_after"], np.asarray(rbm.W)[:n], r["W"][:n]),
        hid_bias=_step_rel(r["hid_bias_after"], np.asarray(rbm.hid_bias)[:n],
                           r["hid_bias"][:n]),
        vis_bias=_step_rel(r["vis_bias_after"], np.asarray(rbm.vis_bias),
                           r["vis_bias"]))


def replay_finetune(f: dict) -> dict:
    """JAX's SGD step of the top AffineTransform + Softmax on the
    recorded activations and targets."""
    P, H = f["w"].shape
    net = jnn.Nnet1([jnn.Component("AffineTransform", H, P),
                     jnn.Component("Softmax", P, P)])
    params = [{"w": jnp.asarray(f["w"]), "b": jnp.asarray(f["b"])}, {}]
    after, _h = jnn.train_frmshuff(net, params, f["x"],
                                   f["targets"].astype(np.int64),
                                   learn_rate=f["learn_rate"],
                                   minibatch=len(f["x"]), num_epochs=1)
    n = len(f["w_after"])
    return dict(w=_step_rel(f["w_after"], np.asarray(after[0]["w"])[:n],
                            f["w"][:n]),
                b=_step_rel(f["b_after"], np.asarray(after[0]["b"]), f["b"]))


def witness(data: dict) -> dict:
    return dict(rbm=replay_rbm(data["rbm"]),
                finetune=replay_finetune(data["finetune"]))


def test_dbn_witness_replays_cpu_steps_through_jax():
    """A gaussian-bernoulli RBM's first CD-1 step and a sigmoid-stack DBN's
    first fine-tuning step at the top, recorded as phase 24 (c) records
    them with the port on the CPU, replayed through JAX: every updated
    array within STEP_REL of JAX's step, the reconstruction error JAX's."""
    import torch
    import chip_smoke as cs
    from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
    rng = np.random.RandomState(5)
    x_all = torch.as_tensor(rng.randn(300, 12).astype(np.float32))
    y_all = torch.as_tensor(rng.randint(0, 7, 300)).long()
    rbm = Rbm(RbmConfig(12, 16, learning_rate=cs.DBN["gb_lr"]), seed=0,
              device="cpu")
    gen = torch.Generator().manual_seed(100)
    rbm_w = cs.cd1_witness_step(rbm, x_all[:100], gen)
    w = torch.as_tensor(0.1 * rng.randn(7, 16).astype(np.float32))
    ft = cs.top_witness_step([rbm], w, torch.zeros(7), x_all, y_all)
    data = pickle.loads(pickle.dumps(dict(rbm=rbm_w, finetune=ft),
                                     protocol=4))
    assert data["finetune"]["x"].shape == (cs.DBN["ft_mb"], 16)
    out = witness(data)
    r, f = out["rbm"], out["finetune"]
    assert abs(r["mse_card"] - r["mse_jax"]) <= 1e-5 * r["mse_jax"]
    assert max(r["W"], r["hid_bias"], r["vis_bias"]) <= STEP_REL, r
    assert max(f["w"], f["b"]) <= STEP_REL, f


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    with open(sys.argv[1], "rb") as fh:
        print(json.dumps(witness(pickle.load(fh)), indent=1))
