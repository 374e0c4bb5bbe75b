"""The TDNN sMBR witness: one `train_nnet_discriminative` step's
posteriors, objective and gradient through JAX against the card's, on
the card's inputs.

    python tests/test_torch_smbr_witness.py chiprun_out/smbr_witness.pkl

`chip_smoke.py` phase 22 (b) saves, before its sMBR training, the first
minibatch (the features with the TDNN's context, the numerator alignment
and the denominator lattice), the TDNN's config, params and priors, the
transition model, and the card's loglikes, dense signed posteriors
(`compute_discriminative_post`), sMBR objective and the gradient of the
surrogate loss -sum(post * logprob) at those params
(`smbr_witness_data`). This script rebuilds JAX's AmNnet from the params
and replays kaldi_tpu/nnet/discriminative.py's step (:83): the loglikes,
the lattice pass, the objective and the gradient, once from JAX's own
posteriors and once from the card's (which isolates the backward pass),
and reports the largest differences. The test below runs the same
comparison on tests/test_torch_nnet_discriminative.py's yesno egs, the
port on the CPU standing in for the card.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.nnet import discriminative as jdisc
from kaldi_tpu.nnet.am_nnet import AmNnet as JAmNnet
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu_torch.params import params_to_jax

from test_torch_lat_posteriors import lattice_to_jax


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def witness(data: dict) -> dict:
    import torch
    cfg = dict(data["config"])
    cfg["splice_indexes"] = tuple(tuple(s) for s in cfg["splice_indexes"])
    jcfg = JTdnnConfig(**cfg)
    jmodel = JTdnn(jcfg)
    jparams = params_to_jax({k: torch.from_numpy(np.asarray(v))
                             for k, v in data["params"].items()})
    jam = JAmNnet(jmodel, jparams, data["priors"])
    feats, ali = data["feats"], data["ali"]
    lc, T = jcfg.left_context, len(ali)
    ll = jam.loglikes_np(feats[None])[0][lc:lc + T]
    opts = jdisc.NnetDiscriminativeOpts(**data["opts"])
    post, objf = jdisc.compute_discriminative_post(
        jam, lattice_to_jax(data["lattice"]), ali, data["tm"], opts, ll,
        set(data["silence_phones"]))

    def grads_of(p_dense):
        def loss_fn(p):
            logprob = jmodel.apply(p, jnp.asarray(feats)[None],
                                   pad_context=False)[0]
            return -jnp.sum(jnp.asarray(p_dense) * logprob)
        return jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(jparams))
    card = params_to_jax({k: torch.from_numpy(np.asarray(v))
                          for k, v in data["grads"].items()})
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(card)}
    out = dict(frames=T, objf_card=data["objf"], objf_jax=float(objf),
               objf_per_frame_jax=float(objf) / T,
               d_ll=_rel(data["ll"], ll), d_post=float(
                   np.abs(np.asarray(data["post"]) - post).max()),
               post_scale=float(np.abs(post).max()))
    for tag, p in (("own", post), ("card_post", data["post"])):
        g = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_leaves_with_path(grads_of(p))}
        out[f"d_grad_{tag}"] = {k: _rel(flat[k], g[k]) for k in sorted(g)}
    return out


def test_smbr_witness_at_cpu_size():
    """test_torch_nnet_discriminative.py's first yesno eg and TDNN: the
    port's saved step (on the CPU, for the card's) through JAX: the same
    loglikes (1e-5), posteriors and objective (1e-4), and gradients within
    1e-4 of their largest entry, from either side's posteriors."""
    import chip_smoke as cs
    from kaldi_tpu_torch.nnet import discriminative as tdisc
    from kaldi_tpu_torch.params import lattice_from_jax
    from test_torch_lat_posteriors import build_system
    from test_torch_nnet_discriminative import CFG
    import test_torch_nnet_discriminative as tnd
    system = build_system(jax_decode=False)
    nnet = tnd.nnet.__wrapped__(system)
    f, ali, lat = nnet["egs"][0]
    data = cs.smbr_witness_data(
        nnet["tam"], system["model"].trans_model,
        (f, ali, lattice_from_jax(lat)),
        tdisc.NnetDiscriminativeOpts(criterion="smbr", learning_rate=3e-4),
        nnet["sil"])
    assert data["config"]["hidden_dim"] == CFG["hidden_dim"]
    out = witness(data)
    assert out["d_ll"] <= 1e-5
    assert out["d_post"] <= 1e-4 * max(out["post_scale"], 1.0)
    assert abs(out["objf_card"] - out["objf_jax"]) <= 1e-4 * max(
        1.0, abs(out["objf_jax"]))
    for tag in ("own", "card_post"):
        assert max(out[f"d_grad_{tag}"].values()) <= 1e-4, out


if __name__ == "__main__":
    import pickle
    with open(sys.argv[1], "rb") as f:
        print(json.dumps(witness(pickle.load(f)), indent=1))
