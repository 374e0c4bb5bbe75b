"""Conversion between kaldi_tpu params pytrees and the port's modules.

The JAX `Tdnn` keeps its weights as a pytree
`{"layers": [{"w": [in, out], "b": [out]}, ...], "final": {"w", "b"}}`
(kaldi_tpu/nnet/tdnn.py `Tdnn.init`). The port keeps the same [in, out]
layout, so conversion copies leaf for leaf. Leaves are numpy arrays (or
anything `np.asarray` takes); this module never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch


def tdnn_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX Tdnn params pytree -> state dict of `kaldi_tpu_torch.nnet.tdnn.Tdnn`
    (f32 CPU tensors; `load_state_dict` copies them to the module's device)."""
    out = {}
    for i, layer in enumerate(tree["layers"]):
        out[f"layers.{i}.w"] = torch.from_numpy(
            np.array(layer["w"], np.float32))
        out[f"layers.{i}.b"] = torch.from_numpy(
            np.array(layer["b"], np.float32))
    out["final.w"] = torch.from_numpy(np.array(tree["final"]["w"], np.float32))
    out["final.b"] = torch.from_numpy(np.array(tree["final"]["b"], np.float32))
    return out


def random_tdnn_params(config, rng: np.random.Generator) -> dict:
    """Seeded random weights in the JAX pytree layout, drawn with numpy so
    both frameworks can be fed the same arrays. Hidden layers use
    `affine_init`'s stddevs (weights 1/sqrt(in), biases 1); the final layer
    gets weights of stddev 1/sqrt(in) and zero bias, so that acoustic costs
    are not all tied as with `Tdnn.init`'s zero final layer."""
    layers = []
    in_dim = config.feat_dim
    for ctx in config.splice_indexes:
        spliced = in_dim * len(ctx)
        layers.append({
            "w": (rng.standard_normal((spliced, config.hidden_dim))
                  / np.sqrt(spliced)).astype(np.float32),
            "b": rng.standard_normal(config.hidden_dim).astype(np.float32)})
        in_dim = (config.pnorm_output_dim if config.nonlinearity == "pnorm"
                  else config.hidden_dim)
    final = {"w": (rng.standard_normal((in_dim, config.num_pdfs))
                   / np.sqrt(in_dim)).astype(np.float32),
             "b": np.zeros(config.num_pdfs, np.float32)}
    return {"layers": layers, "final": final}


def tdnn_params_to_jax(model) -> dict:
    """The inverse: a port Tdnn -> JAX-layout pytree with numpy leaves."""
    def leaf(t):
        return t.detach().cpu().numpy().astype(np.float32)
    return {"layers": [{"w": leaf(l.w), "b": leaf(l.b)} for l in model.layers],
            "final": {"w": leaf(model.final.w), "b": leaf(model.final.b)}}
