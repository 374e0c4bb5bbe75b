"""nnet3 simple components as functions on tensors, with their
initializers.

Counterpart of kaldi_tpu/nnet3/components.py (ref:
nnet3/nnet-simple-component.h:42-842: AffineComponent,
NaturalGradientAffineComponent :403 (the natural gradient is the
optimizer's, nnet3/training.py), RectifiedLinear / Sigmoid / Tanh, Pnorm,
Normalize, LogSoftmax / Softmax, Fixed{Scale,Bias}, NoOp, Dropout,
Maxout, PerElementScale / Offset, ClipGradient, ElementwiseProduct).

`COMPONENT_TYPES` has JAX's types, configuration keys and init rules. An
affine's weight is [output-dim, input-dim] and applies as x @ w.T + b, as
in JAX, so weights convert leaf for leaf. Inits draw from a
`torch.Generator` (the stddevs of JAX's init, not its draws).
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.nnet.components import normalize, pnorm


def init_affine(generator: torch.Generator | None, input_dim: int,
                output_dim: int, param_stddev: float | None = None,
                bias_stddev: float = 0.0) -> dict[str, torch.Tensor]:
    """{"w": [out, in] of stddev param_stddev (default 1/sqrt(in)), "b":
    [out] of stddev bias_stddev}, on the generator's device."""
    if param_stddev is None:
        param_stddev = 1.0 / np.sqrt(input_dim)
    gdev = generator.device if generator is not None else None
    w = torch.randn(output_dim, input_dim, generator=generator, device=gdev)
    b = torch.randn(output_dim, generator=generator, device=gdev)
    return {"w": float(param_stddev) * w, "b": float(bias_stddev) * b}


def affine(params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["w"].T) + params["b"]


def _param_stddev(cfg):
    """param-stddev from a config line; None (-> 1/sqrt(in) default) only
    when the key is absent. An explicit param-stddev=0 means a zero init
    (the zero-init final layer idiom)."""
    return float(cfg["param-stddev"]) if "param-stddev" in cfg else None


def _init_affine_cfg(generator, cfg):
    return init_affine(generator, int(cfg["input-dim"]),
                       int(cfg["output-dim"]), _param_stddev(cfg),
                       float(cfg.get("bias-stddev", 0.0)))


def _elementwise_product(x: torch.Tensor, cfg) -> torch.Tensor:
    """input-dim = k * output-dim; the product over the k contiguous blocks
    of output-dim (the LSTM gate-application primitive)."""
    d = int(cfg["output-dim"])
    return torch.prod(x.reshape(*x.shape[:-1], x.shape[-1] // d, d), dim=-2)


def _maxout(x: torch.Tensor, cfg) -> torch.Tensor:
    d = int(cfg["output-dim"])
    return torch.amax(x.reshape(*x.shape[:-1], d, x.shape[-1] // d), dim=-1)


COMPONENT_TYPES = {
    # type -> (has_params, make_params(generator, cfg), apply(params, x, cfg))
    "AffineComponent": (
        True, _init_affine_cfg, lambda p, x, cfg: affine(p, x)),
    "NaturalGradientAffineComponent": (
        True, _init_affine_cfg, lambda p, x, cfg: affine(p, x)),
    "RectifiedLinearComponent": (
        False, None, lambda p, x, cfg: torch.relu(x)),
    "SigmoidComponent": (
        False, None, lambda p, x, cfg: torch.sigmoid(x)),
    "TanhComponent": (
        False, None, lambda p, x, cfg: torch.tanh(x)),
    "PnormComponent": (
        False, None,
        lambda p, x, cfg: pnorm(x, int(cfg["output-dim"]),
                                float(cfg.get("p", 2.0)))),
    "NormalizeComponent": (
        False, None,
        lambda p, x, cfg: normalize(x, float(cfg.get("target-rms", 1.0)))),
    "SoftmaxComponent": (
        False, None, lambda p, x, cfg: torch.softmax(x, dim=-1)),
    "LogSoftmaxComponent": (
        False, None, lambda p, x, cfg: torch.log_softmax(x, dim=-1)),
    "NoOpComponent": (False, None, lambda p, x, cfg: x),
    # groups of input-dim / output-dim reduced by max
    "MaxoutComponent": (False, None, lambda p, x, cfg: _maxout(x, cfg)),
    # inference-mode scaling only: a trainer masks with its own draw
    "DropoutComponent": (
        False, None,
        lambda p, x, cfg: x * float(cfg.get("dropout-proportion-scale",
                                            1.0))),
    "PerElementScaleComponent": (
        True,
        lambda generator, cfg: {"s": torch.ones(int(cfg["dim"]))},
        lambda p, x, cfg: x * p["s"]),
    "PerElementOffsetComponent": (
        True,
        lambda generator, cfg: {"o": torch.zeros(int(cfg["dim"]))},
        lambda p, x, cfg: x + p["o"]),
    "ClipGradientComponent": (False, None, lambda p, x, cfg: x),
    "ElementwiseProductComponent": (
        False, None, lambda p, x, cfg: _elementwise_product(x, cfg)),
    "FixedScaleComponent": (
        False, None, lambda p, x, cfg: x * float(cfg.get("scale", 1.0))),
    "FixedBiasComponent": (
        False, None, lambda p, x, cfg: x + float(cfg.get("bias", 0.0))),
}
