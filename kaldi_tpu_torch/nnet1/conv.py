"""1-D convolution along the feature (frequency) axis + max pooling.

Counterpart of kaldi_tpu/nnet1/conv.py (ref:
nnet/nnet-convolutional-component.h Convolutional1dComponent: patches of
`patch_dim` bins with `patch_step` stride, `num_filters` filters;
nnet/nnet-max-pooling-component.h MaxPoolingComponent). JAX's
`lax.conv_general_dilated` in NCW / OIW / NCW with VALID padding is the
cross-correlation `F.conv1d` computes; the output is then laid out patch
by patch, as JAX's `swapaxes` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Conv1dConfig:
    input_dim: int
    patch_dim: int
    patch_step: int
    num_filters: int

    @property
    def num_patches(self) -> int:
        return 1 + (self.input_dim - self.patch_dim) // self.patch_step

    @property
    def output_dim(self) -> int:
        return self.num_patches * self.num_filters


def conv1d_init(generator: torch.Generator | None, cfg: Conv1dConfig,
                device=None) -> dict[str, torch.Tensor]:
    """Filters of stddev 1/sqrt(patch_dim) (JAX's, not its draws), zero
    biases."""
    gdev = generator.device if generator is not None else None
    f = torch.randn(cfg.num_filters, cfg.patch_dim, generator=generator,
                    device=gdev)
    s = float(1.0 / np.sqrt(cfg.patch_dim))
    return {"filters": (s * f).to(device or f.device),
            "bias": torch.zeros(cfg.num_filters, device=device or f.device)}


def conv1d_apply(params: dict, x: torch.Tensor, cfg: Conv1dConfig
                 ) -> torch.Tensor:
    """x [..., input_dim] -> [..., num_patches * num_filters], the filters
    of one patch contiguous."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, cfg.input_dim)                   # [N, C=1, W]
    out = F.conv1d(flat, params["filters"][:, None, :],      # [O, I=1, K]
                   stride=cfg.patch_step)
    out = out + params["bias"][None, :, None]
    # [N, F, P] -> [N, P*F], patch-major
    return out.transpose(1, 2).reshape(*lead, -1)


def max_pooling_apply(x: torch.Tensor, pool_size: int, pool_step: int,
                      pool_stride: int) -> torch.Tensor:
    """The input as groups of `pool_stride` columns; pools of `pool_size`
    groups every `pool_step` groups, max-reduced. x [..., num_groups *
    pool_stride] -> [..., num_pools * pool_stride]."""
    lead = x.shape[:-1]
    num_groups = x.shape[-1] // pool_stride
    g = x.reshape(*lead, num_groups, pool_stride)
    num_pools = 1 + (num_groups - pool_size) // pool_step
    pools = [torch.amax(g[..., i * pool_step: i * pool_step + pool_size, :],
                        dim=-2) for i in range(num_pools)]
    return torch.stack(pools, dim=-2).reshape(*lead, -1)
