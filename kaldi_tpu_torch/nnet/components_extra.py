"""Remaining nnet2 component zoo members: DCT, block-affine, additive
noise.

Counterpart of kaldi_tpu/nnet/components_extra.py (ref:
nnet2/nnet-component.h DctComponent, BlockAffineComponent :870,
AdditiveNoiseComponent). The DCT is a matmul over contiguous blocks of the
feature axis, the block affine one batched matmul over the block dim.
Random values (the block affine's init, the noise) come from a
`torch.Generator`; `add_noise` takes the drawn noise, so a test can hand
it JAX's draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n, n] in float64 (ref:
    matrix/matrix-functions.h:92 ComputeDctMatrix)."""
    m = np.zeros((n, n))
    for k in range(n):
        for j in range(n):
            m[k, j] = math.cos(math.pi / n * (j + 0.5) * k)
    m[0] *= math.sqrt(1.0 / n)
    m[1:] *= math.sqrt(2.0 / n)
    return m


def dct_component(x: torch.Tensor, dct_dim: int, dct_keep_dim: int = 0,
                  reorder: bool = False) -> torch.Tensor:
    """A DCT of each contiguous dct_dim block of the feature axis, keeping
    the first dct_keep_dim coefficients (0 = all). reorder=True reads the
    input coefficient-major ([..., dct_dim, nb]) and writes the output
    the same way."""
    D = x.shape[-1]
    assert D % dct_dim == 0, (D, dct_dim)
    nb = D // dct_dim
    keep = dct_keep_dim or dct_dim
    M = torch.as_tensor(dct_matrix(dct_dim)[:keep].T, dtype=x.dtype,
                        device=x.device)                      # [dct, keep]
    if reorder:
        xb = x.reshape(*x.shape[:-1], dct_dim, nb).transpose(-1, -2)
    else:
        xb = x.reshape(*x.shape[:-1], nb, dct_dim)
    y = torch.matmul(xb, M)                                   # [..., nb, keep]
    if reorder:
        y = y.transpose(-1, -2)
    return y.reshape(*x.shape[:-1], nb * keep)


def block_affine_init(generator: torch.Generator | None, input_dim: int,
                      output_dim: int, num_blocks: int,
                      param_stddev: float | None = None, device=None
                      ) -> dict[str, torch.Tensor]:
    """{"w": [num_blocks, bi, bo] of stddev 1/sqrt(bi), "b": zeros} drawn on
    the generator's device, then moved to `device`."""
    assert input_dim % num_blocks == 0 and output_dim % num_blocks == 0
    bi, bo = input_dim // num_blocks, output_dim // num_blocks
    if param_stddev is None:
        param_stddev = 1.0 / math.sqrt(bi)
    gdev = generator.device if generator is not None else None
    w = param_stddev * torch.randn(num_blocks, bi, bo, generator=generator,
                                   device=gdev)
    return {"w": w.to(device or w.device),
            "b": torch.zeros(num_blocks * bo, device=device or w.device)}


def block_affine_apply(params: dict[str, torch.Tensor], x: torch.Tensor
                       ) -> torch.Tensor:
    """[..., num_blocks*bi] -> [..., num_blocks*bo]: one batched matmul
    over the block dim."""
    nb, bi, bo = params["w"].shape
    xb = x.reshape(*x.shape[:-1], nb, bi)
    y = torch.einsum("...ni,nio->...no", xb, params["w"])
    return y.reshape(*x.shape[:-1], nb * bo) + params["b"]


def gaussian_noise(generator: torch.Generator | None, shape, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """Standard normal values drawn on the generator's device, moved to
    `device`."""
    gdev = generator.device if generator is not None else None
    n = torch.randn(shape, generator=generator, device=gdev, dtype=dtype)
    return n.to(device or n.device)


def add_noise(x: torch.Tensor, noise: torch.Tensor, stddev: float
              ) -> torch.Tensor:
    """x + stddev * noise, for a standard normal draw `noise`."""
    return x + stddev * noise.to(device=x.device, dtype=x.dtype)


def additive_noise(generator: torch.Generator | None, x: torch.Tensor,
                   stddev: float) -> torch.Tensor:
    """Train-time Gaussian noise (ref: nnet2 AdditiveNoiseComponent)."""
    return add_noise(x, gaussian_noise(generator, x.shape, x.device,
                                       x.dtype), stddev)
