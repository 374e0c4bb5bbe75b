"""DCT and cepstral liftering as matmul-shaped constants.

Counterpart of kaldi_tpu/ops/dct.py (ref: matrix/matrix-functions.cc:592-608
ComputeDctMatrix; feat/mel-computations.cc:248-254 ComputeLifterCoeffs):
the same numpy constants, returned as tensors on the caller's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(num_rows: int, num_cols: int) -> np.ndarray:
    """Normalized DCT-II matrix [num_rows, num_cols]; row 0 is the sqrt(1/N) row."""
    n = np.arange(num_cols, dtype=np.float64)
    k = np.arange(num_rows, dtype=np.float64)
    m = math.sqrt(2.0 / num_cols) * np.cos(
        math.pi / num_cols * (n[None, :] + 0.5) * k[:, None]
    )
    m[0, :] = math.sqrt(1.0 / num_cols)
    return m.astype(np.float32)


def dct_matrix(num_rows: int, num_cols: int, device=None) -> torch.Tensor:
    return torch.as_tensor(_dct_matrix_np(num_rows, num_cols), device=device)


@functools.lru_cache(maxsize=None)
def _lifter_np(q: float, dim: int) -> np.ndarray:
    i = np.arange(dim, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def lifter_coeffs(q: float, dim: int, device=None) -> torch.Tensor:
    """coeffs[i] = 1 + (Q/2) sin(pi i / Q); index 0 (C0) unaffected."""
    return torch.as_tensor(_lifter_np(float(q), dim), device=device)
