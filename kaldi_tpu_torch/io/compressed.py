"""Lossy compressed feature storage (the egs/feature archive format).

(ref: matrix/compressed-matrix.h:45,128-146 CompressedMatrix — global
 header (min, range) + per-column headers quantizing the 0th/25th/75th/
 100th percentiles to uint16, then each element to uint8 in a 3-segment
 piecewise-linear map [0,64]/[64,192]/[192,255] between those percentiles.
 We reproduce that scheme so compressed features round-trip with the same
 accuracy class as the reference; arrays decompress to float32 [T, D]
 ready for a tensor.)

The port's copy of kaldi_tpu/io/compressed.py (host code).
"""

from __future__ import annotations

import numpy as np


class CompressedMatrix:
    """Per-column percentile-quantized uint8 storage of a [T, D] matrix."""

    def __init__(self, global_min: float, global_range: float,
                 col_headers: np.ndarray, data: np.ndarray, shape):
        self.global_min = global_min
        self.global_range = global_range
        self.col_headers = col_headers    # [D, 4] uint16
        self.data = data                  # [D, T] uint8 (column-major)
        self.shape = shape

    @property
    def nbytes(self) -> int:
        return self.col_headers.nbytes + self.data.nbytes + 8

    @staticmethod
    def compress(mat: np.ndarray) -> "CompressedMatrix":
        """Delegates to the single on-disk-format implementation in
        kaldi_io (_compute_col_header/_float_to_char), so in-memory
        CompressedMatrix and write_ark(compress=True) quantize
        identically."""
        from kaldi_tpu_torch.io.kaldi_io import (
            _compute_col_headers, _float_to_char, _uint16_to_float)
        mat = np.asarray(mat, np.float32)
        T, D = mat.shape
        if T == 0:
            raise ValueError("cannot compress a zero-row matrix")
        if D == 0:
            return CompressedMatrix(0.0, 1e-20,
                                    np.zeros((0, 4), np.uint16),
                                    np.zeros((0, T), np.uint8), (T, 0))
        gmin = float(mat.min())
        grange = max(float(mat.max()) - gmin, 1e-20)
        h = _compute_col_headers(gmin, grange, mat)
        v = _uint16_to_float(gmin, grange, h)
        u8 = _float_to_char(v[:, 0:1], v[:, 1:2], v[:, 2:3], v[:, 3:4],
                            np.ascontiguousarray(mat.T))
        return CompressedMatrix(gmin, grange, h, u8, (T, D))

    def decompress(self) -> np.ndarray:
        """Delegates to the one shared decoder in kaldi_io, so in-memory
        round-trips are bit-identical to ark round-trips."""
        from kaldi_tpu_torch.io.kaldi_io import _char_to_float
        T, D = self.shape
        if D == 0:
            return np.empty((T, 0), np.float32)
        return _char_to_float(self.global_min, self.global_range,
                              self.col_headers, self.data)
