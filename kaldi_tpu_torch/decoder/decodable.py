"""Decodable adapters: a loglikes tensor [..., T, N] and pure functions.

Counterpart of kaldi_tpu/decoder/decodable.py (ref: itf/decodable-itf.h:83-118
DecodableInterface; decoder/decodable-matrix.h:33
DecodableMatrixScaledMapped, :169 DecodableMatrixScaled;
decoder/decodable-mapped.h DecodableMapped; decoder/decodable-sum.h
DecodableSum / DecodableSumScaled). Each reference adapter class is one
tensor transformation on the tensor's own device.
"""

from __future__ import annotations

import numpy as np
import torch


def scale_loglikes(loglikes, acoustic_scale: float):
    """DecodableMatrixScaled: lls * scale (ref: decodable-matrix.h:169)."""
    return loglikes * acoustic_scale


def map_loglikes(loglikes: torch.Tensor, id2pdf: np.ndarray,
                 acoustic_scale: float = 1.0) -> torch.Tensor:
    """Per-pdf loglikes [..., T, num_pdfs] -> per-transition-id
    [..., T, num_tids] via the tid->pdf map (ref: decodable-matrix.h:33
    DecodableMatrixScaledMapped). tid 0 is invalid and maps to pdf -1 in
    the table; it gets column 0's value but is never consulted (no arc
    carries tid 0)."""
    idx = torch.as_tensor(np.maximum(np.asarray(id2pdf), 0).astype(np.int64),
                          device=loglikes.device)
    return acoustic_scale * loglikes.index_select(-1, idx)


def index_map_loglikes(loglikes: torch.Tensor, index_map) -> torch.Tensor:
    """DecodableMapped: generic index remap of the score axis
    (ref: decoder/decodable-mapped.h — LogLikelihood(frame, i) =
    base(frame, index_map[i]))."""
    idx = torch.as_tensor(np.asarray(index_map).astype(np.int64),
                          device=loglikes.device)
    return loglikes.index_select(-1, idx)


def sum_loglikes(loglikes_list, scales=None):
    """DecodableSum(Scaled): model interpolation by adding (optionally
    scaled) log-likelihood tensors of the same shape
    (ref: decoder/decodable-sum.h)."""
    if scales is None:
        scales = [1.0] * len(loglikes_list)
    if len(scales) != len(loglikes_list):
        raise ValueError("one scale per decodable")
    acc = None
    for lls, s in zip(loglikes_list, scales):
        term = lls if s == 1.0 else lls * s
        acc = term if acc is None else acc + term
    return acc
