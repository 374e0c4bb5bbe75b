"""fMPE's feature-transform composition, the one piece of
kaldi_tpu/transform/fmpe.py that the port's SAT training needs.

The port's copy of `compose_transforms` from kaldi_tpu/transform/fmpe.py
(host code), carried verbatim so the port imports nothing of kaldi_tpu;
tests hold the two equal. fMPE itself (`Fmpe`, its training) is not
ported yet.
"""

from __future__ import annotations

import numpy as np


def compose_transforms(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Affine composition: (a ∘ b)(x) = a(b(x)); a, b are [D, D+1]
    (ref: featbin/compose-transforms.cc, b-is-affine case)."""
    D = a.shape[0]
    A, abias = a[:, :D], a[:, D]
    B = np.concatenate([b, np.zeros((1, D + 1))], axis=0)
    B[D, D] = 1.0
    out = np.concatenate([A, abias[:, None]], axis=1) @ B
    return out
