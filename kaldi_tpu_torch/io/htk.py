"""HTK feature file reader — used to verify against the HTK golden fixtures
shipped with the reference (ref: feat/test_data/*.fea_htk.*; format per
util/kaldi-io ReadHtk usage in feat/feature-mfcc-test.cc:121-128).

The port's copy of kaldi_tpu/io/htk.py (host code)."""

from __future__ import annotations

import struct

import numpy as np


def write_htk(path, feats: np.ndarray, samp_period: int = 100000,
              parm_kind: int = 9) -> None:
    """Write features as an HTK file (ref: featbin/copy-feats-to-htk.cc;
    samp_period in 100ns units, default 10ms; parm_kind 9 = USER)."""
    feats = np.asarray(feats, np.float32)
    n, d = feats.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">iihh", n, samp_period, d * 4, parm_kind))
        f.write(feats.astype(">f4").tobytes())


def read_htk(path) -> tuple[np.ndarray, dict]:
    """Read an HTK feature file -> (features [T, D] float32, header dict)."""
    with open(path, "rb") as f:
        n_samples, samp_period, samp_size, parm_kind = struct.unpack(
            ">iihh", f.read(12)
        )
        dim = samp_size // 4
        data = np.frombuffer(f.read(n_samples * samp_size), dtype=">f4")
    feats = data.reshape(n_samples, dim).astype(np.float32)
    header = {
        "n_samples": n_samples,
        "samp_period": samp_period,
        "samp_size": samp_size,
        "parm_kind": parm_kind,
    }
    return feats, header
