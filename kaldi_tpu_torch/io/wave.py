"""RIFF/WAVE read & write (ref: feat/wave-reader.{h,cc}).

Samples are returned as float32 at int16 scale (e.g. +/-32768), matching the
reference convention so that downstream feature values (log energies etc.)
are directly comparable.

The port's copy of kaldi_tpu/io/wave.py (host code).
"""

from __future__ import annotations

import io
import struct

import numpy as np


def read_wave(path_or_bytes) -> tuple[np.ndarray, float]:
    """Read a PCM wav file -> (data [num_channels, num_samples] float32, samp_freq)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    else:
        f = open(path_or_bytes, "rb")
    try:
        head = f.read(12)
        riff = head[:4]
        if riff not in (b"RIFF", b"RIFX"):
            raise ValueError("not a RIFF/WAVE file")
        # RIFX = big-endian RIFF: ALL multi-byte fields (chunk sizes, fmt
        # fields, samples) are big-endian (ref: wave-reader.cc swaps on
        # the RIFX magic), not just the magic
        bo = ">" if riff == b"RIFX" else "<"
        _riff, _size, wave_tag = struct.unpack(f"{bo}4sI4s", head)
        if wave_tag != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            tag, size = struct.unpack(f"{bo}4sI", hdr)
            payload = f.read(size)
            if tag == b"fmt ":
                fmt = struct.unpack(f"{bo}HHIIHH", payload[:16])
            elif tag == b"data":
                data = payload
            if size % 2 == 1:
                f.read(1)
            if fmt is not None and data is not None:
                break
        if fmt is None or data is None:
            raise ValueError("missing fmt/data chunk")
        audio_format, num_channels, samp_freq, _brate, block_align, bits = fmt
        if audio_format not in (1, 0xFFFE) or bits != 16:
            raise ValueError(f"only 16-bit PCM supported, got fmt={audio_format} bits={bits}")
        samples = np.frombuffer(data, dtype=f"{bo}i2")
        n = len(samples) // num_channels
        samples = samples[: n * num_channels].reshape(n, num_channels).T
        return samples.astype(np.float32), float(samp_freq)
    finally:
        f.close()


def write_wave(path, data: np.ndarray, samp_freq: float) -> None:
    """Write [num_channels, num_samples] (or [num_samples]) float at int16 scale."""
    if data.ndim == 1:
        data = data[None, :]
    num_channels, n = data.shape
    pcm = np.clip(np.round(data.T), -32768, 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        byte_rate = int(samp_freq) * num_channels * 2
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(pcm), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", 1, num_channels, int(samp_freq),
                            byte_rate, num_channels * 2, 16))
        f.write(struct.pack("<4sI", b"data", len(pcm)))
        f.write(pcm)
