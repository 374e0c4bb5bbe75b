"""Kaldi-compatible binary/text ark & scp tables, plus extended filenames.

Implements the on-disk formats of the reference's Table system
(ref: util/kaldi-table.h:105-421, util/kaldi-holder.h, base/io-funcs.h,
 matrix/kaldi-matrix.cc Write/Read, matrix/compressed-matrix.h:128-146)
so features/alignments/transcripts can round-trip with reference tools for
differential testing. The in-memory API is plain Python: iterators of
(key, value) and dict-like random access — the framework's "Table".

Supported holders: float/double matrix ("FM"/"DM"), vector ("FV"/"DV"),
compressed matrix ("CM"), int32 vectors (alignments), text tokens.

Extended filenames (ref: util/kaldi-io.h:56-118): "-" (stdin/stdout),
"file", "gzip -c > f.gz|" / "gunzip -c f.gz|" pipes, "file:offset".

The port's copy of kaldi_tpu/io/kaldi_io.py (host code); plain binary
arks stream through the port's own native reader (io/native.py over
kaldi_tpu_torch/native/ark_io.cc).
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
from typing import Iterator

import numpy as np

# ---------------------------------------------------------------------------
# extended filenames


def _classify(name: str):
    if name == "-" or name == "":
        return "std", name
    if name.endswith("|"):
        return "pipe_in", name[:-1]
    if name.startswith("|"):
        return "pipe_out", name[1:]
    # file:offset
    if ":" in name:
        base, _, off = name.rpartition(":")
        if off.isdigit() and os.path.exists(base):
            return "offset", (base, int(off))
    return "file", name


class _PipeReader:
    def __init__(self, cmd):
        self.proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        self.stream = self.proc.stdout

    def read(self, n=-1):
        return self.stream.read(n)

    def peek(self, n=1):
        return self.stream.peek(n)  # type: ignore[attr-defined]

    def close(self):
        self.stream.close()
        self.proc.wait()


def open_rxfilename(name: str):
    kind, v = _classify(name)
    if kind == "std":
        return io.BufferedReader(io.FileIO(0, "rb", closefd=False))
    if kind == "pipe_in":
        return _PipeReader(v).stream
    if kind == "offset":
        base, off = v
        f = open(base, "rb")
        f.seek(off)
        return f
    if kind == "pipe_out":
        raise ValueError(f"write-only filename used for reading: {name!r}")
    return open(v, "rb")


def open_wxfilename(name: str):
    kind, v = _classify(name)
    if kind == "std":
        return io.BufferedWriter(io.FileIO(1, "wb", closefd=False))
    if kind == "pipe_out":
        proc = subprocess.Popen(v, shell=True, stdin=subprocess.PIPE)
        return proc.stdin
    if kind == "pipe_in":
        raise ValueError(f"read-only filename used for writing: {name!r}")
    return open(v if kind == "file" else v[0], "wb")


# ---------------------------------------------------------------------------
# low-level binary primitives (ref: base/io-funcs.h)


def _write_token(f, tok: str):
    f.write(tok.encode() + b" ")


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok.decode()


def _write_int32(f, v: int):
    f.write(b"\x04" + struct.pack("<i", v))


def _read_int32(f) -> int:
    sz = f.read(1)
    assert sz == b"\x04", f"expected int32 size byte, got {sz!r}"
    return struct.unpack("<i", f.read(4))[0]


def _write_float(f, v: float):
    f.write(b"\x04" + struct.pack("<f", v))


def _read_float(f) -> float:
    sz = f.read(1)
    assert sz == b"\x04"
    return struct.unpack("<f", f.read(4))[0]


# ---------------------------------------------------------------------------
# object (matrix / vector / int-vector) serialization


def write_object(f, value, binary=True, compress=False):
    """Write one Kaldi object after the '\\0B' binary header."""
    if binary:
        f.write(b"\x00B")
        if isinstance(value, (list, tuple)) or (
            isinstance(value, np.ndarray)
            and value.dtype.kind in "iu"
            and value.ndim == 1
        ):
            v = np.asarray(value, dtype=np.int32)
            f.write(struct.pack("<b", 4))
            f.write(struct.pack("<i", len(v)))
            f.write(v.astype("<i4").tobytes())
            return
        arr = np.asarray(value)
        if compress and arr.ndim == 2:
            _write_compressed_matrix(f, arr.astype(np.float32))
            return
        if arr.ndim == 1:
            tok = "FV" if arr.dtype != np.float64 else "DV"
            _write_token(f, tok)
            _write_int32(f, arr.shape[0])
            dt = "<f4" if tok == "FV" else "<f8"
            f.write(np.ascontiguousarray(arr).astype(dt).tobytes())
        elif arr.ndim == 2:
            tok = "FM" if arr.dtype != np.float64 else "DM"
            _write_token(f, tok)
            _write_int32(f, arr.shape[0])
            _write_int32(f, arr.shape[1])
            dt = "<f4" if tok == "FM" else "<f8"
            f.write(np.ascontiguousarray(arr).astype(dt).tobytes())
        else:
            raise ValueError(f"unsupported ndim {arr.ndim}")
    else:
        arr = np.asarray(value)
        if arr.ndim == 1 and arr.dtype.kind in "iu":
            f.write(b" ".join(str(int(x)).encode() for x in arr) + b"\n")
        elif arr.ndim == 1:
            f.write(b" [ " + b" ".join(repr(float(x)).encode() for x in arr) + b" ]\n")
        else:
            f.write(b" [")
            for row in arr:
                f.write(b"\n  " + b" ".join(repr(float(x)).encode() for x in row))
            f.write(b" ]\n")


def read_object(f):
    """Read one Kaldi object; auto-detects binary ('\\0B') vs text."""
    first = f.read(1)
    if first == b"\x00":
        b = f.read(1)
        assert b == b"B", "corrupt binary header"
        return _read_binary_object(f)
    # text mode: read the rest of the line(s)
    return _read_text_object(f, first)


def _read_binary_object(f):
    pos_byte = f.read(1)
    if pos_byte == b"\x04":  # int32 vector (no token)
        n = struct.unpack("<i", f.read(4))[0]
        return np.frombuffer(f.read(4 * n), dtype="<i4").copy()
    tok = pos_byte.decode()
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c.decode()
    if tok in ("FM", "DM"):
        rows = _read_int32(f)
        cols = _read_int32(f)
        dt = "<f4" if tok == "FM" else "<f8"
        nbytes = rows * cols * (4 if tok == "FM" else 8)
        return np.frombuffer(f.read(nbytes), dtype=dt).reshape(rows, cols).astype(
            np.float32 if tok == "FM" else np.float64
        )
    if tok in ("FV", "DV"):
        n = _read_int32(f)
        dt = "<f4" if tok == "FV" else "<f8"
        return np.frombuffer(f.read(n * (4 if tok == "FV" else 8)), dtype=dt).astype(
            np.float32 if tok == "FV" else np.float64
        )
    if tok == "CM":
        return _read_compressed_matrix(f)
    raise ValueError(f"unknown object token {tok!r}")


def _read_text_object(f, first: bytes):
    buf = first
    depth = 0
    started = False
    while True:
        c = f.read(1)
        if not c:
            break
        buf += c
        if c == b"[":
            depth += 1
            started = True
        elif c == b"]":
            depth -= 1
            if started and depth == 0:
                f.read(1)  # trailing newline
                break
        elif c == b"\n" and not started:
            break
    text = buf.decode().strip()
    if text.startswith("["):
        text = text[1:-1]
        rows = [r.strip() for r in text.strip().split("\n") if r.strip()]
        mat = [np.fromstring(r, sep=" ") if hasattr(np, "fromstring")
               else np.fromiter(map(float, r.split()), float) for r in rows]
        mat = [np.fromiter((float(x) for x in r.split()), dtype=np.float64)
               for r in rows]
        if len(mat) == 1:
            return mat[0].astype(np.float32)
        return np.vstack(mat).astype(np.float32)
    return np.fromiter((int(x) for x in text.split()), dtype=np.int32)


# ---------------------------------------------------------------------------
# CompressedMatrix (ref: matrix/compressed-matrix.h:128-146)
#
# Layout: GlobalHeader{int32 format(=1), float min_value, float range,
# int32 num_rows, int32 num_cols}, then per-column PerColHeader{4x uint16
# percentile markers}, then uint8 data column-major.


def _float_to_uint16(gmin, grange, v):
    f = (v - gmin) / grange
    return np.clip(f * 65535.0 + 0.499, 0, 65535).astype(np.uint16)


def _uint16_to_float(gmin, grange, v):
    return gmin + grange * 1.52590218966964e-05 * v.astype(np.float32)


def _compute_col_headers(gmin, grange, mat):
    """Percentile markers for EVERY column at once -> [cols, 4] uint16,
    byte-identical to the reference per column
    (ref: compressed-matrix.cc:254-326 ComputeColHeader — quartiles at
    sorted indices rows//4 and 3*(rows//4), forced strictly increasing
    with caps 65532/65533/65534, plus the rows<5 pathological branch)."""
    rows = mat.shape[0]
    srt = np.sort(mat, axis=0)

    def f2u(v):  # [cols] float -> [cols] int64 (FloatToUint16, truncating)
        fr = np.clip((v.astype(np.float32) - np.float32(gmin))
                     / np.float32(grange), 0.0, 1.0)
        return (fr * 65535.0 + 0.499).astype(np.int64)

    if rows >= 5:
        q = rows // 4
        m0 = np.minimum(f2u(srt[0]), 65532)
        m25 = np.minimum(np.maximum(f2u(srt[q]), m0 + 1), 65533)
        m75 = np.minimum(np.maximum(f2u(srt[3 * q]), m25 + 1), 65534)
        m100 = np.maximum(f2u(srt[rows - 1]), m75 + 1)
    else:
        m0 = np.minimum(f2u(srt[0]), 65532)
        m25 = (np.minimum(np.maximum(f2u(srt[1]), m0 + 1), 65533)
               if rows > 1 else m0 + 1)
        m75 = (np.minimum(np.maximum(f2u(srt[2]), m25 + 1), 65534)
               if rows > 2 else m25 + 1)
        m100 = (np.maximum(f2u(srt[3]), m75 + 1)
                if rows > 3 else m75 + 1)
    return np.stack([m0, m25, m75, m100], axis=1).astype(np.uint16)


def _float_to_char(v0, v25, v75, v100, x):
    """3-segment byte quantization, broadcasting — v* [cols, 1] against
    x [cols, rows] (or plain 1-D) (ref: compressed-matrix.cc:331
    FloatToChar — ranges [p0,p25) -> 0..64, [p25,p75) -> 64..192,
    [p75,p100] -> 192..255, round-to-nearest)."""
    lo = x < v25
    hi = ~lo & (x >= v75)
    f_lo = np.floor((x - v0) / np.maximum(v25 - v0, 1e-20) * 64.0 + 0.5)
    f_mid = 64 + np.floor(
        (x - v25) / np.maximum(v75 - v25, 1e-20) * 128.0 + 0.5)
    f_hi = 192 + np.floor(
        (x - v75) / np.maximum(v100 - v75, 1e-20) * 63.0 + 0.5)
    b = np.where(lo, np.clip(f_lo, 0, 64),
                 np.where(hi, np.clip(f_hi, 192, 255),
                          np.clip(f_mid, 64, 192)))
    return b.astype(np.uint8)


def _char_to_float(gmin, grange, headers, raw):
    """Inverse of _float_to_char for all columns: headers [cols, 4]
    uint16, raw [cols, rows] uint8 -> [rows, cols] float32 — the ONE
    decoder shared by the ark reader and CompressedMatrix.decompress
    (ref: compressed-matrix.cc:364 CharToFloat; float32 arithmetic with
    the reference's 1/65535 constant)."""
    v = _uint16_to_float(gmin, grange,
                         np.ascontiguousarray(headers, np.uint16))
    v0, v25, v75, v100 = (v[:, k: k + 1] for k in range(4))
    b = raw.astype(np.float32)
    col = np.where(
        b <= 64,
        v0 + (v25 - v0) * (b * np.float32(1 / 64.0)),
        np.where(
            b <= 192,
            v25 + (v75 - v25) * ((b - 64.0) * np.float32(1 / 128.0)),
            v75 + (v100 - v75) * ((b - 192.0) * np.float32(1 / 63.0))))
    return col.T.astype(np.float32)


def _write_compressed_matrix(f, mat: np.ndarray):
    rows, cols = mat.shape
    if rows == 0:
        raise ValueError("cannot compress a zero-row matrix "
                         "(ref: ComputeColHeader asserts num_rows > 0)")
    gmin = float(mat.min()) if cols else 0.0
    grange = max(float(mat.max()) - gmin, 1e-20) if cols else 1e-20
    _write_token(f, "CM")
    f.write(struct.pack("<ffii", gmin, grange, rows, cols))
    if cols:
        h = _compute_col_headers(gmin, grange, mat)          # [cols, 4]
        v = _uint16_to_float(gmin, grange, h)                # [cols, 4]
        byts = _float_to_char(v[:, 0:1], v[:, 1:2], v[:, 2:3], v[:, 3:4],
                              np.ascontiguousarray(mat.T, np.float32))
        f.write(h.astype("<u2").tobytes())
        f.write(byts.tobytes())  # column-major: col-by-col


def _read_compressed_matrix(f) -> np.ndarray:
    gmin, grange, rows, cols = struct.unpack("<ffii", f.read(16))
    headers = np.frombuffer(f.read(8 * cols), dtype="<u2").reshape(cols, 4)
    raw = np.frombuffer(f.read(rows * cols), dtype=np.uint8).reshape(cols, rows)
    if cols == 0:
        return np.empty((rows, 0), np.float32)
    return _char_to_float(gmin, grange, headers, raw)


# ---------------------------------------------------------------------------
# ark / scp / specifiers


def write_ark(path_or_file, items, binary=True, compress=False, scp_path=None):
    """Write (key, value) pairs to an ark; optionally also an scp index."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open_wxfilename(str(path_or_file)) if own else path_or_file
    scp = open(scp_path, "w") if scp_path else None
    try:
        arkname = str(path_or_file) if own else None
        for key, value in items if not hasattr(items, "items") else items.items():
            f.write(key.encode() + b" ")
            if scp is not None and arkname is not None:
                off = f.tell()
                scp.write(f"{key} {arkname}:{off}\n")
            write_object(f, value, binary=binary, compress=compress)
    finally:
        if scp:
            scp.close()
        if own:
            f.close()


write_matrix_ark = write_ark


def read_ark(path_or_file) -> Iterator[tuple[str, np.ndarray]]:
    """Iterate (key, value) from an ark (binary or text, auto-detected).

    Plain binary files of FM/DM/FV/DV entries stream through the native
    C++ reader (kaldi_tpu_torch/native/ark_io.cc) when it is available; anything else
    (pipes, offsets, text, compressed entries) uses the Python path.
    """
    own = isinstance(path_or_file, (str, os.PathLike))
    skip = 0  # entries already yielded by the native reader
    if own:
        name = str(path_or_file)
        if _classify(name)[0] == "file" and os.path.exists(name):
            from kaldi_tpu_torch.io import native
            if native.available():
                try:
                    with open(name, "rb") as probe:
                        head = probe.read(4096)
                    sp = head.find(b" ")
                    if sp > 0 and head[sp + 1: sp + 3] == b"\x00B" \
                            and head[sp + 3: sp + 5] in (b"FM", b"DM",
                                                         b"FV", b"DV"):
                        for item in native.read_ark_native(name):
                            yield item
                            skip += 1
                        return
                except (ValueError, OSError):
                    # mixed/unsupported entry mid-stream: fall through to
                    # the Python reader, SKIPPING the entries the native
                    # reader already yielded (a bare restart would
                    # silently duplicate them)
                    pass
    f = open_rxfilename(str(path_or_file)) if own else path_or_file
    try:
        while True:
            key = _read_token(f)
            if not key:
                break
            value = read_object(f)
            if skip:
                skip -= 1
                continue
            yield key, value
    finally:
        if own:
            f.close()


read_matrix_ark = read_ark


def read_scp(path) -> Iterator[tuple[str, np.ndarray]]:
    """Iterate (key, value) pairs by following an scp index."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) != 2:
                continue
            key, rx = parts
            g = open_rxfilename(rx)
            try:
                yield key, read_object(g)
            finally:
                g.close()


def open_rspecifier(rspec: str) -> Iterator[tuple[str, np.ndarray]]:
    """Sequential reader for 'ark:...' / 'scp:...' rspecifiers.

    Options (t, b, p, o, s, cs) before the colon are accepted and ignored
    where they don't change semantics for a reader.
    """
    kind, _, rest = rspec.partition(":")
    kinds = kind.split(",")
    if "ark" in kinds:
        return read_ark(rest)
    if "scp" in kinds:
        return read_scp(rest)
    raise ValueError(f"bad rspecifier {rspec!r}")


class open_wspecifier:
    """Writer for 'ark:...', 'ark,t:...', 'ark,scp:a.ark,a.scp' wspecifiers."""

    def __init__(self, wspec: str, compress=False):
        kind, _, rest = wspec.partition(":")
        kinds = kind.split(",")
        self.binary = "t" not in kinds
        self.compress = compress
        self.scp = None
        self.arkname = None
        if "ark" in kinds and "scp" in kinds:
            arkname, scpname = rest.split(",")
            self.arkname = arkname
            self.f = open_wxfilename(arkname)
            self.scp = open(scpname, "w")
        elif "ark" in kinds:
            self.arkname = rest
            self.f = open_wxfilename(rest)
        else:
            raise ValueError(f"bad wspecifier {wspec!r}")

    def write(self, key: str, value):
        self.f.write(key.encode() + b" ")
        if self.scp is not None:
            off = self.f.tell()
            self.scp.write(f"{key} {self.arkname}:{off}\n")
        write_object(self.f, value, binary=self.binary, compress=self.compress)

    def close(self):
        self.f.close()
        if self.scp:
            self.scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
