"""ctypes bindings for the native ark I/O library
(kaldi_tpu_torch/native/ark_io.cc), ported from kaldi_tpu/io/native.py.

(ref: the reference's table layer util/kaldi-table.h is C++; this is our
 equivalent native runtime component. Every entry point has a pure-Python
 fallback in kaldi_io.py, which `read_ark` takes when the library is not
 available, as in the JAX package.)

The source is compiled with g++ at first use, never at import, into
`build/kaldi_tpu_torch/<hash>/libkaldi_tpu_torch_ark.so` (the hash covers
the source and the flags): to a temporary file in that directory, then
`os.replace`, so a concurrent reader never loads a half-written library.
A failed build or load is not remembered: the next call tries again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from kaldi_tpu_torch.cuda_build import BUILD_ROOT

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "ark_io.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the build of ark_io.cc goes (keyed by source and flags)."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, digest, "libkaldi_tpu_torch_ark.so")


def _build(so: str):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native ark reader is built "
                           "from kaldi_tpu_torch/native at first use")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC}:\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """-> the loaded library; builds it first if needed. Raises when it
    cannot be built or loaded (and tries again on the next call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.ark_open.restype = ctypes.c_void_p
        lib.ark_open.argtypes = [ctypes.c_char_p]
        lib.ark_next.restype = ctypes.c_int
        lib.ark_next.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ark_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.ark_close.argtypes = [ctypes.c_void_p]
        lib.ark_create.restype = ctypes.c_void_p
        lib.ark_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.ark_write.restype = ctypes.c_int
        lib.ark_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
        lib.ark_close_writer.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads (a failure is not latched)."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def read_ark_native(path: str):
    """Yield (key, float32 array) from a binary FM/DM/FV/DV ark.
    Raises ValueError on entries the native reader can't parse (CM/text) —
    callers fall back to the Python reader."""
    lib = load()
    h = lib.ark_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    key = ctypes.create_string_buffer(1024)
    data = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_int()
    cols = ctypes.c_int()
    try:
        while True:
            rc = lib.ark_next(h, key, 1024, ctypes.byref(data),
                              ctypes.byref(rows), ctypes.byref(cols))
            if rc == 0:
                return
            if rc < 0:
                raise ValueError(f"native ark parse failure in {path} "
                                 f"(unsupported entry type?)")
            r, c = rows.value, cols.value
            n = (r if r > 0 else 1) * c
            arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
            lib.ark_free(data)
            yield key.value.decode(), (arr.reshape(r, c) if r > 0 else arr)
    finally:
        lib.ark_close(h)


class ArkWriterNative:
    def __init__(self, path: str, scp_path: str | None = None):
        lib = load()
        self._lib = lib
        self._h = lib.ark_create(path.encode(),
                                 (scp_path or "").encode())
        if not self._h:
            raise OSError(f"cannot create {path}")

    def write(self, key: str, value: np.ndarray):
        arr = np.ascontiguousarray(value, dtype=np.float32)
        rows, cols = (0, arr.shape[0]) if arr.ndim == 1 else arr.shape
        rc = self._lib.ark_write(
            self._h, key.encode(),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols)
        if rc != 0:
            raise OSError("native ark write failed")

    def close(self):
        if self._h:
            self._lib.ark_close_writer(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
