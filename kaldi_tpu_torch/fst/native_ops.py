"""ctypes bindings for the native graph ops
(kaldi_tpu_torch/native/fst_ops.cc), ported from kaldi_tpu/fst/native_ops.py.

compose / determinize_star / connect / minimize_encoded / context
composition over FlatFst arrays — the production-scale path of the
mkgraph pipeline. The Python implementations (fst/compose.py,
fst/determinize.py, fst/context.py) are the semantic reference.

(ref: fstext/table-matcher.h:329 TableCompose,
 fstext/determinize-star.h:86 DeterminizeStar — C++ in the reference
 too; this is the matching native runtime component.)

The source is compiled with g++ at first use, never at import, into
`build/kaldi_tpu_torch/<hash>/libkaldi_tpu_torch_fst_ops.so`, where the
hash covers the source and the flags; a finished build is reused. A
library that cannot be built or loaded raises: nothing falls back to the
Python pipeline behind the caller's back.
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
from kaldi_tpu_torch.fst.flat import FlatFst

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "fst_ops.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)

_FST_ARGS = [_i64p, _i32p, _i32p, _f32p, _i32p, _f32p,
             ctypes.c_int32, ctypes.c_int32]


def library_path() -> str:
    """Where the build of fst_ops.cc goes (keyed by source and flags)."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, digest, "libkaldi_tpu_torch_fst_ops.so")


def _build(so: str):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native graph ops are built "
                           "from kaldi_tpu_torch/native at first use")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC}:\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.fst_compose.restype = ctypes.c_void_p
        lib.fst_compose.argtypes = _FST_ARGS + _FST_ARGS + [ctypes.c_int32]
        lib.fst_determinize_star.restype = ctypes.c_void_p
        lib.fst_determinize_star.argtypes = _FST_ARGS + [
            ctypes.c_int32, ctypes.c_int64]
        lib.fst_connect.restype = ctypes.c_void_p
        lib.fst_connect.argtypes = _FST_ARGS
        lib.fst_minimize_encoded.restype = ctypes.c_void_p
        lib.fst_minimize_encoded.argtypes = _FST_ARGS
        lib.fst_out_num_states.restype = ctypes.c_int32
        lib.fst_out_num_states.argtypes = [ctypes.c_void_p]
        lib.fst_out_num_arcs.restype = ctypes.c_int64
        lib.fst_out_num_arcs.argtypes = [ctypes.c_void_p]
        lib.fst_out_start.restype = ctypes.c_int32
        lib.fst_out_start.argtypes = [ctypes.c_void_p]
        lib.fst_out_error_len.restype = ctypes.c_int32
        lib.fst_out_error_len.argtypes = [ctypes.c_void_p]
        lib.fst_out_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.fst_out_copy.argtypes = [ctypes.c_void_p, _i64p, _i32p, _i32p,
                                     _f32p, _i32p, _f32p]
        lib.fst_out_free.argtypes = [ctypes.c_void_p]
        lib.fst_compose_context.restype = ctypes.c_void_p
        lib.fst_compose_context.argtypes = _FST_ARGS + [
            _i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.fst_ctx_fst.restype = ctypes.c_void_p
        lib.fst_ctx_fst.argtypes = [ctypes.c_void_p]
        lib.fst_ctx_num_ilabels.restype = ctypes.c_int32
        lib.fst_ctx_num_ilabels.argtypes = [ctypes.c_void_p]
        lib.fst_ctx_ilabels_flat_len.restype = ctypes.c_int64
        lib.fst_ctx_ilabels_flat_len.argtypes = [ctypes.c_void_p]
        lib.fst_ctx_copy_ilabels.argtypes = [ctypes.c_void_p, _i64p, _i32p]
        lib.fst_ctx_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here (g++ present)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _p(arr, ctype):
    return arr.ctypes.data_as(ctype)


def _fst_args(f: FlatFst):
    arc_start = np.ascontiguousarray(f.arc_start, np.int64)
    il = np.ascontiguousarray(f.il, np.int32)
    ol = np.ascontiguousarray(f.ol, np.int32)
    w = np.ascontiguousarray(f.w, np.float32)
    dst = np.ascontiguousarray(f.dst, np.int32)
    final = np.ascontiguousarray(f.final, np.float32)
    # keep references alive through the call
    keep = (arc_start, il, ol, w, dst, final)
    return [_p(arc_start, _i64p), _p(il, _i32p), _p(ol, _i32p),
            _p(w, _f32p), _p(dst, _i32p), _p(final, _f32p),
            np.int32(f.num_states), np.int32(f.start)], keep


def _collect(lib, h) -> FlatFst:
    try:
        elen = int(lib.fst_out_error_len(h))
        if elen:
            buf = ctypes.create_string_buffer(elen)
            lib.fst_out_error(h, buf)
            raise RuntimeError(buf.raw.decode())
        S = int(lib.fst_out_num_states(h))
        A = int(lib.fst_out_num_arcs(h))
        arc_start = np.empty(S + 1, np.int64)
        il = np.empty(A, np.int32)
        ol = np.empty(A, np.int32)
        w = np.empty(A, np.float32)
        dst = np.empty(A, np.int32)
        final = np.empty(S, np.float32)
        if S:
            lib.fst_out_copy(h, _p(arc_start, _i64p), _p(il, _i32p),
                             _p(ol, _i32p), _p(w, _f32p), _p(dst, _i32p),
                             _p(final, _f32p))
        else:
            arc_start[:] = 0
        start = int(lib.fst_out_start(h))
    finally:
        lib.fst_out_free(h)
    return FlatFst(arc_start, il, ol, w, dst, final, start)


def compose_flat(a: FlatFst, b: FlatFst, connect: bool = True) -> FlatFst:
    lib = _load()
    aa, keep_a = _fst_args(a)
    bb, keep_b = _fst_args(b)
    h = lib.fst_compose(*aa, *bb, np.int32(1 if connect else 0))
    return _collect(lib, h)


def determinize_star_flat(f: FlatFst, use_log: bool = False,
                          max_states: int = 100_000_000) -> FlatFst:
    lib = _load()
    ff, keep = _fst_args(f)
    h = lib.fst_determinize_star(*ff, np.int32(1 if use_log else 0),
                                 np.int64(max_states))
    return _collect(lib, h)


def connect_flat(f: FlatFst) -> FlatFst:
    lib = _load()
    ff, keep = _fst_args(f)
    h = lib.fst_connect(*ff)
    return _collect(lib, h)


def minimize_encoded_flat(f: FlatFst) -> FlatFst:
    """Weighted minimization over encoded labels (ref:
    fstbin/fstminimizeencoded.cc; semantics of fst/minimize.py)."""
    lib = _load()
    ff, keep = _fst_args(f)
    h = lib.fst_minimize_encoded(*ff)
    return _collect(lib, h)


def compose_context_flat(f: FlatFst, disambig_in, N: int = 3, P: int = 1):
    """Native triphone context expansion: -> (clg FlatFst, ilabel_info)
    (ref: fstext/context-fst.h:491 ComposeContext; semantics of
    fst/context.py:compose_context)."""
    lib = _load()
    dis = np.asarray(sorted(int(d) for d in disambig_in), np.int32)
    ff, keep = _fst_args(f)
    h = lib.fst_compose_context(*ff, _p(dis, _i32p), np.int32(len(dis)),
                                np.int32(N), np.int32(P))
    try:
        fh = lib.fst_ctx_fst(h)
        elen = int(lib.fst_out_error_len(fh))
        if elen:
            buf = ctypes.create_string_buffer(elen)
            lib.fst_out_error(fh, buf)
            raise RuntimeError(buf.raw.decode())
        S = int(lib.fst_out_num_states(fh))
        A = int(lib.fst_out_num_arcs(fh))
        arc_start = np.empty(S + 1, np.int64)
        il = np.empty(A, np.int32)
        ol = np.empty(A, np.int32)
        w = np.empty(A, np.float32)
        dst = np.empty(A, np.int32)
        final = np.empty(S, np.float32)
        if S:
            lib.fst_out_copy(fh, _p(arc_start, _i64p), _p(il, _i32p),
                             _p(ol, _i32p), _p(w, _f32p), _p(dst, _i32p),
                             _p(final, _f32p))
        else:
            arc_start[:] = 0
        start = int(lib.fst_out_start(fh))
        n_il = int(lib.fst_ctx_num_ilabels(h))
        flat_len = int(lib.fst_ctx_ilabels_flat_len(h))
        off = np.empty(max(n_il - 1, 0) + 1, np.int64)
        flat = np.empty(max(flat_len, 1), np.int32)
        if n_il > 1:
            lib.fst_ctx_copy_ilabels(h, _p(off, _i64p), _p(flat, _i32p))
        ilabel_info = [[]]
        for k in range(1, n_il):
            ilabel_info.append(flat[off[k - 1]: off[k]].tolist())
    finally:
        lib.fst_ctx_free(h)
    clg = FlatFst(arc_start, il, ol, w, dst, final, start)
    return clg, ilabel_info
