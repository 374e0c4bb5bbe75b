"""ctypes binding of the native raw-lattice extractor
(kaldi_tpu_torch/native/lattice_gen.cc), ported from
kaldi_tpu/lat/native_gen.py.

(ref: decoder/lattice-faster-decoder.cc:109 GetRawLattice is C++ in the
reference; this is the matching native component. The numpy extraction
in lat/generate.py is the semantic reference.)

The source is compiled with g++ at first use, never at import, into
`build/kaldi_tpu_torch/<hash>/libkaldi_tpu_torch_latgen.so`, where the
hash covers the source and the flags; a finished build is reused. A
library that cannot be built or loaded raises: nothing falls back to the
numpy extraction behind the caller's back. ctypes releases the GIL for
the call, so extractions on a thread pool run in parallel.
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
    __file__))), "native", "lattice_gen.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
extractions = 0       # native extractions since the last reset

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def library_path() -> str:
    """Where the build of lattice_gen.cc goes (keyed by source and flags)."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, digest, "libkaldi_tpu_torch_latgen.so")


def _build(so: str):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native lattice extractor is "
                           "built from kaldi_tpu_torch/native at first use")
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
        lib.latgen_extract.restype = ctypes.c_void_p
        lib.latgen_extract.argtypes = (
            [_i32p, _i32p, _i32p, _f32p, _i32p, _i32p,      # emitting CSR
             _i32p, _i32p, _f32p, _i32p,                    # eps CSR
             _f32p, ctypes.c_int32, ctypes.c_int32,         # final, S, start
             _i32p, _f32p, _i32p, _f32p,                    # records
             ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
             ctypes.c_int32,                                # R0, R, Tb, K
             _f32p, ctypes.c_int32, ctypes.c_float])        # ll, P, beam
        lib.latgen_num_arcs.restype = ctypes.c_int64
        lib.latgen_num_arcs.argtypes = [ctypes.c_void_p]
        lib.latgen_num_nodes.restype = ctypes.c_int32
        lib.latgen_num_nodes.argtypes = [ctypes.c_void_p]
        lib.latgen_num_finals.restype = ctypes.c_int64
        lib.latgen_num_finals.argtypes = [ctypes.c_void_p]
        lib.latgen_copy.restype = None
        lib.latgen_copy.argtypes = [
            ctypes.c_void_p, _i32p, _i32p, _i32p, _f32p, _f32p, _i32p,
            _i32p, _f32p]
        lib.latgen_free.restype = None
        lib.latgen_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _p(arr, ctype):
    return arr.ctypes.data_as(ctype)


def _pad_dead(states, scores, K: int):
    """Widen snapshots [..., k] to [..., K] with dead slots (score 1e10)."""
    pad = [(0, 0)] * (states.ndim - 1) + [(0, K - states.shape[-1])]
    return (np.ascontiguousarray(np.pad(states, pad)),
            np.ascontiguousarray(np.pad(scores, pad, constant_values=1e10)))


def extract_native(csr, raw: dict, b: int, Tb: int, lattice_beam: float):
    """-> (n_nodes, src, il, ol, gc, ac, dst, final_nodes, final_costs) of
    utterance b, beam-pruned, connected and renumbered."""
    global extractions
    lib = _load()
    c = csr
    e = {name: np.ascontiguousarray(getattr(c, name))
         for name in ("estart", "e_tid", "e_ol", "e_cost", "e_nxt",
                      "e_pdf", "zstart", "z_ol", "z_cost", "z_nxt",
                      "final")}
    init_st = np.ascontiguousarray(raw["init_states"][b], np.int32)
    init_sc = np.ascontiguousarray(raw["init_scores"][b], np.float32)
    st = np.ascontiguousarray(raw["states"][b], np.int32)     # [T, R, K]
    sc = np.ascontiguousarray(raw["scores"][b], np.float32)
    ll = np.ascontiguousarray(raw["ll_scaled"][b], np.float32)
    R0, K0 = init_st.shape
    T, R, K = st.shape
    if R0 and K0 != K:
        # flat records are as wide as their widest frame, the init
        # snapshots rec_cap wide: pad both to one width with dead slots
        K = max(K0, K)
        init_st, init_sc = _pad_dead(init_st, init_sc, K)
        st, sc = _pad_dead(st, sc, K)
    if Tb > T or ll.shape[0] < Tb:
        raise ValueError(f"{Tb} frames asked of {T} recorded")
    P = ll.shape[1]
    h = lib.latgen_extract(
        _p(e["estart"], _i32p), _p(e["e_tid"], _i32p),
        _p(e["e_ol"], _i32p), _p(e["e_cost"], _f32p),
        _p(e["e_nxt"], _i32p), _p(e["e_pdf"], _i32p),
        _p(e["zstart"], _i32p), _p(e["z_ol"], _i32p),
        _p(e["z_cost"], _f32p), _p(e["z_nxt"], _i32p),
        _p(e["final"], _f32p), np.int32(c.num_states),
        np.int32(c.start),
        _p(init_st, _i32p), _p(init_sc, _f32p),
        _p(st, _i32p), _p(sc, _f32p),
        np.int32(R0), np.int32(R), np.int32(Tb), np.int32(K),
        _p(ll, _f32p), np.int32(P), np.float32(lattice_beam))
    try:
        n_arcs = int(lib.latgen_num_arcs(h))
        n_nodes = int(lib.latgen_num_nodes(h))
        n_fin = int(lib.latgen_num_finals(h))
        src = np.empty(n_arcs, np.int32)
        il = np.empty(n_arcs, np.int32)
        ol = np.empty(n_arcs, np.int32)
        gc = np.empty(n_arcs, np.float32)
        ac = np.empty(n_arcs, np.float32)
        dst = np.empty(n_arcs, np.int32)
        fn = np.empty(n_fin, np.int32)
        fc = np.empty(n_fin, np.float32)
        lib.latgen_copy(h, _p(src, _i32p), _p(il, _i32p), _p(ol, _i32p),
                        _p(gc, _f32p), _p(ac, _f32p), _p(dst, _i32p),
                        _p(fn, _i32p), _p(fc, _f32p))
    finally:
        lib.latgen_free(h)
    with _lock:
        extractions += 1
    return n_nodes, src, il, ol, gc, ac, dst, fn, fc
