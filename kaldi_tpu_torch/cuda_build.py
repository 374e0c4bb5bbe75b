"""Build and load the port's hand-written CUDA kernels.

Every `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into its
own shared library with a plain C interface, and loaded with ctypes (no
PyTorch headers, so a build takes seconds). Builds happen at first use,
never at import, into `build/kaldi_tpu_torch/<hash>/lib<name>.so`, where
the hash covers the source and the flags; a finished build is reused.
`build()` starts one nvcc per source at once and waits for all of them.
nvcc's report (`-Xptxas -v`: registers, shared memory, spills) is kept
beside each library as `nvcc.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kaldi_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def sources() -> list[str]:
    """Names of the port's kernels: one per csrc/*.cu."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built from "
                           "kaldi_tpu_torch/csrc at first use")
    return path


def library_path(name: str) -> str:
    """Where the build of csrc/<name>.cu goes (keyed by source and flags)."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, digest, f"lib{name}.so")


def build(names=None) -> dict[str, str]:
    """Compile csrc/<name>.cu for each name (default: all sources) that has
    no build yet, one nvcc process per source, all started together.
    -> {name: shared library path}. Raises with nvcc's output on failure."""
    names = sources() if names is None else list(names)
    out = {n: library_path(n) for n in names}
    jobs = []
    try:
        for n, so in out.items():
            if os.path.exists(so):
                continue
            os.makedirs(os.path.dirname(so), exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
            os.close(fd)
            src = os.path.join(CSRC, n + ".cu")
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((n, src, so, tmp, proc))
        failed = []
        for n, src, so, tmp, proc in jobs:
            log, _ = proc.communicate()
            with open(os.path.join(os.path.dirname(so), "nvcc.log"), "w") as f:
                f.write(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for *_, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def load(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of csrc/<name>.cu (built if needed), with
    its argument types set and an int (cudaError_t) result."""
    with _lock:
        fn = _fns.get((name, symbol))
        if fn is None:
            lib = ctypes.CDLL(build([name])[name])
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[(name, symbol)] = fn
    return fn
