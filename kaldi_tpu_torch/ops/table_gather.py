"""Batched small-table gather: out[b, j] = tab[b, idx[b, j]].

Counterpart of kaldi_tpu/ops/table_gather.py. The decoder's acoustic
lookup (pdf -> scaled log-likelihood) and its frontier-score lookup are
element-wise random gathers from a small per-utterance table ([B, P],
P a few thousand). On the TPU the Pallas kernel `_pallas_gather` kept the
table in VMEM; here `csrc/table_gather.cu` keeps the row in shared memory.

On this card the kernel is bound by bytes: the index reads and output
writes (8 bytes per element) plus the staging of the row, which every
block serving the same utterance re-reads (from L2 after the first). The
design stages the row once per block with 16-byte loads, so the random
reads stay inside the SM; see the source for details. Tables wider than
16384 f32 entries read from global memory in a second path of the same
kernel. The TPU-only parts of the Pallas kernel (1024-index alignment,
the [RB, 128] reshape, the 128-lane chunk loop) have no counterpart.

An index outside [0, P) yields 0.0, as in the Pallas kernel.

`batched_table_gather` takes the plain version (`batched_table_gather_ref`)
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "table_gather.cu")
_BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kaldi_tpu_torch")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")

launches = 0          # kernel launches since the last reset
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the table-gather kernel is built "
                           "from csrc/table_gather.cu at first use")
    return path


def build() -> str:
    """Compile csrc/table_gather.cu unless a build of this source exists
    (builds are keyed by a hash of the source and flags).
    -> the shared library's path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    so = os.path.join(_BUILD_ROOT, digest, "libtable_gather.so")
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, so)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.kaldi_table_gather_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def batched_table_gather_ref(tab: torch.Tensor, idx: torch.Tensor
                             ) -> torch.Tensor:
    """Plain PyTorch version: tab [B, P] f32, idx [B, N] int -> [B, N];
    out-of-range indices give 0.0."""
    P = tab.shape[1]
    ok = (idx >= 0) & (idx < P)
    g = torch.gather(tab, 1, torch.where(ok, idx, 0).long())
    return torch.where(ok, g, torch.zeros((), dtype=tab.dtype,
                                          device=tab.device))


def gather_cuda(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream. Raises on anything it does
    not take: non-CUDA tensors, dtypes other than f32 / int32, shapes that
    disagree, non-contiguous inputs."""
    global launches
    if tab.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"table-gather kernel takes f32 tab and int32 idx, "
                         f"got {tab.dtype} and {idx.dtype}")
    if tab.dim() != 2 or idx.dim() != 2 or tab.shape[0] != idx.shape[0]:
        raise ValueError(f"shapes {tuple(tab.shape)} / {tuple(idx.shape)}: "
                         f"need tab [B, P] and idx [B, N]")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table-gather kernel needs contiguous tensors")
    if tab.device.type != "cuda" or idx.device != tab.device:
        raise ValueError(f"table-gather kernel needs both tensors on one CUDA "
                         f"device, got {tab.device} and {idx.device}")
    B, P = tab.shape
    N = idx.shape[1]
    if max(B * P, B * N) >= 2**31 or B > 65535:
        raise ValueError(f"shape too large for the kernel: B={B} P={P} N={N}")
    out = torch.empty((B, N), dtype=torch.float32, device=tab.device)
    if B == 0 or N == 0:
        return out
    lib = _load()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kaldi_table_gather_f32(tab.data_ptr(), idx.data_ptr(),
                                        out.data_ptr(), B, P, N, stream)
    if rc != 0:
        raise RuntimeError(f"table-gather kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def batched_table_gather(tab: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """tab [B, P] float32, idx [B, N] int32 -> [B, N]. CPU tensors take the
    plain version; CUDA tensors take the kernel."""
    if tab.device.type == "cpu" and idx.device.type == "cpu":
        return batched_table_gather_ref(tab, idx)
    return gather_cuda(tab, idx)
