"""Batched small-table gather: out[b, j] = tab[b, idx[b, j]].

Counterpart of kaldi_tpu/ops/table_gather.py. The decoder's acoustic
lookup (pdf -> scaled log-likelihood) and its frontier-score lookup are
element-wise random gathers from a small per-utterance table ([B, P],
P a few thousand). On the TPU the Pallas kernel `_pallas_gather` kept the
table in VMEM; here `csrc/table_gather.cu` does the lookup in one memory
round trip after the index load.

On this card the kernel is bound by bytes, and at the decoder's sizes by
the launch and the dependent memory round trips. Each thread loads its 4
indices first, as one int4, and stores 4 outputs as one float4; blocks
are small enough to put over 132 blocks on the card at both decoder
shapes. A block stages its row in shared memory only when the row has no
more 32-byte sectors than the block has lookups (P <= 4096); wider rows,
such as the [8, 7000] frontier table, are read directly through the
read-only path. See the source for details. The TPU-only parts of the
Pallas kernel (1024-index alignment, the [RB, 128] reshape, the 128-lane
chunk loop) have no counterpart.

An index outside [0, P) yields 0.0, as in the Pallas kernel.

`batched_table_gather` takes the plain version (`batched_table_gather_ref`)
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from kaldi_tpu_torch import cuda_build

launches = 0          # kernel launches since the last reset
_launches_lock = threading.Lock()   # the server's connection threads
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
    fn = cuda_build.load("table_gather", "kaldi_table_gather_f32", _ARGTYPES)
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), B, P, N,
                stream)
    if rc != 0:
        raise RuntimeError(f"table-gather kernel launch failed: cudaError {rc}")
    with _launches_lock:
        launches += 1
    return out


def batched_table_gather(tab: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """tab [B, P] float32, idx [B, N] int32 -> [B, N]. CPU tensors take the
    plain version; CUDA tensors take the kernel."""
    if tab.device.type == "cpu" and idx.device.type == "cpu":
        return batched_table_gather_ref(tab, idx)
    return gather_cuda(tab, idx)
