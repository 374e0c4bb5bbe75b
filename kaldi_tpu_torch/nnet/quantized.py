"""Int8 weight-only serving of the TDNN.

Counterpart of kaldi_tpu/nnet/quantized.py. Affine weights are quantized
to int8 with one symmetric scale per output channel (`quantize_weights`,
`quantize_tdnn`: numpy, code for code equal to the JAX package's, since
both round half to even with `np.round`). `QuantizedTdnn` is
`tdnn_apply_quantized` as an nn.Module: every layer's affine is `qaffine`.

`qaffine` launches the hand-written Hopper kernel `csrc/qaffine.cu`
(which replaces the Pallas kernel `qaffine_pallas`) for CUDA tensors, or
raises; it takes the plain version `qaffine_ref` only for CPU tensors.
`launches` counts kernel launches. The kernel sums over K in f32 first
and applies the scale and bias to the accumulator, as the Pallas kernel
does; `qaffine_ref` computes in the same order.

The kernel runs on the bf16 tensor cores without rounding its inputs:
an int8 code is exact in bf16, x splits exactly into three bf16 planes
(`split_bf16x3`), and each bf16 product is exact, so three products
against the same weight tile carry every bit of x. They are summed by
the tensor cores' f32 accumulation, which truncates and so adds more
error than a plain f32 matmul as K grows (chip_smoke.py phase 4 prints
both against f64); it stays inside the port's 1e-5 x max|y| tolerance.
The weights stay int8 in device memory; the kernel widens each tile in
shared memory.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
from torch import nn

from kaldi_tpu_torch import cuda_build
from kaldi_tpu_torch.nnet.components import (ACTIVATIONS, normalize, pnorm,
                                             splice, splice_valid)

launches = 0          # kernel launches since the last reset
_launches_lock = threading.Lock()   # the server's connection threads
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def quantize_weights(w: np.ndarray):
    """w [out, in] float -> (w_int8 [out, in], scale [out] f32):
    per-output-channel symmetric scaling."""
    w = np.asarray(w, np.float32)
    amax = np.abs(w).max(axis=1)
    scale = np.maximum(amax, 1e-10) / 127.0
    q = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_tdnn(params) -> dict:
    """Quantize every affine weight matrix of a Tdnn params pytree (JAX
    layout, w [in, out]; numpy leaves). -> a parallel pytree of
    {"wq" [out, in] int8, "scale" [out] f32, "b" [out]} dicts."""
    def q(layer):
        wq, sc = quantize_weights(np.asarray(layer["w"]).T)
        return {"wq": wq, "scale": sc, "b": np.asarray(layer["b"])}
    return {"layers": [q(l) for l in params["layers"]],
            "final": q(params["final"])}


def split_bf16x3(x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's split of x: f32 -> (hi, mid, lo), three bf16 tensors
    with hi + mid + lo == x exactly (for finite x within bf16's range).
    hi = bf16_rn(x), mid = bf16_rn(x - hi), lo = bf16_rn(x - hi - mid);
    each residual is exact in f32, and after two roundings to 8
    significant bits at most 8 of x's 24 remain, so lo is exact too."""
    if x.dtype != torch.float32:
        raise ValueError(f"split_bf16x3 takes f32, got {x.dtype}")
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def _check(x, wq, scale, bias):
    if (x.dtype != torch.float32 or wq.dtype != torch.int8
            or scale.dtype != torch.float32 or bias.dtype != torch.float32):
        raise ValueError(f"qaffine takes f32 x, int8 wq, f32 scale and bias, "
                         f"got {x.dtype}, {wq.dtype}, {scale.dtype}, "
                         f"{bias.dtype}")
    if (x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[1]
            or tuple(scale.shape) != (wq.shape[0],)
            or tuple(bias.shape) != (wq.shape[0],)):
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)}: need x [M, K], wq [N, K], "
                         f"scale and bias [N]")


def qaffine_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [M, K] f32, wq [N, K] int8, scale/bias [N]
    f32 -> [M, N] = (x @ f32(wq)^T) * scale + bias, in the kernel's order."""
    _check(x, wq, scale, bias)
    return torch.matmul(x, wq.to(torch.float32).T) * scale + bias


def qaffine_cuda(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream. Raises on anything it does
    not take: non-CUDA tensors, other dtypes or shapes, non-contiguous
    inputs."""
    global launches
    _check(x, wq, scale, bias)
    ts = (x, wq, scale, bias)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("qaffine kernel needs contiguous tensors")
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"qaffine kernel needs all tensors on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    M, K = x.shape
    N = wq.shape[0]
    if -(-M // 128) > 65535:
        raise ValueError(f"M={M} too large for the kernel's grid")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return y
    fn = cuda_build.load("qaffine", "kaldi_qaffine_f32", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), M, N, K, stream)
    if rc != 0:
        raise RuntimeError(f"qaffine kernel launch failed: cudaError {rc}")
    with _launches_lock:
        launches += 1
    return y


def qaffine(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """Quantized affine y = x wq^T diag(scale) + b over x [..., K]
    -> [..., N]. CPU tensors take the plain version; CUDA tensors take the
    kernel."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if all(t.device.type == "cpu" for t in (x, wq, scale, bias)):
        y = qaffine_ref(x2, wq, scale, bias)
    else:
        y = qaffine_cuda(x2, wq, scale, bias)
    return y.reshape(*lead, -1)


class QAffine(nn.Module):
    """Buffers wq [out, in] int8, scale [out] f32, b [out] f32."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.register_buffer("wq", torch.zeros(out_dim, in_dim,
                                                dtype=torch.int8,
                                                device=device))
        self.register_buffer("scale", torch.zeros(out_dim, device=device))
        self.register_buffer("b", torch.zeros(out_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qaffine(x, self.wq, self.scale, self.b)


class QuantizedTdnn(nn.Module):
    """forward(feats [..., T, D]) -> log posteriors [..., T(out), num_pdfs],
    the counterpart of `tdnn_apply_quantized`. Activations stay f32."""

    def __init__(self, config, device=None):
        super().__init__()
        self.config = config
        in_dim = config.feat_dim
        layers = []
        for ctx in config.splice_indexes:
            layers.append(QAffine(in_dim * len(ctx), config.hidden_dim,
                                  device))
            in_dim = (config.pnorm_output_dim if config.nonlinearity == "pnorm"
                      else config.hidden_dim)
        self.layers = nn.ModuleList(layers)
        self.final = QAffine(in_dim, config.num_pdfs, device)

    def load_jax_qparams(self, qtree) -> "QuantizedTdnn":
        """Copy a `quantize_tdnn` pytree (numpy leaves) in place."""
        from kaldi_tpu_torch.params import tdnn_qparams_from_jax
        self.load_state_dict(tdnn_qparams_from_jax(qtree))
        return self

    def forward(self, feats: torch.Tensor, pad_context: bool = True,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """pad_context=True clamps at utterance edges (output T == input T);
        False uses valid frames only. There is no reduced-precision path:
        compute_dtype must be None."""
        if compute_dtype is not None:
            raise ValueError(f"QuantizedTdnn computes in f32; compute_dtype "
                             f"must be None, got {compute_dtype}")
        cfg = self.config
        sp = splice if pad_context else splice_valid
        x = feats
        for ctx, layer in zip(cfg.splice_indexes, self.layers):
            x = layer(sp(x, ctx))
            if cfg.nonlinearity == "pnorm":
                x = pnorm(x, cfg.pnorm_output_dim)
            else:
                x = ACTIVATIONS["relu"](x)
            x = normalize(x)
        return torch.log_softmax(self.final(x), dim=-1)
