"""Host-side helpers around the decoders: the frame-validity mask, the
single device->host copy of a decode's outputs, and the label parse.

`parse_label_seqs` is kaldi_tpu/decoder/dense.py `_parse_label_seqs`;
`device_mask` is `_device_mask` (without its cache: building a [B, T]
mask is one small host->device copy); `fetch_host` replaces
kaldi_tpu/decoder/hostpack.py `pack4`/`fetch_tree_async`: the outputs are
packed into one byte buffer on the device and copied once.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = np.float32(1e10)

_NP_DTYPE = {torch.float32: np.float32, torch.float16: np.float16,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.uint8: np.uint8, torch.bool: np.bool_}


def device_mask(num_frames: np.ndarray, T: int, device) -> torch.Tensor:
    """[B, T] bool frame-validity mask on `device`."""
    m = np.arange(T)[None, :] < np.asarray(num_frames)[:, None]
    return torch.as_tensor(m, device=device)


def fetch_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Copy a list of device tensors (f32, f16, int32, int64, uint8, bool;
    any shapes, mixed) to the host with ONE transfer: each is viewed as
    bytes, padded to a multiple of 8, and the parts are concatenated on
    the device. -> numpy arrays with the original shapes and dtypes."""
    parts, spans = [], []
    pos = 0
    for x in tensors:
        flat = x.reshape(-1)
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        raw = flat.contiguous().view(torch.uint8)
        n = raw.numel()
        pad = -n % 8
        parts.append(raw)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=x.device))
        spans.append((pos, n))
        pos += n + pad
    buf = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.uint8)
    out = []
    for x, (p, n) in zip(tensors, spans):
        chunk = buf[p: p + n].view(_NP_DTYPE[x.dtype])
        out.append(chunk.reshape(tuple(x.shape)))
    return out


def parse_label_seqs(ols, ils, init_ols, cost, num_frames):
    """Strip label-0 padding -> per-utterance (words, tids, total_cost) or
    None (ref: kaldi_tpu/decoder/dense.py `_parse_label_seqs`)."""
    out = []
    for b in range(len(num_frames)):
        Tb = int(num_frames[b])
        if cost[b] >= BIG * 0.5:
            out.append(None)
            continue
        flat_o = np.concatenate([init_ols[b].ravel(),
                                 ols[b, :Tb].ravel()])
        words = flat_o[flat_o != 0].tolist()
        flat_i = ils[b, :Tb].ravel()
        tids = flat_i[flat_i != 0].tolist()
        out.append((words, tids, float(cost[b])))
    return out
