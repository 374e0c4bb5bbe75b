"""Host-side helpers around the decoders: the frame-validity mask, the
single device->host copy of a decode's outputs, and the label parse.

`parse_label_seqs` is kaldi_tpu/decoder/dense.py `_parse_label_seqs`;
`device_mask` is `_device_mask` (without its cache: building a [B, T]
mask is one small host->device copy); `fetch_int32` replaces
kaldi_tpu/decoder/hostpack.py `pack4`/`fetch_tree_async`: the outputs are
packed into one int32 buffer on the device and copied once.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = np.float32(1e10)


def device_mask(num_frames: np.ndarray, T: int, device) -> torch.Tensor:
    """[B, T] bool frame-validity mask on `device`."""
    m = np.arange(T)[None, :] < np.asarray(num_frames)[:, None]
    return torch.as_tensor(m, device=device)


def fetch_int32(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Copy a list of int32 / f32 / bool device tensors to the host with ONE
    transfer. -> numpy arrays with the original shapes and dtypes."""
    parts = []
    for x in tensors:
        flat = x.reshape(-1)
        if flat.dtype == torch.float32:
            flat = flat.view(torch.int32)
        else:
            flat = flat.to(torch.int32)
        parts.append(flat)
    buf = torch.cat(parts).cpu().numpy()
    out = []
    pos = 0
    for x in tensors:
        n = x.numel()
        chunk = buf[pos: pos + n]
        pos += n
        if x.dtype == torch.float32:
            chunk = chunk.view(np.float32)
        elif x.dtype == torch.bool:
            chunk = chunk.astype(bool)
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
