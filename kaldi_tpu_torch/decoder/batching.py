"""Length-bucketed batch decoding for production serving.

(ref role: gmm-latgen-faster-parallel's TaskSequencer feeds utterances of
 wildly different lengths through one thread pool; the TPU equivalent
 batches utterances into padded tensors — bucketing by length bounds the
 padding waste AND keeps the set of jit shapes small, so each bucket shape
 compiles once. SURVEY.md §5 long-context row: pad/bucket frames per
 utterance into [B, T, D].)

Counterpart of kaldi_tpu/decoder/batching.py: the same buckets and batches
(`bucket_boundaries` copied as it is). Each padded batch goes to `device`
in one copy; the scoring function and the decoder are the caller's
(`CsrBeamDecoder` on the card, whose emitting rounds launch the gather
kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.utils.profiling import span


def bucket_boundaries(lengths, max_buckets: int = 6,
                      growth: float = 1.4, min_len: int = 64):
    """Geometric length buckets covering the data."""
    lo = max(min_len, int(min(lengths)))
    hi = int(max(lengths))
    bounds = [lo]
    while bounds[-1] < hi and len(bounds) < max_buckets:
        bounds.append(int(np.ceil(bounds[-1] * growth)))
    bounds[-1] = max(bounds[-1], hi)
    return bounds


def decode_batched(decoder, utts, score_fn, batch_size: int = 16,
                   max_buckets: int = 6, device="cuda"):
    """Decode a keyed dataset with length bucketing.

    utts: [(key, feats [T, D])]; score_fn(batch_feats [B, T, D] f32 tensor
    on `device`) -> loglikes [B, T, P] (the acoustic model, the caller's).
    -> {key: (words, tids, cost) or None}.

    Utterances are grouped into geometric length buckets; each bucket is
    decoded in fixed-size batches padded to the bucket's boundary, so the
    whole dataset touches at most max_buckets × 1 compiled shapes.

    The call is one span, `batching.decode_batched` (counts `utts` and
    `batches`): the request that the decoder's spans under it belong to.
    """
    dev = resolve_device(device)
    out: dict = {}
    if not utts:
        return out
    D = utts[0][1].shape[1]
    with span("batching.decode_batched", utts=len(utts)) as sp:
        batches = bucket_batches(utts, batch_size, max_buckets)
        sp.counts["batches"] = len(batches)
        for bound, chunk in batches:
            B = len(chunk)
            # pad the batch itself to batch_size to keep ONE shape/bucket
            feats = np.zeros((batch_size, bound, D), np.float32)
            nf = np.zeros(batch_size, np.int32)
            for b, (_k, f) in enumerate(chunk):
                feats[b, : f.shape[0]] = f
                nf[b] = f.shape[0]
            if B < batch_size:
                nf[B:] = 1   # dummy rows decode 1 frame, discarded
            ll = score_fn(torch.from_numpy(feats).to(dev))
            res = decoder.decode(ll, nf)
            for b, (k, _f) in enumerate(chunk):
                out[k] = res[b]
    return out


def bucket_batches(utts, batch_size: int, max_buckets: int = 6) -> list:
    """decode_batched's batches, in its order: [(bucket bound, [(key,
    feats), ...] of at most batch_size)]; each utterance in the first
    bucket whose bound it does not exceed."""
    bounds = bucket_boundaries([f.shape[0] for (_k, f) in utts],
                               max_buckets=max_buckets)
    out = []
    for bi, bound in enumerate(bounds):
        lo = 0 if bi == 0 else bounds[bi - 1]
        members = [(k, f) for (k, f) in utts
                   if (lo < f.shape[0] <= bound) or
                      (bi == 0 and f.shape[0] <= bound)]
        out += [(bound, members[s: s + batch_size])
                for s in range(0, len(members), batch_size)]
    return out
