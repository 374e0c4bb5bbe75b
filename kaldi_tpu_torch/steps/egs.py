"""Disk-backed training-example (egs) pipeline.

(ref: steps/nnet2/get_egs2.sh — frame-chunk examples with context dumped
 to N pre-randomized archives; nnet2bin/nnet-copy-egs (distribute),
 nnet-shuffle-egs (buffered shuffling at read time). Features are stored
 with the CompressedMatrix codec like the reference's egs; archives are
 plain binary arks so the native C++ reader can stream the uncompressed
 variant.)

The port's copy of kaldi_tpu/steps/egs.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests/test_torch_*.py hold the two
equal.
"""

from __future__ import annotations

import os

import numpy as np

from kaldi_tpu_torch.io.kaldi_io import write_ark, read_ark


def dump_egs(
    aligned,               # [(feats [T, D], pdf_ids [T])]
    left_context: int, right_context: int, chunk: int,
    out_dir: str, num_archives: int = 2, compress: bool = True,
    seed: int = 0, utt_names=None, frame_weights=None,
):
    """Cut utterances into context-carrying chunks, distribute round-robin
    (randomized) across archives. Writes egs.<i>.ark (features) and
    targets.<i>.ark (pdf labels as int rows); weights.<i>.ark too when
    frame_weights is given (ref: nnet2bin/nnet-get-weighted-egs.cc).
    With utt_names, example keys are '<utt>:<frame-offset>' so
    nnet-relabel-egs can map them back to alignments. Returns archive
    count."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    examples = []
    for u, (feats, pdfs) in enumerate(aligned):
        T, D = feats.shape
        padded = np.pad(feats, ((left_context, right_context), (0, 0)),
                        mode="edge")
        for lo in range(0, T - chunk + 1, chunk):
            x = padded[lo: lo + chunk + left_context + right_context]
            y = np.asarray(pdfs[lo: lo + chunk], np.int32)
            w = (np.asarray(frame_weights[u][lo: lo + chunk], np.float32)
                 if frame_weights is not None else None)
            key = (f"{utt_names[u]}:{lo}" if utt_names is not None
                   else None)
            examples.append((key, x.astype(np.float32), y, w))
    order = rng.permutation(len(examples))
    buckets = [[] for _ in range(num_archives)]
    for i, idx in enumerate(order):
        key, x, y, w = examples[idx]
        buckets[i % num_archives].append(
            (key if key is not None else f"eg{idx:08d}", x, y, w))
    for a, items in enumerate(buckets):
        write_ark(os.path.join(out_dir, f"egs.{a}.ark"),
                  {k: x for (k, x, _y, _w) in items}, compress=compress)
        write_ark(os.path.join(out_dir, f"targets.{a}.ark"),
                  {k: y.astype(np.float32) for (k, _x, y, _w) in items})
        if frame_weights is not None:
            write_ark(os.path.join(out_dir, f"weights.{a}.ark"),
                      {k: w for (k, _x, _y, w) in items})
    return num_archives


def egs_minibatches(egs_dir: str, minibatch: int, num_archives: int,
                    num_epochs: int = 1, buffer_size: int = 512,
                    seed: int = 0):
    """Yield (feats [mb, chunk+ctx, D], targets [mb, chunk]) minibatches,
    buffered-shuffled at read time (the nnet-shuffle-egs contract: a
    bounded reservoir, not a global sort)."""
    rng = np.random.RandomState(seed)
    for _epoch in range(num_epochs):
        archive_order = rng.permutation(num_archives)
        buffer: list = []

        def flush_batches(drain=False):
            while len(buffer) >= (minibatch if drain else
                                  buffer_size):
                take = [buffer.pop(rng.randint(len(buffer)))
                        for _ in range(min(minibatch, len(buffer)))]
                if len(take) < minibatch:
                    return
                yield (np.stack([x for (x, _y) in take]),
                       np.stack([y for (_x, y) in take]))

        for a in archive_order:
            feats_it = read_ark(os.path.join(egs_dir, f"egs.{a}.ark"))
            targ = dict(read_ark(os.path.join(egs_dir,
                                              f"targets.{a}.ark")))
            for k, x in feats_it:
                buffer.append((x, targ[k].astype(np.int32)))
                if len(buffer) >= buffer_size:
                    yield from flush_batches()
        yield from flush_batches(drain=True)
