"""Posterior algebra: the reference's `Posterior` type and its tools.

(ref: hmm/posterior.h:42 — Posterior = vector<vector<pair<int,float>>>;
 the *-post binary family: scale-post, weight-post, sum-post,
 post-to-weights, ali-to-post, post-to-pdf-post, post-to-phone-post,
 weight-silence-post.)

The port's copy of kaldi_tpu/hmm/posterior.py (host code), carried verbatim
so the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import numpy as np


def ali_to_post(tids, weight: float = 1.0):
    """(ref: bin/ali-to-post.cc)"""
    return [[(int(t), weight)] for t in tids]


def scale_post(post, scale: float):
    """(ref: bin/scale-post.cc)"""
    return [[(i, w * scale) for (i, w) in frame] for frame in post]


def weight_post(post, frame_weights):
    """Per-frame scaling; zero-weight frames become empty
    (ref: bin/weight-post.cc)."""
    out = []
    for frame, fw in zip(post, frame_weights):
        if fw == 0.0:
            out.append([])
        else:
            out.append([(i, w * fw) for (i, w) in frame])
    return out


def sum_post(a, b):
    """Merge two posteriors frame-by-frame (ref: bin/sum-post.cc)."""
    out = []
    for fa, fb in zip(a, b):
        d: dict = {}
        for (i, w) in list(fa) + list(fb):
            d[i] = d.get(i, 0.0) + w
        out.append(sorted(d.items()))
    return out


def post_to_weights(post):
    """Per-frame total weight (ref: bin/post-to-weights.cc)."""
    return np.array([sum(w for (_i, w) in frame) for frame in post])


def post_to_pdf_post(post, tm):
    """tid posteriors -> pdf posteriors (ref: bin/post-to-pdf-post.cc)."""
    out = []
    for frame in post:
        d: dict = {}
        for (tid, w) in frame:
            pdf = tm.transition_id_to_pdf(tid)
            d[pdf] = d.get(pdf, 0.0) + w
        out.append(sorted(d.items()))
    return out


def post_to_phone_post(post, tm):
    """(ref: bin/post-to-phone-post.cc)"""
    out = []
    for frame in post:
        d: dict = {}
        for (tid, w) in frame:
            ph = tm.transition_id_to_phone(tid)
            d[ph] = d.get(ph, 0.0) + w
        out.append(sorted(d.items()))
    return out


def weight_silence_post(post, tm, silence_phones, silence_scale: float):
    """Scale (or remove, scale=0) silence-phone entries
    (ref: bin/weight-silence-post.cc — the SAT/i-vector staple)."""
    sil = set(silence_phones)
    out = []
    for frame in post:
        nf = []
        for (tid, w) in frame:
            if tm.transition_id_to_phone(tid) in sil:
                if silence_scale != 0.0:
                    nf.append((tid, w * silence_scale))
            else:
                nf.append((tid, w))
        out.append(nf)
    return out


def merge_posteriors(post):
    """Merge duplicate ids within each frame."""
    out = []
    for frame in post:
        d: dict = {}
        for (i, w) in frame:
            d[i] = d.get(i, 0.0) + w
        out.append(sorted(d.items()))
    return out


def write_post_line(f, utt: str, post) -> None:
    """Kaldi text posterior line: 'utt [ id w id w ] [ ... ] ...'
    (ref: hmm/posterior.h WritePosterior text mode)."""
    parts = [utt]
    for frame in post:
        parts.append("[")
        for (i, w) in frame:
            parts.append(str(int(i)))
            parts.append(f"{float(w):.6g}")
        parts.append("]")
    f.write(" ".join(parts) + "\n")


def read_post_ark(path: str):
    """Yields (utt, post) from a text posterior archive."""
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            utt, toks = toks[0], toks[1:]
            post, frame = [], None
            it = iter(toks)
            for t in it:
                if t == "[":
                    frame = []
                elif t == "]":
                    post.append(frame)
                    frame = None
                else:
                    w = float(next(it))
                    frame.append((int(t), w))
            yield utt, post
