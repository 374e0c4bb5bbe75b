"""Kaldi data-directory convention: reading, validation, fixing.

(ref: the data-dir layout egs/*/s5/data/<set>/{wav.scp, text, utt2spk,
 spk2utt, feats.scp, segments} validated by utils/validate_data_dir.sh and
 repaired by utils/fix_data_dir.sh; utt2spk/spk2utt inversion by
 utils/utt2spk_to_spk2utt.pl.)

The port's copy of kaldi_tpu/utils/data_dir.py (host code), carried verbatim
so the port imports nothing of kaldi_tpu; tests/test_torch_*.py hold the two
equal.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class DataDir:
    path: str
    wav_scp: dict
    text: dict            # utt -> word list
    utt2spk: dict
    segments: dict        # utt -> (rec_id, t_begin, t_end) or {}
    feats_scp: dict

    @property
    def spk2utt(self) -> dict:
        out: dict = {}
        for u, s in self.utt2spk.items():
            out.setdefault(s, []).append(u)
        return {s: sorted(us) for s, us in out.items()}


def _read_map(path, split_value=False):
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if not parts:
                continue
            key = parts[0]
            val = parts[1] if len(parts) > 1 else ""
            out[key] = val.split() if split_value else val
    return out


def read_data_dir(path: str) -> DataDir:
    segments = {}
    seg_path = os.path.join(path, "segments")
    if os.path.exists(seg_path):
        with open(seg_path) as f:
            for line in f:
                u, rec, t0, t1 = line.split()[:4]
                segments[u] = (rec, float(t0), float(t1))
    return DataDir(
        path=path,
        wav_scp=_read_map(os.path.join(path, "wav.scp")),
        text=_read_map(os.path.join(path, "text"), split_value=True),
        utt2spk=_read_map(os.path.join(path, "utt2spk")),
        segments=segments,
        feats_scp=_read_map(os.path.join(path, "feats.scp")),
    )


def validate_data_dir(d: DataDir, require_text: bool = True,
                      require_feats: bool = False) -> list[str]:
    """-> list of problems (empty = valid)
    (ref: utils/validate_data_dir.sh checks)."""
    problems = []
    if not d.utt2spk:
        problems.append("utt2spk missing or empty")
    utts = set(d.utt2spk)
    # recording-level wav.scp when segments present
    wav_keys = set(d.wav_scp)
    if d.segments:
        recs = {r for (r, _a, _b) in d.segments.values()}
        missing = recs - wav_keys
        if missing:
            problems.append(f"segments reference recordings not in "
                            f"wav.scp: {sorted(missing)[:5]}")
        if set(d.segments) != utts:
            problems.append("segments keys != utt2spk keys")
        for u, (rec, t0, t1) in d.segments.items():
            if t1 <= t0:
                problems.append(f"segment {u} has t_end <= t_begin")
    elif d.wav_scp and wav_keys != utts:
        problems.append("wav.scp keys != utt2spk keys")
    if require_text:
        if set(d.text) != utts:
            problems.append("text keys != utt2spk keys")
        for u, words in d.text.items():
            if not words:
                problems.append(f"empty transcript for {u}")
                break
    if require_feats and set(d.feats_scp) != utts:
        problems.append("feats.scp keys != utt2spk keys")
    # keys must be sortable consistently (the 'sorted order' contract)
    for name, m in (("utt2spk", d.utt2spk), ("wav.scp", d.wav_scp)):
        keys = list(m)
        if keys != sorted(keys):
            problems.append(f"{name} not in sorted order")
    return problems


def fix_data_dir(d: DataDir) -> DataDir:
    """Keep the intersection of utterances present everywhere; sort keys
    (ref: utils/fix_data_dir.sh)."""
    utts = set(d.utt2spk)
    if d.text:
        utts &= set(d.text)
    if d.feats_scp:
        utts &= set(d.feats_scp)
    if d.segments:
        # a segment is only usable if its recording exists in wav.scp
        # (ref: utils/fix_data_dir.sh removes such segments; keeping them
        # crashes consumers like extract-segments with a missing key)
        usable = {u for u, (rec, _b, _e) in d.segments.items()
                  if not d.wav_scp or rec in d.wav_scp}
        utts &= usable
    elif d.wav_scp:
        utts &= set(d.wav_scp)

    def keep(m):
        return {k: m[k] for k in sorted(m) if k in utts}

    return DataDir(
        path=d.path,
        wav_scp=(dict(sorted(d.wav_scp.items())) if d.segments
                 else keep(d.wav_scp)),
        text=keep(d.text),
        utt2spk=keep(d.utt2spk),
        segments=keep(d.segments) if d.segments else {},
        feats_scp=keep(d.feats_scp),
    )


def write_data_dir(d: DataDir, path: str | None = None):
    path = path or d.path
    os.makedirs(path, exist_ok=True)

    def dump(name, m, fmt=lambda v: v):
        if not m:
            return
        with open(os.path.join(path, name), "w") as f:
            for k in sorted(m):
                f.write(f"{k} {fmt(m[k])}\n")

    dump("wav.scp", d.wav_scp)
    dump("text", d.text, lambda ws: " ".join(ws))
    dump("utt2spk", d.utt2spk)
    dump("feats.scp", d.feats_scp)
    if d.segments:
        dump("segments", d.segments,
             lambda s: f"{s[0]} {s[1]:.3f} {s[2]:.3f}")
    dump("spk2utt", d.spk2utt, lambda us: " ".join(us))
