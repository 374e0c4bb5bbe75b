"""WER scoring and text alignment.

(ref: bin/compute-wer.cc, bin/align-text.cc — standard Levenshtein with
 insertions/deletions/substitutions.)

The port's copy of kaldi_tpu/utils/wer.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def levenshtein_alignment(ref: list, hyp: list, eps="<eps>"):
    """-> (pairs [(ref_tok|eps, hyp_tok|eps)], (n_sub, n_ins, n_del))."""
    R, H = len(ref), len(hyp)
    dp = np.zeros((R + 1, H + 1), np.int32)
    dp[:, 0] = np.arange(R + 1)
    dp[0, :] = np.arange(H + 1)
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            sub = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dp[i, j] = min(sub, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    pairs = []
    i, j = R, H
    n_sub = n_ins = n_del = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] != hyp[j - 1]:
                n_sub += 1
            pairs.append((ref[i - 1], hyp[j - 1]))
            i -= 1
            j -= 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            pairs.append((ref[i - 1], eps))
            n_del += 1
            i -= 1
        else:
            pairs.append((eps, hyp[j - 1]))
            n_ins += 1
            j -= 1
    pairs.reverse()
    return pairs, (n_sub, n_ins, n_del)


@dataclasses.dataclass
class WerStats:
    n_ref: int = 0
    n_sub: int = 0
    n_ins: int = 0
    n_del: int = 0
    n_sent: int = 0
    n_sent_err: int = 0

    @property
    def errors(self) -> int:
        return self.n_sub + self.n_ins + self.n_del

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.n_ref, 1)

    @property
    def ser(self) -> float:
        return 100.0 * self.n_sent_err / max(self.n_sent, 1)

    def add(self, ref: list, hyp: list):
        _, (s, i, d) = levenshtein_alignment(ref, hyp)
        self.n_ref += len(ref)
        self.n_sub += s
        self.n_ins += i
        self.n_del += d
        self.n_sent += 1
        self.n_sent_err += 1 if (s + i + d) else 0

    def __str__(self):
        return (f"%WER {self.wer:.2f} [ {self.errors} / {self.n_ref}, "
                f"{self.n_ins} ins, {self.n_del} del, {self.n_sub} sub ] "
                f"%SER {self.ser:.2f} [ {self.n_sent_err} / {self.n_sent} ]")


def compute_wer(refs: dict, hyps: dict) -> WerStats:
    """refs/hyps: utt_id -> list of words. Missing hyp counts as empty."""
    stats = WerStats()
    for utt, ref in refs.items():
        stats.add(ref, hyps.get(utt, []))
    return stats
