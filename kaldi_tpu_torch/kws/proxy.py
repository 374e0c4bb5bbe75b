"""Proxy keywords for OOV terms via phone-confusion expansion.

(ref: kwsbin/generate-proxy-keywords.cc — composes K × L2 × E' × L1⁻¹
 (keyword, OOV lexicon, phone edit/confusion transducer, in-vocab lexicon)
 and prunes to the n best in-vocabulary proxies. Here: the same capability
 as a beam edit-distance DP between the OOV pronunciation and every
 in-vocab word-sequence pronunciation of bounded length, with per-pair
 confusion costs — no FST composition chain needed at recipe scale.)

The port's copy of kaldi_tpu/kws/proxy.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import heapq
import math


def _edit_cost(src_phones, dst_phones, confusion_costs,
               sub_cost=1.0, ins_cost=1.0, del_cost=1.0):
    """Weighted Levenshtein with per-pair substitution costs.
    confusion_costs: {(p_from, p_to): cost} overrides (e.g. -log counts)."""
    n, m = len(src_phones), len(dst_phones)
    dp = [[0.0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        dp[i][0] = dp[i - 1][0] + del_cost
    for j in range(1, m + 1):
        dp[0][j] = dp[0][j - 1] + ins_cost
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            a, b = src_phones[i - 1], dst_phones[j - 1]
            sc = 0.0 if a == b else confusion_costs.get((a, b), sub_cost)
            dp[i][j] = min(dp[i - 1][j] + del_cost,
                           dp[i][j - 1] + ins_cost,
                           dp[i - 1][j - 1] + sc)
    return dp[n][m]


def generate_proxy_keywords(
    oov_pron,                 # phone list of the OOV keyword
    lexicon,                  # {word: [pron phone lists]}
    confusion_costs=None,     # {(p1, p2): cost}
    nbest: int = 10,
    beam: float = 4.0,
    max_words: int = 2,
):
    """-> [(proxy_word_tuple, cost)] best-first, cost = confusion distance.

    Single words and two-word concatenations are candidates (the
    reference's proxies are word sequences from L1 closure; beyond 2 words
    the proxies are rarely useful and the cost explodes).
    """
    confusion_costs = confusion_costs or {}
    heap: list = []

    def push(words, phones):
        c = _edit_cost(oov_pron, phones, confusion_costs)
        if c <= beam:
            heapq.heappush(heap, (c, words))

    items = [(w, p) for w, prons in lexicon.items() for p in prons]
    for w, p in items:
        push((w,), p)
    if max_words >= 2:
        # only pair words whose combined length is plausible
        target = len(oov_pron)
        for w1, p1 in items:
            if len(p1) >= target + 2:
                continue
            for w2, p2 in items:
                if abs(len(p1) + len(p2) - target) > 3:
                    continue
                push((w1, w2), list(p1) + list(p2))
    out = []
    seen = set()
    while heap and len(out) < nbest:
        c, words = heapq.heappop(heap)
        if words in seen:
            continue
        seen.add(words)
        out.append((words, c))
    return out
