"""Synthetic lexicon + pruned-trigram ARPA generation at vocabulary scale.

Without real corpora at hand, production-scale graph
builds need synthetic language resources with realistic SHAPE: a 60k-word
lexicon over a phone set, and a pruned trigram LM whose context/backoff
structure matches what arpa2fst + mkgraph consume from a real pruned LM
(ref: egs/wsj/s5/local/wsj_train_lms.sh produces *.tgpr — unigrams for
the full vocab, pruned bigram/trigram subsets, backoff weights on every
context).

Probabilities are Zipf-shaped and properly normalized per history so the
resulting G is stochastic-ish (determinize --use-log preserves it) and
graph random walks (decoder/simulate.py) follow a plausible word
distribution.

The port's copy of kaldi_tpu/lm/synth.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import math

import numpy as np


def synth_lexicon_text(n_words: int, n_phones: int = 39,
                       min_len: int = 3, max_len: int = 8,
                       rng=None) -> tuple[str, list[str]]:
    """-> (lexicon text 'WORD ph ph ..' per line, word list).

    Phone names P1..Pn; words W000001.. (rank order = Zipf rank).
    Homophones are possible and legal — prepare_lang adds disambiguation
    symbols exactly as the reference does.
    """
    rng = rng or np.random.default_rng(0)
    words = [f"W{k:06d}" for k in range(1, n_words + 1)]
    lens = rng.integers(min_len, max_len + 1, size=n_words)
    phones = rng.integers(1, n_phones + 1, size=int(lens.sum()))
    lines = []
    pos = 0
    for w, L in zip(words, lens):
        seq = " ".join(f"P{p}" for p in phones[pos: pos + L])
        pos += L
        lines.append(f"{w} {seq}")
    return "\n".join(lines), words


def synth_trigram_arpa(words: list[str], n_bigrams: int, n_trigrams: int,
                       rng=None):
    """-> ArpaLm (order 3): Zipf unigrams over all words + sampled
    bigram/trigram subsets with per-history normalization and backoff
    weights (the structure of a Katz-backoff pruned LM)."""
    from kaldi_tpu_torch.lm.arpa import ArpaLm
    rng = rng or np.random.default_rng(0)
    V = len(words)

    # --- unigrams: Zipf over rank, plus <s>/</s>
    ranks = np.arange(1, V + 1, dtype=np.float64)
    p1 = 1.0 / ranks
    p1 /= p1.sum() * 1.12           # reserve ~12% mass for <s>/</s>
    uni = {}
    for w, p in zip(words, p1):
        uni[(w,)] = [math.log(p), 0.0]
    uni[("<s>",)] = [math.log(1e-9), 0.0]       # never predicted
    uni[("</s>",)] = [math.log(0.06), None]
    # <s> also gets a backoff-carrying context entry via uni

    def zipf_choice(n, size):
        """Zipf-ish ranks in [0, n) — favors frequent words as contexts
        and successors, like real corpus counts."""
        u = rng.random(size)
        r = (n ** u - 1.0)          # denser at small ranks
        return np.minimum(r.astype(np.int64), n - 1)

    # --- bigrams: contexts and successors Zipf-sampled
    n_bigrams = int(n_bigrams)
    h = zipf_choice(V, n_bigrams)
    s = zipf_choice(V, n_bigrams)
    # plus <s> successors for a real start context
    n_start = max(32, n_bigrams // 200)
    pairs = {(words[int(a)], words[int(b)]) for a, b in zip(h, s)}
    pairs.update(("<s>", words[int(b)]) for b in zipf_choice(V, n_start))
    pairs.update((words[int(a)], "</s>")
                 for a in zipf_choice(V, max(16, n_bigrams // 400)))
    # group by history, normalize 80% of the history's mass over its
    # successors (20% reserved for backoff -> backoff weight)
    by_hist: dict = {}
    for (a, b) in pairs:
        by_hist.setdefault(a, []).append(b)
    bi = {}
    for a, succs in by_hist.items():
        k = len(succs)
        w = 1.0 / (1.0 + np.arange(k, dtype=np.float64))
        w *= 0.8 / w.sum()
        for b, p in zip(succs, w):
            bi[(a, b)] = [math.log(p), 0.0]
        uni_key = (a,)
        if uni_key in uni:
            uni[uni_key][1] = math.log(0.2)     # backoff weight
    # --- trigrams: histories drawn from existing bigrams
    bi_list = list(bi.keys())
    n_trigrams = int(min(n_trigrams, len(bi_list) * 8))
    hi = zipf_choice(len(bi_list), n_trigrams)
    ns = zipf_choice(V, n_trigrams)
    tris = {}
    t_by_hist: dict = {}
    for i, j in zip(hi, ns):
        h2 = bi_list[int(i)]
        t_by_hist.setdefault(h2, set()).add(words[int(j)])
    for h2, succs in t_by_hist.items():
        k = len(succs)
        w = 1.0 / (1.0 + np.arange(k, dtype=np.float64))
        w *= 0.7 / w.sum()
        for b, p in zip(sorted(succs), w):
            tris[h2 + (b,)] = [math.log(p), None]
        bi[h2][1] = math.log(0.3)               # trigram backoff weight
    ngrams = [
        {k: (v[0], v[1]) for k, v in uni.items()},
        {k: (v[0], v[1]) for k, v in bi.items()},
        {k: (v[0], None) for k, v in tris.items()},
    ]
    return ArpaLm(order=3, ngrams=ngrams)
