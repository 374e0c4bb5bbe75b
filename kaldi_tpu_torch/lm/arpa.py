"""ARPA n-gram LM parsing and G-FST construction.

(ref: bin/arpa2fst.cc + the recipe pipeline
 utils/format_lm.sh:50-55 — arpa2fst | eps2disambig | s2eps | rmepsilon:
 backoff arcs carry #0 on the input side, <s>/</s> become epsilon/finality.)

States are n-gram histories; costs are -log10 prob * ln(10) (natural log).

The port's copy of kaldi_tpu/lm/arpa.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses
import math

from kaldi_tpu_torch.fst.fst import Fst, EPS, SymbolTable

LN10 = math.log(10.0)


@dataclasses.dataclass
class ArpaLm:
    order: int
    # ngrams[k] : dict (tuple words) -> (logprob_ln, backoff_ln or None)
    ngrams: list[dict]

    @staticmethod
    def parse(text: str) -> "ArpaLm":
        lines = iter(text.splitlines())
        ngrams: list[dict] = []
        counts = []
        for line in lines:
            if line.strip() == "\\data\\":
                break
        for line in lines:
            line = line.strip()
            if not line:
                continue
            if line.startswith("ngram"):
                counts.append(int(line.split("=")[1]))
            else:
                break
        order = len(counts)
        ngrams = [dict() for _ in range(order)]
        cur = None
        # `line` currently holds "\1-grams:" from the loop above
        while True:
            if line is None:
                break
            s = line.strip()
            if s.startswith("\\") and s.endswith("-grams:"):
                cur = int(s[1:].split("-")[0]) - 1
            elif s == "\\end\\":
                break
            elif s and cur is not None:
                parts = s.split()
                logp = float(parts[0]) * LN10
                words = tuple(parts[1: 1 + cur + 1])
                backoff = None
                if len(parts) > 1 + cur + 1:
                    backoff = float(parts[1 + cur + 1]) * LN10
                ngrams[cur][words] = (logp, backoff)
            line = next(lines, None)
        return ArpaLm(order, ngrams)

    def score_sentence(self, words: list[str]) -> float:
        """Natural-log prob of <s> words </s> with backoff (test oracle)."""
        seq = ["<s>"] + list(words) + ["</s>"]
        total = 0.0
        for i in range(1, len(seq)):
            hist = tuple(seq[max(0, i - self.order + 1): i])
            total += self._cond_logprob(tuple(hist), seq[i])
        return total

    def _cond_logprob(self, hist: tuple, word: str) -> float:
        while True:
            ng = hist + (word,)
            k = len(ng) - 1
            if k < self.order and ng in self.ngrams[k]:
                return self.ngrams[k][ng][0]
            if not hist:
                return -99 * LN10  # unseen unigram
            # back off
            bw = 0.0
            hk = len(hist) - 1
            if hist in self.ngrams[hk]:
                b = self.ngrams[hk][hist][1]
                bw = b if b is not None else 0.0
            return bw + self._cond_logprob(hist[1:], word)


def arpa_to_g(
    lm: ArpaLm,
    words: SymbolTable,
    backoff_symbol: str = "#0",
) -> Fst:
    """Build G with #0-input backoff arcs and eps'd <s>/</s>.

    OOV n-grams (words not in the table) are dropped, like remove_oovs.pl.
    """
    f = Fst()
    state_of: dict[tuple, int] = {}

    # contexts: every entry of order < max PLUS the history of any entry,
    # prefix-closed — the missing-backoff case (a trigram whose history
    # bigram is absent must still get its own state, matching ConstArpaLm;
    # ref: src/lm/missing_backoffs.arpa)
    contexts: set = set()
    for k in range(1, lm.order):
        contexts.update(lm.ngrams[k - 1].keys())
    for k in range(2, lm.order + 1):
        for ng in lm.ngrams[k - 1]:
            hist = ng[:-1]
            for i in range(1, len(hist) + 1):
                contexts.add(hist[:i])

    def get_state(hist: tuple) -> int:
        # back off the history to one that exists as a context
        while hist and not _is_context(hist):
            hist = hist[1:]
        s = state_of.get(hist)
        if s is None:
            s = f.add_state()
            state_of[hist] = s
        return s

    def _is_context(hist: tuple) -> bool:
        return 0 < len(hist) < lm.order and hist in contexts

    backoff_id = words.get(backoff_symbol)
    # start state: history (<s>,) for order>1 else ()
    if lm.order > 1 and ("<s>",) in lm.ngrams[0]:
        start_hist = ("<s>",)
    else:
        start_hist = ()
    f.start = get_state(start_hist)

    for k in range(lm.order):
        for ng, (logp, backoff) in lm.ngrams[k].items():
            hist, word = ng[:-1], ng[-1]
            if word == "<s>":
                # handled via start state; it may still carry a backoff below
                if k + 1 < lm.order and backoff is not None:
                    s = get_state(ng)
                    f.add_arc(s, backoff_id or EPS, EPS, -backoff,
                              get_state(ng[1:]))
                continue
            src = get_state(hist)
            if word == "</s>":
                cur = f.final(src)
                f.set_final(src, min(cur, -logp))
                continue
            if word not in words:
                continue  # OOV pruning
            dst = get_state(ng)
            f.add_arc(src, words[word], words[word], -logp, dst)
            if k + 1 < lm.order and backoff is not None and _is_context(ng):
                f.add_arc(dst, backoff_id or EPS, EPS, -backoff,
                          get_state(ng[1:]))

    # ensure every non-unigram state can back off
    for hist, s in list(state_of.items()):
        if not hist:
            continue
        hk = len(hist) - 1
        ent = lm.ngrams[hk].get(hist)
        has_bo = any(a[0] == (backoff_id or EPS) and a[1] == EPS
                     for a in f.arcs[s])
        if not has_bo:
            bw = ent[1] if (ent and ent[1] is not None) else 0.0
            f.add_arc(s, backoff_id or EPS, EPS, -bw, get_state(hist[1:]))

    f.connect()
    f.arcsort("ilabel")
    return f
