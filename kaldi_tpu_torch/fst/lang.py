"""Lexicon FST (L) and `lang` directory equivalent.

(ref: egs/wsj/s5/utils/prepare_lang.sh:91-182, utils/make_lexicon_fst.pl,
 utils/add_lex_disambig.pl.) A `Lang` bundles the phone/word symbol tables,
topology, and L / L_disambig FSTs — the in-memory equivalent of data/lang.

The port's copy of kaldi_tpu/fst/lang.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import dataclasses
import math

from kaldi_tpu_torch.fst.fst import Fst, EPS, SymbolTable
from kaldi_tpu_torch.hmm.topology import HmmTopology


@dataclasses.dataclass
class Lexicon:
    """entries: (word, prob, pronunciation phone list)."""

    entries: list[tuple[str, float, list[str]]]

    @staticmethod
    def parse(text: str, with_probs: bool = False) -> "Lexicon":
        entries = []
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            if with_probs:
                entries.append((parts[0], float(parts[1]), parts[2:]))
            else:
                entries.append((parts[0], 1.0, parts[1:]))
        return Lexicon(entries)


def add_lex_disambig(lexicon: Lexicon) -> tuple[list[list[str]], int]:
    """Append #k disambig symbols to prons that are duplicates or prefixes.

    Returns (pron lists with disambig appended, max disambig index used).
    (ref: utils/add_lex_disambig.pl)
    """
    prons = [tuple(e[2]) for e in lexicon.entries]
    counts: dict[tuple, int] = {}
    for p in prons:
        counts[p] = counts.get(p, 0) + 1
    prefixes = set()
    for p in prons:
        for k in range(1, len(p)):
            prefixes.add(p[:k])
    last_used: dict[tuple, int] = {}
    out = []
    max_disambig = 0
    for p in prons:
        needs = counts[p] > 1 or p in prefixes
        if not needs:
            out.append(list(p))
            continue
        cur = last_used.get(p, 0) + 1
        # never reuse #1 for a pron that is also a prefix of another with #1
        last_used[p] = cur
        max_disambig = max(max_disambig, cur)
        out.append(list(p) + [f"#{cur}"])
    return out, max_disambig


def make_lexicon_fst(
    lexicon: Lexicon,
    phones: SymbolTable,
    words: SymbolTable,
    prons_disambig: list[list[str]] | None = None,
    sil_phone: str | None = "SIL",
    sil_prob: float = 0.5,
    sil_disambig: str | None = None,
) -> Fst:
    """L: phones -> words with optional silence (ref: utils/make_lexicon_fst.pl).

    Structure: loop state with per-pron paths; each pron ends with a choice
    of returning directly (cost -log(1-silprob)) or via the optional-silence
    state (cost -log(silprob), emitting sil_phone).
    """
    f = Fst()
    start = f.add_state()
    loop = f.add_state()
    f.start = start
    f.set_final(loop, 0.0)
    use_sil = sil_phone is not None and sil_prob > 0.0
    if use_sil:
        sil_cost = -math.log(sil_prob)
        no_sil_cost = -math.log(1.0 - sil_prob)
        sil_state = f.add_state()
        f.add_arc(start, EPS, EPS, no_sil_cost, loop)
        # sil_state emits optional silence (+ its disambig, if given) -> loop;
        # the INITIAL optional silence must also pass through sil_disambig
        # (ref: utils/make_lexicon_fst.pl — both the start-state silence and
        # the post-word silence route through the disambig state, else
        # L_disambig is not determinizable against sil-prefixed homophones)
        if sil_disambig:
            mid = f.add_state()
            f.add_arc(start, phones[sil_phone], EPS, sil_cost, mid)
            f.add_arc(sil_state, phones[sil_phone], EPS, 0.0, mid)
            f.add_arc(mid, phones[sil_disambig], EPS, 0.0, loop)
        else:
            f.add_arc(start, phones[sil_phone], EPS, sil_cost, loop)
            f.add_arc(sil_state, phones[sil_phone], EPS, 0.0, loop)
    else:
        no_sil_cost = 0.0
        f.add_arc(start, EPS, EPS, 0.0, loop)
        sil_state = None

    prons = prons_disambig if prons_disambig is not None else [
        list(e[2]) for e in lexicon.entries]
    for (word, prob, _pron), pron in zip(lexicon.entries, prons):
        pron_cost = -math.log(max(prob, 1e-20))
        cur = loop
        for k, ph in enumerate(pron):
            olabel = words[word] if k == 0 else EPS
            cost = pron_cost if k == 0 else 0.0
            last = k == len(pron) - 1
            if not last:
                nxt = f.add_state()
                f.add_arc(cur, phones[ph], olabel, cost, nxt)
                cur = nxt
            else:
                if use_sil:
                    f.add_arc(cur, phones[ph], olabel, cost + no_sil_cost, loop)
                    f.add_arc(cur, phones[ph], olabel, cost + sil_cost, sil_state)
                else:
                    f.add_arc(cur, phones[ph], olabel, cost, loop)
        if len(pron) == 0:  # empty pronunciation: eps arc
            if use_sil:
                f.add_arc(cur, EPS, words[word], pron_cost + no_sil_cost, loop)
                f.add_arc(cur, EPS, words[word], pron_cost + sil_cost, sil_state)
            else:
                f.add_arc(cur, EPS, words[word], pron_cost, loop)
    f.arcsort("olabel")
    return f


@dataclasses.dataclass
class Lang:
    """In-memory data/lang: symbol tables + L FSTs + topology + phone sets."""

    phones: SymbolTable
    words: SymbolTable
    topo: HmmTopology
    L: Fst
    L_disambig: Fst
    silence_phones: list[str]
    optional_silence: str | None
    num_disambig: int  # #0..#num_disambig are in `phones`

    @property
    def disambig_phone_ids(self) -> list[int]:
        return [self.phones[f"#{k}"] for k in range(self.num_disambig + 1)]

    @property
    def phone_ids(self) -> list[int]:
        """Real phone ids (excluding eps and disambig)."""
        dis = set(self.disambig_phone_ids)
        return [i for i in range(1, len(self.phones))
                if i not in dis]


def prepare_lang(
    lexicon: Lexicon,
    silence_phones: list[str],
    optional_silence: str | None = "SIL",
    nonsilence_phones: list[str] | None = None,
    sil_prob: float = 0.5,
    num_sil_states: int = 5,
    num_nonsil_states: int = 3,
) -> Lang:
    """Build the lang bundle (ref: utils/prepare_lang.sh, position-independent
    phones variant; word-position-dependent phones arrive with the triphone
    stage)."""
    if nonsilence_phones is None:
        nonsil = sorted({ph for (_w, _p, pron) in lexicon.entries
                         for ph in pron if ph not in silence_phones})
    else:
        nonsil = list(nonsilence_phones)
    phones = SymbolTable()
    for p in list(silence_phones) + nonsil:
        phones.add(p)
    words = SymbolTable()
    for w in sorted({e[0] for e in lexicon.entries}):
        words.add(w)

    prons_disambig, max_disambig = add_lex_disambig(lexicon)
    # #0 for the LM backoff symbol, #1.. for the lexicon
    for k in range(0, max_disambig + 1):
        phones.add(f"#{k}")
    words.add("#0")
    words.add("<s>")
    words.add("</s>")

    sil_ids = [phones[p] for p in silence_phones]
    nonsil_ids = [phones[p] for p in nonsil]
    topo = HmmTopology.five_state_silence(sil_ids, nonsil_ids,
                                          num_sil_states=num_sil_states)

    L = make_lexicon_fst(lexicon, phones, words, None,
                         optional_silence, sil_prob)
    L_dis = make_lexicon_fst(lexicon, phones, words, prons_disambig,
                             optional_silence, sil_prob)
    # passthrough for the LM backoff disambig symbol #0 at the loop state
    # (ref: prepare_lang.sh adds the #0:#0 self-loop via add_disambig)
    loop = 1
    L_dis.add_arc(loop, phones["#0"], words["#0"], 0.0, loop)
    L_dis.arcsort("olabel")
    return Lang(
        phones=phones, words=words, topo=topo, L=L, L_disambig=L_dis,
        silence_phones=list(silence_phones), optional_silence=optional_silence,
        num_disambig=max_disambig,
    )
