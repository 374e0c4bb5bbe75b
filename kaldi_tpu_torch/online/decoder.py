"""Chunked online decoding with a carried frontier.

Counterpart of kaldi_tpu/online/decoder.py (ref:
decoder/lattice-faster-online-decoder.h:47 — InitDecoding /
AdvanceDecoding / partial traceback; online2/online-nnet2-decoding.h:67
SingleUtteranceNnet2Decoder). The per-frame program is the offline padded
decoder's (`beam_search._padded_rounds`); the frontier (state, score)
stays on the decoder's device across chunks, and each chunk's per-round
records come to the host in one copy, where the traceback walks them.

What changes with the framework: JAX scans a fixed `chunk_frames` block
with the frames past the chunk's end masked (they keep the frontier, and
their records are never read); the port loops over the chunk's real
frames only, which gives the same frontier and the same records. A
record is (state, score bits as int32, prev slot, olabel, ilabel), as in
JAX's packed block.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.decoder.beam_search import BIG, BeamSearchDecoder


class OnlineDecoder:
    """Single-stream chunked decoder with partial/final traceback; it runs
    on its BeamSearchDecoder's device."""

    def __init__(self, base: BeamSearchDecoder, chunk_frames: int = 32):
        self.base = base
        self.opts = base.opts
        self.chunk = chunk_frames
        self.device = base.device
        self.init_decoding()

    def init_decoding(self):
        """(ref: lattice-faster-decoder.cc:547 InitDecoding)"""
        K = self.opts.max_active
        st = np.zeros(K, np.int32)
        sc = np.full(K, BIG, np.float32)
        st[0] = self.base.graph.start
        sc[0] = 0.0
        self._tok = (st, sc)           # host until the closure has run
        self._records: list = []   # per frame: per-round (st, sc, pv, ol, il)
        self._init_records: list = []  # (prev_slot, olabel) per closure round
        self._init_done = False
        self.num_frames_decoded = 0

    def _ensure_init(self):
        """The start state's eps closure on the host, as the JAX class runs
        it: each round keeps the best (cost, prev slot, olabel) per state
        in insertion order, then the K cheapest by a stable sort."""
        if self._init_done:
            return
        st, sc = self._tok
        tabs = self.base._tabs_np
        for _ in range(self.opts.eps_expansions):
            best: dict = {}   # state -> (cost, prev_slot, olabel)
            for j in range(len(st)):
                if sc[j] < BIG / 2:
                    cur = best.get(int(st[j]))
                    if cur is None or sc[j] < cur[0]:
                        best[int(st[j])] = (float(sc[j]), j, 0)
            for j in range(len(st)):
                if sc[j] >= BIG / 2:
                    continue
                s = st[j]
                for e in range(tabs["ilabel"].shape[1]):
                    if tabs["ilabel"][s, e] == 0 and \
                            tabs["cost"][s, e] < BIG / 2:
                        s2 = int(tabs["nxt"][s, e])
                        c2 = float(sc[j] + tabs["cost"][s, e])
                        cur = best.get(s2)
                        if cur is None or c2 < cur[0]:
                            best[s2] = (c2, j, int(tabs["olabel"][s, e]))
            items = sorted(best.items(), key=lambda kv: kv[1][0])[: len(st)]
            st = np.zeros_like(st)
            sc = np.full_like(sc, BIG)
            pv = np.zeros(len(st), np.int32)
            ol = np.zeros(len(st), np.int32)
            for k, (s2, (c2, j, o)) in enumerate(items):
                st[k] = s2
                sc[k] = c2
                pv[k] = j
                ol[k] = o
            self._init_records.append((pv, ol))
        self._tok = (torch.as_tensor(st, device=self.device)[None],
                     torch.as_tensor(sc, device=self.device)[None])
        self._init_done = True

    def _frontier_np(self):
        if not self._init_done:
            return self._tok
        st, sc = (t[0].cpu().numpy() for t in self._tok)
        return st, sc

    @torch.no_grad()
    def advance_decoding(self, loglikes: np.ndarray):
        """Consume [n, P] new acoustic frames of UNscaled log-likelihoods;
        opts.acoustic_scale is applied here (the offline decoder's
        contract)."""
        if loglikes.shape[0] == 0:
            return
        self._ensure_init()
        frame_step = self.base._rounds[0]
        n = loglikes.shape[0]
        st, sc = self._tok
        for lo in range(0, n, self.chunk):
            piece = np.asarray(loglikes[lo: lo + self.chunk], np.float32) \
                * self.opts.acoustic_scale
            ll = torch.as_tensor(piece, device=self.device)
            blocks = []
            for t in range(piece.shape[0]):
                st, sc, records = frame_step(st, sc, ll[t:t + 1])
                blocks.append(torch.stack([
                    torch.stack([r_st[0], r_sc[0].view(torch.int32),
                                 r_pv[0], r_ol[0], r_il[0]])
                    for (r_st, r_sc, r_pv, r_ol, r_il) in records]))
            recs = torch.stack(blocks).cpu().numpy()   # ONE copy: [n, R, 5, K]
            for t in range(recs.shape[0]):
                self._records.append(tuple(
                    (recs[t, r, 0], recs[t, r, 1].view(np.float32),
                     recs[t, r, 2], recs[t, r, 3], recs[t, r, 4])
                    for r in range(recs.shape[1])))
            self.num_frames_decoded += recs.shape[0]
        self._tok = (st, sc)

    def _traceback(self, slot: int):
        words_rev, tids_rev = [], []
        for rounds in reversed(self._records):
            for (_r_st, _r_sc, r_pv, r_ol, r_il) in reversed(rounds):
                o = int(r_ol[slot])
                if o != 0:
                    words_rev.append(o)
                i = int(r_il[slot])
                if i != 0:
                    tids_rev.append(i)
                slot = int(r_pv[slot])
        # continue through the initial eps-closure rounds (words on eps
        # arcs out of the start state, e.g. after label pushing)
        for (pv, ol) in reversed(self._init_records):
            o = int(ol[slot])
            if o != 0:
                words_rev.append(o)
            slot = int(pv[slot])
        return list(reversed(words_rev)), list(reversed(tids_rev))

    def best_path(self, use_final_probs: bool = True):
        """-> (words, tids, cost) partial or final result, or None
        (ref: lattice-faster-online-decoder.h BestPathIterator traceback)."""
        st, sc = self._frontier_np()
        if use_final_probs:
            total = sc + self.base._final_np[st]
            if total.min() < BIG / 2:
                slot = int(np.argmin(total))
                words, tids = self._traceback(slot)
                return words, tids, float(total[slot])
        slot = int(np.argmin(sc))
        if sc[slot] >= BIG / 2:
            return None
        words, tids = self._traceback(slot)
        return words, tids, float(sc[slot])

    def final_relative_cost(self) -> float:
        """(ref: lattice-faster-online-decoder FinalRelativeCost — used by
        the endpointing rules)."""
        st, sc = self._frontier_np()
        best = sc.min()
        best_final = (sc + self.base._final_np[st]).min()
        if best >= BIG / 2:
            return float("inf")
        return float(best_final - best)

    def trailing_silence_frames(self, silence_phones: set,
                                trans_model) -> int:
        """Consecutive final frames whose best-path phone is silence
        (ref: online2/online-endpoint.h TrailingSilenceLength)."""
        res = self.best_path(use_final_probs=False)
        if res is None:
            return 0
        _w, tids, _c = res
        count = 0
        for tid in reversed(tids):
            if trans_model.transition_id_to_phone(tid) in silence_phones:
                count += 1
            else:
                break
        return count
