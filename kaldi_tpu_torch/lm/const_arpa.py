"""ConstArpaLm: immutable packed n-gram LM + deterministic on-demand FST.

(ref: lm/const-arpa-lm.h:32 ConstArpaLm — a compact read-only layout of an
 ARPA LM queried by (history, word); :202 ConstArpaLmDeterministicFst — the
 on-demand deterministic FST over LM states used by
 latbin/lattice-lmrescore-const-arpa.cc. We pack n-grams into flat numpy
 arrays — per-state sorted word columns searched with np.searchsorted —
 instead of the reference's pointer-blob, which keeps the table mmap-able
 and lets batched rescoring gather scores vectorized.)

The port's copy of kaldi_tpu/lm/const_arpa.py. The constructor, `step`,
`final_cost`, `sentence_logprob`, `_batch_tables` and the scalar
`lattice_lmrescore_const_arpa` are host code, copied verbatim (state ids
follow dict insertion order, so every table equals JAX's array for array).
The batch queries run on a device (default the card): `device_tables`
moves the tables there once per device, `step_batch` runs JAX's
`order + 1` rounds of searchsorted over the composite (state, word) key
with torch.searchsorted, accumulating the f32 column costs into an f64
vector in JAX's order (so every device gives JAX's costs exactly), and
`lattice_lmrescore_const_arpa_batch` runs JAX's level-synchronous BFS
with the frontier, the pair keys seen so far (a sorted tensor in place of
JAX's dict) and the output arcs on that device, one host sync per level;
`lattice_lmrescore_const_arpa_many` runs many lattices' levels together,
each lattice still JAX's array for array.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.lm.arpa import ArpaLm
from kaldi_tpu_torch.lat.lattice import Lattice


class ConstArpaLm:
    """Packed LM. States are n-gram histories (word-id tuples); queries are
    fully vectorizable: per-state contiguous [lo, hi) ranges of sorted word
    ids with parallel logprob / backoff / nextstate columns."""

    def __init__(self, lm: ArpaLm, words):
        self.order = lm.order
        self.bos = words.get("<s>")
        self.eos = words.get("</s>")
        self.unk_cost = 99.0 * np.log(10.0)

        # enumerate states: every history that is a context of some n-gram.
        # A state exists if it is itself an n-gram entry of order < max, OR
        # appears as the history of any entry even without its own entry —
        # the reference's "missing backoffs" case (src/lm/missing_backoffs.arpa):
        # such states get implicit backoff weight 0.
        hist_set = {(): 0}

        def usable(ng):
            return all(w in words or w in ("<s>", "</s>") for w in ng)

        for k in range(1, lm.order):
            for ng in lm.ngrams[k - 1]:
                if usable(ng):
                    hist_set.setdefault(ng, len(hist_set))
        for k in range(2, lm.order + 1):
            for ng in lm.ngrams[k - 1]:
                hist = ng[:-1]
                if usable(hist):
                    # prefix closure: the on-demand FST reaches a history
                    # one word at a time, so every prefix must be a state
                    # (src/lm/unused_backoffs.arpa exercises this)
                    for i in range(1, len(hist) + 1):
                        hist_set.setdefault(hist[:i], len(hist_set))
        self._hist_index = hist_set
        n_states = len(hist_set)

        def wid(w):
            if w == "<s>":
                return -1 if self.bos is None else self.bos
            if w == "</s>":
                return -2 if self.eos is None else self.eos
            return words.get(w)

        # id-tuple history per state + index for next-state extension lookup
        self._state_hist = [()] * n_states
        self._ext_index: dict = {}
        for h, s in hist_set.items():
            ids = tuple(wid(w) for w in h)
            self._state_hist[s] = ids
            self._ext_index.setdefault(ids, s)

        # collect (state, word, logp, next_state) rows + per-state backoff
        rows = [[] for _ in range(n_states)]
        self.backoff_cost = np.zeros(n_states, np.float32)
        self.backoff_state = np.zeros(n_states, np.int64)
        for hist, s in hist_set.items():
            if hist:
                ent = lm.ngrams[len(hist) - 1].get(hist)
                bo = ent[1] if (ent and ent[1] is not None) else 0.0
                self.backoff_cost[s] = -bo
                # back off to the longest suffix that is a state
                suf = hist[1:]
                while suf not in hist_set:
                    suf = suf[1:]
                self.backoff_state[s] = hist_set[suf]
        for k in range(lm.order):
            for ng, (logp, _bo) in lm.ngrams[k].items():
                hist, word = ng[:-1], ng[-1]
                if hist not in hist_set:
                    continue
                w = wid(word)
                if w is None or word == "<s>":
                    continue
                # next state: longest suffix of ng that is a state
                nxt = ng
                while nxt not in hist_set:
                    nxt = nxt[1:]
                rows[hist_set[hist]].append((w, -logp, hist_set[nxt]))

        counts = [len(r) for r in rows]
        self.row_lo = np.zeros(n_states + 1, np.int64)
        np.cumsum(counts, out=self.row_lo[1:])
        total = int(self.row_lo[-1])
        self.col_word = np.zeros(total, np.int64)
        self.col_cost = np.zeros(total, np.float32)
        self.col_next = np.zeros(total, np.int64)
        for s, r in enumerate(rows):
            r.sort()
            lo = int(self.row_lo[s])
            for i, (w, c, nx) in enumerate(r):
                self.col_word[lo + i] = w
                self.col_cost[lo + i] = c
                self.col_next[lo + i] = nx

    @property
    def num_states(self) -> int:
        return len(self.row_lo) - 1

    def start_state(self) -> int:
        h = ("<s>",)
        return self._hist_index.get(h, 0)

    def _find(self, state: int, word: int):
        lo, hi = int(self.row_lo[state]), int(self.row_lo[state + 1])
        i = lo + int(np.searchsorted(self.col_word[lo:hi], word))
        if i < hi and self.col_word[i] == word:
            return i
        return -1

    def step(self, state: int, word: int) -> tuple[int, float]:
        """(next_state, cost) for emitting `word` from `state`, following
        backoffs for the probability (ref: const-arpa-lm.h GetNgramLogprob).

        The next state is the longest suffix of (history + word) that
        exists as a state, computed from the ORIGINAL history — an n-gram
        may be reachable even when its own history entry is missing
        (src/lm/missing_backoffs.arpa)."""
        cost = 0.0
        s = state
        while True:
            i = self._find(s, word)
            if i >= 0:
                cost += float(self.col_cost[i])
                if s == state:
                    # found at the FULL history: the packed next state is
                    # exactly the longest-suffix extension — fast path
                    return int(self.col_next[i]), cost
                break
            if s == 0:
                cost += self.unk_cost
                break
            cost += float(self.backoff_cost[s])
            s = int(self.backoff_state[s])
        ext = self._state_hist[state] + (word,)
        if self.order > 1:
            ext = ext[-(self.order - 1):]
        else:
            ext = ()
        # word ids in states are stored as symbol strings' ids; histories
        # were built over strings — map via the word column domain
        while ext not in self._ext_index:
            ext = ext[1:]
        return self._ext_index[ext], cost

    def final_cost(self, state: int) -> float:
        """Cost of </s> from `state`. </s> need not be in the word table
        (standard words.txt has no </s>): the internal sentinel id -2 is
        what the packed rows were built with in that case."""
        eos = self.eos if self.eos is not None else -2
        _s, c = self.step(state, eos)
        return c

    def sentence_logprob(self, word_ids) -> float:
        """Natural-log P(<s> words </s>) — parity oracle vs ArpaLm."""
        s = self.start_state()
        tot = 0.0
        for w in word_ids:
            s, c = self.step(s, int(w))
            tot -= c
        tot -= self.final_cost(s)
        return tot



    # ---------------- vectorized batch queries ----------------

    def _batch_tables(self):
        """Lazy tables for step_batch: global composite (state, word)
        entry keys (entries are grouped by state and word-sorted within,
        so the composite key array is globally ascending), plus per-state
        history suffix columns for vectorized next-state resolution."""
        if hasattr(self, "_ent_key"):
            return
        n = self.num_states
        deg = np.diff(self.row_lo)
        ent_state = np.repeat(np.arange(n, dtype=np.int64), deg)
        W = int(self.col_word.max(initial=0)) + 4
        self._wspan = W
        self._ent_key = ent_state * W + (self.col_word + 3)
        # per-state last-(order-2) history words, padded with -3
        K = max(self.order - 1, 1)
        hist_pad = np.full((n, K), -3, np.int64)
        for s, h in enumerate(self._state_hist):
            for j, w in enumerate(h[-K:][::-1]):
                hist_pad[s, j] = w     # column j = j-th-from-last word
        self._hist_pad = hist_pad
        # ext index tables by tuple length: sorted positional-key arrays
        tabs = {}
        for ids, s in self._ext_index.items():
            L = len(ids)
            key = 0
            for w in ids:
                key = key * W + (w + 3)
            tabs.setdefault(L, []).append((key, s))
        self._ext_tabs = {}
        for L, rows in tabs.items():
            rows.sort()
            self._ext_tabs[L] = (
                np.array([k for k, _s in rows], np.int64),
                np.array([s for _k, s in rows], np.int64))

    # ---------------- the batch queries on a device ----------------

    def device_tables(self, device="cuda") -> dict:
        """The tables of `step_batch` on `device` ("cuda" by default),
        moved there once per device and cached: the composite entry keys,
        the cost and next-state columns, the backoff columns, the history
        suffix pads and the extension tables by length."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        cache = self.__dict__.setdefault("_device_cache", {})
        tabs = cache.get(dev)
        if tabs is None:
            self._batch_tables()

            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=dev)
            tabs = dict(device=dev, ent_key=t(self._ent_key),
                        col_cost=t(self.col_cost), col_next=t(self.col_next),
                        backoff_cost=t(self.backoff_cost),
                        backoff_state=t(self.backoff_state),
                        hist_pad=t(self._hist_pad),
                        ext={L: (t(k), t(v))
                             for L, (k, v) in self._ext_tabs.items()})
            cache[dev] = tabs
        return tabs

    @staticmethod
    def table_bytes(tabs: dict) -> int:
        """Bytes that `device_tables` holds on its device."""
        n = sum(v.numel() * v.element_size() for v in tabs.values()
                if isinstance(v, torch.Tensor))
        return n + sum(k.numel() * k.element_size()
                       + v.numel() * v.element_size()
                       for k, v in tabs["ext"].values())

    def step_tensors(self, tabs: dict, states, words):
        """`step_batch` on tensors already on the tables' device: int64
        states and words [N] -> (next_states int64 [N], costs f64 [N]) on
        that device, without a host sync. Every query runs all `order + 1`
        rounds under masks (JAX's early exits only skip rounds in which no
        query is active), so the costs gather the same f32 column values
        into the same f64 sums in the same order as JAX's."""
        states = states.to(torch.int64)
        words = words.to(torch.int64)
        W = self._wspan
        ent = tabs["ent_key"]
        nE = ent.numel()
        cost = torch.zeros(states.shape, dtype=torch.float64,
                           device=states.device)
        nxt = torch.zeros_like(states)
        s = states
        active = torch.ones_like(states, dtype=torch.bool)
        # out-of-domain words take the impossible key -1: they would alias
        # into a neighbouring state's key range (JAX's guard, kept)
        in_dom = (words + 3 >= 0) & (words + 3 < W)
        for level in range(self.order + 1):
            q = torch.where(in_dom, s * W + (words + 3), -1)
            pos = torch.searchsorted(ent, q).clamp_(max=nE - 1)
            hit = active & (ent[pos] == q)
            cost = torch.where(hit, cost + tabs["col_cost"][pos].double(),
                               cost)
            if level == 0:
                # found at the full history: the packed next state is exact
                nxt = torch.where(hit, tabs["col_next"][pos], nxt)
                resolved = hit
            active = active & ~hit
            dead = active & (s == 0)
            cost = torch.where(dead, cost + float(self.unk_cost), cost)
            active = active & ~dead
            cost = torch.where(active, cost
                               + tabs["backoff_cost"][s].double(), cost)
            s = torch.where(active, tabs["backoff_state"][s], s)
        # next state of backed-off and unk queries: the longest suffix of
        # (original history + word) that is a state
        K = max(self.order - 1, 1)
        hp = tabs["hist_pad"][states]                   # [N, K]
        res = torch.zeros_like(states)
        need = ~resolved
        for L in range(min(self.order - 1, K), 0, -1):
            if L not in tabs["ext"]:
                continue
            keys, vals = tabs["ext"][L]
            k = torch.zeros_like(states)
            ok = need
            for j in range(L - 1, 0, -1):
                hw = hp[:, j - 1]
                ok = ok & (hw != -3)
                k = k * W + (hw + 3)
            k = torch.where(in_dom, k * W + (words + 3), -1)
            p = torch.searchsorted(keys, k).clamp_(max=keys.numel() - 1)
            h2 = ok & (keys[p] == k)
            res = torch.where(h2 & need, vals[p], res)
            need = need & ~h2
        res = torch.where(need, 0, res)
        return torch.where(resolved, nxt, res), cost

    def step_batch(self, states, words, device="cuda"):
        """Vectorized step(): states [N] int, words [N] int ->
        (next_states [N] int64, costs [N] float64) as numpy arrays,
        computed on `device` (the card by default). Semantics identical
        to step() and to JAX's step_batch, costs bit for bit (asserted in
        tests)."""
        tabs = self.device_tables(device)
        dev = tabs["device"]
        nxt, cost = self.step_tensors(
            tabs, torch.as_tensor(np.asarray(states, np.int64), device=dev),
            torch.as_tensor(np.asarray(words, np.int64), device=dev))
        return nxt.cpu().numpy(), cost.cpu().numpy()

    def final_cost_batch(self, states, device="cuda"):
        eos = self.eos if self.eos is not None else -2
        _n, c = self.step_batch(states, np.full(len(states), eos, np.int64),
                                device=device)
        return c


def lattice_lmrescore_const_arpa(lat: Lattice, lm: ConstArpaLm,
                                 lm_scale: float = 1.0) -> Lattice:
    """Compose a lattice with the deterministic on-demand LM, adding
    lm_scale * lm_cost to graph costs (ref:
    latbin/lattice-lmrescore-const-arpa.cc; lm/const-arpa-lm.h:202).

    Run once with lm_scale=-1 against the old G to subtract its scores
    first, exactly like the reference pipeline.
    """
    from collections import deque

    out = Lattice()
    if lat.num_states == 0 or lat.start < 0:
        return out
    state_map: dict = {}
    queue: deque = deque()

    def get_state(key):
        s = state_map.get(key)
        if s is None:
            s = out.add_state()
            state_map[key] = s
            queue.append(key)
        return s

    out.start = get_state((lat.start, lm.start_state()))
    while queue:
        key = queue.popleft()
        ls, ms = key
        cur = state_map[key]
        if ls in lat.finals:
            g, a = lat.finals[ls]
            out.set_final(cur, g + lm_scale * lm.final_cost(ms), a)
        for arc in lat.arcs[ls]:
            if arc.olabel == 0:
                dst = get_state((arc.nextstate, ms))
                out.add_arc(cur, arc.ilabel, 0, arc.graph_cost,
                            arc.acoustic_cost, dst)
            else:
                nms, c = lm.step(ms, arc.olabel)
                dst = get_state((arc.nextstate, nms))
                out.add_arc(cur, arc.ilabel, arc.olabel,
                            arc.graph_cost + lm_scale * c,
                            arc.acoustic_cost, dst)
            if hasattr(arc, "tids"):
                out.arcs[cur][-1].tids = arc.tids  # type: ignore
    return out.connect()


# lattices and BFS levels of the batch rescorer, its host syncs, its
# output arcs, and the lattices it handed to the scalar rescorer (not
# topologically sorted); the caller resets the counts
stats = dict(lattices=0, levels=0, syncs=0, arcs=0, scalar=0)


def lattice_lmrescore_const_arpa_batch(lat: Lattice, lm: ConstArpaLm,
                                       lm_scale: float = 1.0,
                                       device="cuda") -> Lattice:
    """Vectorized lattice_lmrescore_const_arpa for TOPOLOGICALLY-SORTED
    lattices (every arc src < dst — the decoder's raw-lattice invariant):
    level-synchronous BFS over (lattice-state, lm-state) pairs with
    step_batch doing the LM math in bulk, on `device` (the card by
    default). Produces JAX's lattice array for array (see
    `lattice_lmrescore_const_arpa_many`); a lattice that is not
    topologically sorted goes to the scalar rescorer, as in JAX."""
    return lattice_lmrescore_const_arpa_many([lat], lm, lm_scale, device)[0]


def lattice_lmrescore_const_arpa_many(lats, lm: ConstArpaLm,
                                      lm_scale: float = 1.0,
                                      device="cuda") -> list:
    """`lattice_lmrescore_const_arpa_batch` of every lattice in `lats`,
    the lattices' BFS levels run together on `device` (the card by
    default): one host sync per level of the deepest lattice, not per
    level of each. Each lattice comes out as JAX's batch rescorer makes
    it: within a level its new (state, LM state) pairs take the next ids
    in ascending key order, a pair seen at an earlier level keeps its id
    (a sorted tensor of the keys seen so far stands in for JAX's dict:
    membership by searchsorted, new ids by a cumsum per lattice), its arcs
    follow the level and frontier order, its finals the sorted keys. Keys
    are global state * M + LM state over the lattices' states laid end to
    end, so the sorted keys of one lattice are contiguous and in its own
    key order. Lattices that are empty or not topologically sorted take
    JAX's paths (the scalar one counted in `stats["scalar"]`)."""
    out: list = [None] * len(lats)
    todo = []
    for k, lat in enumerate(lats):
        if lat.num_states == 0 or lat.start < 0:
            out[k] = Lattice()
            continue
        arrays = lat.to_arrays()
        if not (arrays[1] < arrays[6]).all():
            stats["scalar"] += 1
            out[k] = lattice_lmrescore_const_arpa(lat, lm, lm_scale)
            continue
        todo.append((k, lat, arrays))
    if not todo:
        return out
    tabs = lm.device_tables(device)
    dev = tabs["device"]
    M = lm.num_states
    L = len(todo)
    n_st = np.array([a[0] for _k, _l, a in todo], np.int64)
    off = np.zeros(L + 1, np.int64)
    np.cumsum(n_st, out=off[1:])
    if (int(off[-1]) + 1) * M >= 2 ** 63:
        raise ValueError("lattice states x LM states overflow int64 keys")
    # the lattices laid end to end: CSR over their arcs by global src
    src = np.concatenate([a[1] + off[i] for i, (_k, _l, a) in
                          enumerate(todo)])
    counts = np.bincount(src, minlength=int(off[-1]))
    a_start = np.zeros(int(off[-1]) + 1, np.int64)
    np.cumsum(counts, out=a_start[1:])

    def t(parts, dtype):
        return torch.as_tensor(np.concatenate(
            [np.asarray(x, dtype) for x in parts]), device=dev)
    a_st = torch.as_tensor(a_start, device=dev)
    il_t = t([a[2] for _k, _l, a in todo], np.int64)
    ol_t = t([a[3] for _k, _l, a in todo], np.int64)
    gc_t = t([a[4] for _k, _l, a in todo], np.float64)
    ac_t = t([a[5] for _k, _l, a in todo], np.float64)
    dst_t = t([a[6] + off[i] for i, (_k, _l, a) in enumerate(todo)],
              np.int64)
    state_lat = torch.as_tensor(np.repeat(np.arange(L), n_st), device=dev)
    starts = off[:-1] + np.array([lat.start for _k, lat, _a in todo])
    frontier = torch.as_tensor(starts * M + lm.start_state(), device=dev)
    frontier_ids = torch.zeros(L, dtype=torch.int64, device=dev)
    seen, seen_ids = frontier, frontier_ids
    n_pairs = torch.ones(L, dtype=torch.int64, device=dev)
    n_front, tot = L, int(counts[starts].sum())
    outs = []
    while n_front and tot:
        gs, ms = frontier // M, frontier % M
        deg = a_st[gs + 1] - a_st[gs]
        tok = torch.repeat_interleave(
            torch.arange(n_front, device=dev), deg, output_size=tot)
        arc = (a_st[gs] - (torch.cumsum(deg, 0) - deg))[tok] + \
            torch.arange(tot, device=dev)
        w_arc = ol_t[arc]
        is_word = w_arc != 0
        ms_tok = ms[tok]
        nn, cc = lm.step_tensors(tabs, ms_tok, w_arc)
        nms = torch.where(is_word, nn, ms_tok)
        add_c = torch.where(is_word, cc, 0.0)
        nkey = dst_t[arc] * M + nms
        # ids: JAX's np.unique order within the level, its dict across
        # levels (found keys keep their id, new ones count up from each
        # lattice's n_pairs)
        sk, perm = torch.sort(nkey, stable=True)
        first = torch.ones_like(sk, dtype=torch.bool)
        first[1:] = sk[1:] != sk[:-1]
        pos = torch.searchsorted(seen, sk).clamp_(max=seen.numel() - 1)
        found = seen[pos] == sk
        new = first & ~found
        lat_k = state_lat[sk // M]
        per_lat = torch.zeros_like(n_pairs).scatter_add_(0, lat_k,
                                                         new.long())
        cnew = torch.cumsum(new, 0)
        rank = cnew - (torch.cumsum(per_lat, 0) - per_lat)[lat_k]
        uid_sorted = torch.where(found, seen_ids[pos],
                                 n_pairs[lat_k] + rank - 1)
        uid = torch.empty_like(uid_sorted).scatter_(0, perm, uid_sorted)
        outs.append((state_lat[gs][tok], frontier_ids[tok], il_t[arc],
                     w_arc, gc_t[arc] + lm_scale * add_c, ac_t[arc], uid))
        n_pairs = n_pairs + per_lat
        ndeg = torch.where(new, a_st[sk // M + 1] - a_st[sk // M], 0)
        # the level's one host sync: the next frontier's length and arcs
        n_new, tot = (int(v) for v in
                      torch.stack([cnew[-1], ndeg.sum()]).cpu())
        stats["levels"] += 1
        stats["syncs"] += 1
        # the new keys and their ids, compacted in order without a sync
        slot = torch.where(new, cnew - 1, n_new)
        frontier = torch.empty(n_new + 1, dtype=torch.int64,
                               device=dev).scatter_(0, slot, sk)[:n_new]
        frontier_ids = torch.empty(n_new + 1, dtype=torch.int64,
                                   device=dev).scatter_(
            0, slot, uid_sorted)[:n_new]
        # merge them into the sorted keys seen so far
        at_new = torch.searchsorted(seen, frontier) + \
            torch.arange(n_new, device=dev)
        at_old = torch.searchsorted(frontier, seen) + \
            torch.arange(seen.numel(), device=dev)
        merged = torch.empty(seen.numel() + n_new, dtype=torch.int64,
                             device=dev)
        merged_ids = torch.empty_like(merged)
        merged.scatter_(0, at_old, seen).scatter_(0, at_new, frontier)
        merged_ids.scatter_(0, at_old, seen_ids).scatter_(0, at_new,
                                                          frontier_ids)
        seen, seen_ids = merged, merged_ids
        n_front = n_new
    # finals: every pair whose lattice state is final, in key order
    fin_g = np.concatenate([np.array(sorted(lat.finals), np.int64) + off[i]
                            for i, (_k, lat, _a) in enumerate(todo)])
    fi = torch.nonzero(torch.isin(seen // M, torch.as_tensor(
        fin_g, device=dev))).flatten()
    fk = seen[fi]
    _n, fcost = lm.step_tensors(tabs, fk % M, torch.full_like(
        fk, lm.eos if lm.eos is not None else -2))
    fin = [dict() for _ in range(L)]
    for i_, gs_, c_ in zip(seen_ids[fi].tolist(), (fk // M).tolist(),
                           fcost.tolist()):
        li = int(np.searchsorted(off, gs_, side="right")) - 1
        g, a = todo[li][1].finals[gs_ - int(off[li])]
        fin[li][int(i_)] = (g + lm_scale * float(c_), a)
    n_pairs = n_pairs.cpu().numpy()
    stats["syncs"] += 3
    stats["lattices"] += L
    if outs:
        cols = [torch.cat(c) for c in zip(*outs)]
        ints = torch.stack([cols[0], cols[1], cols[2], cols[3],
                            cols[6]]).cpu().numpy()
        flts = torch.stack([cols[4], cols[5]]).cpu().numpy()
        stats["syncs"] += 2
    else:
        ints, flts = np.zeros((5, 0), np.int64), np.zeros((2, 0))
    order = np.argsort(ints[0], kind="stable")
    bounds = np.searchsorted(ints[0][order], np.arange(L + 1))
    for li, (k, lat, a) in enumerate(todo):
        sel = order[bounds[li]: bounds[li + 1]]
        o_src, o_il, o_ol, o_dst = ints[1:][:, sel]
        stats["arcs"] += len(sel)
        out[k] = _connected(int(n_pairs[li]), o_src, o_il.astype(a[2].dtype),
                            o_ol.astype(a[3].dtype), flts[0][sel],
                            flts[1][sel], o_dst, fin[li])
    return out


def _connected(n: int, src, il, ol, gc, ac, dst, finals: dict) -> Lattice:
    """`Lattice.from_arrays(n, ..., start=0, finals).connect()` on the
    arrays: every pair the BFS made is reachable from pair 0, so connect()
    keeps the pairs that reach a final (found by a reverse BFS over the
    arcs), renumbers them in order and drops the arcs that leave them;
    the arcs of a state keep their order and the finals theirs. The same
    lattice, array for array, without a Python object per arc."""
    coacc = np.zeros(n, bool)
    frontier = np.array(sorted(finals), np.int64)
    coacc[frontier] = True
    order = np.argsort(dst, kind="stable")
    rstart = np.searchsorted(dst[order], np.arange(n + 1))
    while frontier.size:
        cnt = rstart[frontier + 1] - rstart[frontier]
        tot = int(cnt.sum())
        if not tot:
            break
        base = np.repeat(rstart[frontier] - (np.cumsum(cnt) - cnt), cnt)
        preds = src[order[base + np.arange(tot)]]
        frontier = np.unique(preds[~coacc[preds]])
        coacc[frontier] = True
    remap = np.full(n, -1, np.int64)
    remap[coacc] = np.arange(int(coacc.sum()))
    m = coacc[src] & coacc[dst]
    return Lattice.from_arrays(
        int(coacc.sum()), remap[src[m]], il[m], ol[m], gc[m], ac[m],
        remap[dst[m]], start=int(remap[0]) if n and coacc[0] else -1,
        finals={int(remap[s]): w for s, w in finals.items() if coacc[s]})
