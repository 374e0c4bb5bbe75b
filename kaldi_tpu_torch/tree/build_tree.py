"""Decision-tree building: stats accumulation, questions, splitting,
leaf clustering.

(ref: tree/build-tree.h:82 BuildTree, tree/build-tree-utils.h
 SplitDecisionTree / ClusterEventMapRestrictedByMap / GetStubMap,
 tree/build-tree-questions.h, hmm/tree-accu.h:41 AccumulateTreeStats,
 bin/{acc-tree-stats,cluster-phones,compile-questions,build-tree}.cc.)

Stats: list of (event dict, GaussStats); event keys: -1 = pdf-class,
0..N-1 = context positions (phone ids, 0 = out-of-utterance boundary).

The port's copy of kaldi_tpu/tree/build_tree.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import heapq

import numpy as np

from kaldi_tpu_torch.tree.event_map import (
    EventMap, ConstantEventMap, TableEventMap, SplitEventMap, KPDF_CLASS,
    map_leaves,
)
from kaldi_tpu_torch.tree.clustering import GaussStats, sum_stats, tree_cluster


# ---------------------------------------------------------------------------
# stats accumulation (ref: hmm/tree-accu.cc AccumulateTreeStats)

def accumulate_tree_stats(
    feats: np.ndarray,           # [T, D]
    alignment: np.ndarray,       # [T] transition-ids
    trans_model,
    N: int = 3,
    P: int = 1,
    ci_phones: set | None = None,
    stats: dict | None = None,
    var_floor: float = 0.01,
) -> dict:
    """stats: dict event(frozenset of (k,v)) -> GaussStats. Splits the
    alignment into phone segments, builds the context window per segment."""
    ci_phones = ci_phones or set()
    stats = stats if stats is not None else {}
    T = len(alignment)
    phones = [trans_model.transition_id_to_phone(t) for t in alignment]
    pdf_classes = [trans_model.topo.entry(
        trans_model.transition_id_to_phone(t)
    )[trans_model.transition_id_to_hmm_state(t)].pdf_class for t in alignment]
    # segment boundaries: a new segment starts when the phone changes or a
    # new instance of the same phone begins — detected like ali_to_phones
    # (tid at hmm-state 0 that is not a self-loop), which also catches
    # back-to-back instances of 1-state phones where the hmm-state never
    # decreases (ref: hmm-utils.cc SplitToPhonesInternal)
    seg_start = [0]
    for t in range(1, T):
        new_phone = phones[t] != phones[t - 1]
        tid = int(alignment[t])
        # in reordered alignments the non-self-loop state-0 tid occurs
        # exactly once, at the first frame of each phone instance
        restart = (not new_phone
                   and trans_model.transition_id_to_hmm_state(tid) == 0
                   and not trans_model.is_self_loop(tid))
        if new_phone or restart:
            seg_start.append(t)
    seg_start.append(T)
    seg_phone = [phones[s] for s in seg_start[:-1]]
    D = feats.shape[1]
    for si in range(len(seg_start) - 1):
        lo, hi = seg_start[si], seg_start[si + 1]
        phone = seg_phone[si]
        window = []
        for pos in range(-P, N - P):
            j = si + pos
            if 0 <= j < len(seg_phone):
                window.append(seg_phone[j])
            else:
                window.append(0)
        if phone in ci_phones:
            window = [0] * P + [phone] + [0] * (N - P - 1)
        for t in range(lo, hi):
            ev = frozenset(
                [(KPDF_CLASS, pdf_classes[t])]
                + [(pos, window[pos]) for pos in range(N)]
            )
            st = stats.get(ev)
            if st is None:
                st = GaussStats(D, var_floor=var_floor)
                stats[ev] = st
            st.accumulate(feats[t])
    return stats


# ---------------------------------------------------------------------------
# questions

def obtain_questions(stats: dict, P: int = 1) -> list[list[int]]:
    """Cluster central phones by their acoustics; every cluster-tree node's
    phone set is a question (ref: bin/cluster-phones.cc + TreeCluster)."""
    by_phone: dict[int, GaussStats] = {}
    for ev, st in stats.items():
        d = dict(ev)
        phone = d[P]
        if phone == 0:
            continue
        if phone in by_phone:
            by_phone[phone] = by_phone[phone].add(st)
        else:
            by_phone[phone] = st.copy()
    phones = sorted(by_phone)
    plist = [by_phone[p] for p in phones]
    _assign, node_sets = tree_cluster(plist, max_clust=len(phones))
    questions = []
    seen = set()
    for idxs in node_sets:
        q = tuple(sorted(phones[i] for i in idxs))
        if q not in seen and len(q) > 0:
            seen.add(q)
            questions.append(list(q))
    # singletons too
    for p in phones:
        if (p,) not in seen:
            questions.append([p])
            seen.add((p,))
    return questions


class Questions:
    """Per-key question sets (ref: build-tree-questions.h QuestionsForKey)."""

    def __init__(self, phone_questions: list[list[int]],
                 num_pdf_classes: int = 3, N: int = 3, P: int = 1):
        self.by_key: dict[int, list[frozenset]] = {}
        pq = [frozenset(q) for q in phone_questions]
        for pos in range(N):
            self.by_key[pos] = pq
        # pdf-class questions: {0}, {0,1}, ... (ref: compile-questions.cc)
        self.by_key[KPDF_CLASS] = [
            frozenset(range(k + 1)) for k in range(num_pdf_classes - 1)
        ]

    def keys(self):
        return list(self.by_key)


# ---------------------------------------------------------------------------
# tree building

def _split_gain(stats_items, key, question: frozenset):
    """Objf gain from splitting these (event, stats) by question on key."""
    yes, no = None, None
    for ev, st in stats_items:
        v = dict(ev).get(key)
        if v is None:
            return None  # key undefined somewhere: can't split on it
        if v in question:
            yes = st if yes is None else yes.add(st)
        else:
            no = st if no is None else no.add(st)
    if yes is None or no is None:
        return None
    total = yes.add(no)
    return yes.objf() + no.objf() - total.objf()


def _find_best_split(stats_items, questions: Questions):
    best = (0.0, None, None)  # (gain, key, question)
    for key, qlist in questions.by_key.items():
        vals = {dict(ev).get(key) for ev, _ in stats_items}
        if None in vals or len(vals) <= 1:
            continue
        for q in qlist:
            # skip no-op questions
            inter = vals & q
            if not inter or inter == vals:
                continue
            gain = _split_gain(stats_items, key, q)
            if gain is not None and gain > best[0]:
                best = (gain, key, q)
    return best


def get_stub_map(P: int, phone_sets: list[list[int]],
                 phone2num_pdf_classes: dict,
                 share_roots: list[bool], counter: list[int]) -> EventMap:
    """Initial tree: one root per phone set; non-shared roots split by
    pdf-class (ref: build-tree-utils.cc GetStubMap)."""
    table = {}
    for pset, share in zip(phone_sets, share_roots):
        if share:
            leaf = ConstantEventMap(counter[0])
            counter[0] += 1
            for p in pset:
                table[p] = leaf
        else:
            for p in pset:
                sub = {}
                for c in range(phone2num_pdf_classes[p]):
                    sub[c] = ConstantEventMap(counter[0])
                    counter[0] += 1
                table[p] = TableEventMap(KPDF_CLASS, sub)
    return TableEventMap(P, table)


def build_tree_two_level(
    stats: dict,
    questions: "Questions",
    phone_sets: list[list[int]],
    phone2num_pdf_classes: dict,
    max_leaves_first: int,
    max_leaves_second: int,
    P: int = 1,
    thresh: float = 0.0,
    **kwargs,
):
    """Two-level tree: a fine tree of up to max_leaves_second leaves plus a
    mapping fine-leaf -> coarse-leaf over a coarse tree of up to
    max_leaves_first leaves (ref: build-tree.h:145 BuildTreeTwoLevel —
    used for multi-codebook/SGMM systems where fine states share coarse
    codebooks).

    Both levels use the same greedy splitting criterion; the mapping is
    derived by sending each fine leaf's event stats through the coarse
    tree and taking the count-weighted majority (the reference obtains the
    same mapping structurally by continuing to split the coarse tree).

    -> (fine_tree, num_fine, coarse_tree, num_coarse, fine2coarse [list]).
    """
    coarse, n_coarse = build_tree(
        stats, questions, phone_sets, phone2num_pdf_classes,
        max_leaves=max_leaves_first, thresh=thresh, P=P, **kwargs)
    fine, n_fine = build_tree(
        stats, questions, phone_sets, phone2num_pdf_classes,
        max_leaves=max_leaves_second, thresh=thresh, P=P, **kwargs)
    votes: list[dict] = [dict() for _ in range(n_fine)]
    for ev, st in stats.items():
        d = dict(ev)
        lf = fine.map(d)
        lc = coarse.map(d)
        if lf is None or lc is None:
            continue
        cnt = getattr(st, "count", 1.0)
        votes[lf][lc] = votes[lf].get(lc, 0.0) + float(cnt)
    fine2coarse = [max(v.items(), key=lambda kv: kv[1])[0] if v else 0
                   for v in votes]
    return fine, n_fine, coarse, n_coarse, fine2coarse


def build_tree(
    stats: dict,
    questions: Questions,
    phone_sets: list[list[int]],
    phone2num_pdf_classes: dict,
    share_roots: list[bool] | None = None,
    do_split: list[bool] | None = None,
    max_leaves: int = 1000,
    thresh: float = 300.0,
    cluster_thresh: float | None = None,
    P: int = 1,
):
    """-> (EventMap with contiguous leaf ids, num_leaves).

    (ref: build-tree.cc:135 BuildTree — stub, greedy splitting by best
    question, then bottom-up leaf clustering with RenumberEventMap.)
    """
    share_roots = share_roots or [True] * len(phone_sets)
    do_split = do_split or [True] * len(phone_sets)
    counter = [0]
    stub = get_stub_map(P, phone_sets, phone2num_pdf_classes, share_roots,
                        counter)
    num_leaves = counter[0]

    nosplit_phones = set()
    for pset, ds in zip(phone_sets, do_split):
        if not ds:
            nosplit_phones.update(pset)

    # group stats by stub leaf
    items = list(stats.items())
    by_leaf: dict[int, list] = {}
    for ev, st in items:
        d = dict(ev)
        if d.get(P) in nosplit_phones:
            continue
        leaf = stub.map(d)
        if leaf is None:
            continue
        by_leaf.setdefault(leaf, []).append((ev, st))

    # leaf -> its current EventMap node gets replaced on split; we build a
    # map leaf_id -> subtree and substitute into the stub at the end.
    subtree: dict[int, EventMap] = {}
    heap = []
    seq = 0

    def push(leaf_id, leaf_items):
        nonlocal seq
        gain, key, q = _find_best_split(leaf_items, questions)
        if key is not None and gain > thresh:
            heapq.heappush(heap, (-gain, seq, leaf_id, key, q, leaf_items))
            seq += 1

    for leaf, leaf_items in by_leaf.items():
        push(leaf, leaf_items)

    smallest_split = float("inf")
    leaf_alloc = [num_leaves]
    pending: dict[int, tuple] = {}  # leaf_id currently splittable

    while heap and num_leaves < max_leaves:
        neg_gain, _s, leaf_id, key, q, leaf_items = heapq.heappop(heap)
        gain = -neg_gain
        smallest_split = min(smallest_split, gain)
        yes_items = [(e, s) for (e, s) in leaf_items if dict(e)[key] in q]
        no_items = [(e, s) for (e, s) in leaf_items if dict(e)[key] not in q]
        yes_id = leaf_alloc[0]
        no_id = leaf_alloc[0] + 1
        leaf_alloc[0] += 2
        num_leaves += 1
        subtree[leaf_id] = (key, q, yes_id, no_id)
        by_leaf[yes_id] = yes_items
        by_leaf[no_id] = no_items
        push(yes_id, yes_items)
        push(no_id, no_items)

    # materialize the split trees: leaf id -> final EventMap
    def build_leaf(leaf_id) -> EventMap:
        entry = subtree.get(leaf_id)
        if entry is None:
            return ConstantEventMap(leaf_id)
        key, q, yes_id, no_id = entry
        return SplitEventMap(key, frozenset(q),
                             build_leaf(yes_id), build_leaf(no_id))

    tree = map_leaves(stub, lambda leaf: leaf)  # copy
    tree = _replace_leaves(tree, build_leaf)

    # leaf clustering (merge leaves under the same stub root whose merge
    # costs < cluster_thresh); cluster_thresh < 0 means "use the smallest
    # split gain actually taken" (ref: build-tree.cc BuildTree
    # cluster_thresh==-1 convention)
    if cluster_thresh is None:
        cluster_thresh = thresh
    if cluster_thresh < 0:
        cluster_thresh = (smallest_split
                          if smallest_split < float("inf") else 0.0)
    if cluster_thresh > 0:
        tree, num_leaves = _cluster_leaves(tree, stub, stats, cluster_thresh,
                                           leaf_alloc[0])
    else:
        tree, num_leaves = _renumber(tree)
    return tree, num_leaves


def _replace_leaves(em: EventMap, fn) -> EventMap:
    if isinstance(em, ConstantEventMap):
        return fn(em.answer)
    if isinstance(em, TableEventMap):
        return TableEventMap(em.key, {v: _replace_leaves(m, fn)
                                      for v, m in em.table.items()})
    if isinstance(em, SplitEventMap):
        return SplitEventMap(em.key, em.yes_set,
                             _replace_leaves(em.yes, fn),
                             _replace_leaves(em.no, fn))
    raise TypeError(type(em))


def _cluster_leaves(tree: EventMap, stub: EventMap, stats: dict,
                    thresh: float, num_ids: int):
    """Bottom-up merge of leaves sharing a stub root
    (ref: build-tree-utils.cc ClusterEventMapRestrictedByMap)."""
    from kaldi_tpu_torch.tree.clustering import cluster_bottom_up

    leaf_stats: dict[int, GaussStats] = {}
    leaf_root: dict[int, int] = {}
    for ev, st in stats.items():
        d = dict(ev)
        leaf = tree.map(d)
        root = stub.map(d)
        if leaf is None:
            continue
        if leaf in leaf_stats:
            leaf_stats[leaf] = leaf_stats[leaf].add(st)
        else:
            leaf_stats[leaf] = st.copy()
            leaf_root[leaf] = root
    merge_map: dict[int, int] = {}
    by_root: dict[int, list[int]] = {}
    for leaf, root in leaf_root.items():
        by_root.setdefault(root, []).append(leaf)
    for root, leaves in by_root.items():
        if len(leaves) <= 1:
            continue
        cl, assign = cluster_bottom_up([leaf_stats[l] for l in leaves],
                                       thresh=thresh)
        reps: dict[int, int] = {}
        for leaf, a in zip(leaves, assign):
            if a in reps:
                merge_map[leaf] = reps[a]
            else:
                reps[a] = leaf
    merged = map_leaves(tree, lambda l: merge_map.get(l, l))
    return _renumber(merged)


def _renumber(tree: EventMap):
    from kaldi_tpu_torch.tree.event_map import collect_leaves
    leaves = sorted(set(collect_leaves(tree)))
    remap = {l: i for i, l in enumerate(leaves)}
    return map_leaves(tree, lambda l: remap[l]), len(leaves)
