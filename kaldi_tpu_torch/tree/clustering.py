"""Gaussian sufficient-statistics clustering.

(ref: tree/clusterable-classes.h:69 GaussClusterable — objf :193-217 is the
 diagonal-Gaussian data likelihood at the ML mean/var; tree/cluster-utils.h
 ClusterBottomUp :109, ClusterKMeans :203, TreeCluster :252.)

Stats are plain numpy triples; all objf math is vectorized so distances for
candidate merges evaluate in batch.

The port's copy of kaldi_tpu/tree/clustering.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

M_LOG_2PI = math.log(2 * math.pi)


class GaussStats:
    """(count, x-sum [D], x2-sum [D]) with the reference objective."""

    __slots__ = ("count", "x", "x2", "var_floor")

    def __init__(self, dim: int | None = None, count=0.0, x=None, x2=None,
                 var_floor: float = 0.01):
        self.count = float(count)
        self.x = np.zeros(dim) if x is None else np.asarray(x, np.float64)
        self.x2 = np.zeros(dim) if x2 is None else np.asarray(x2, np.float64)
        self.var_floor = var_floor

    def accumulate(self, frame: np.ndarray, weight: float = 1.0):
        self.count += weight
        self.x += weight * frame
        self.x2 += weight * frame * frame

    def add(self, other: "GaussStats") -> "GaussStats":
        return GaussStats(count=self.count + other.count,
                          x=self.x + other.x, x2=self.x2 + other.x2,
                          var_floor=self.var_floor)

    def copy(self):
        return GaussStats(count=self.count, x=self.x.copy(),
                          x2=self.x2.copy(), var_floor=self.var_floor)

    def objf(self) -> float:
        """(ref: clusterable-classes.cc:193 GaussClusterable::Objf)"""
        if self.count <= 0:
            return 0.0
        mean = self.x / self.count
        var = self.x2 / self.count - mean * mean
        floored = np.maximum(var, self.var_floor)
        per_frame = (-0.5 * np.sum(var / floored)
                     - 0.5 * (np.sum(np.log(floored))
                              + M_LOG_2PI * len(var)))
        if np.isnan(per_frame):
            return 0.0
        return float(per_frame * self.count)

    def distance(self, other: "GaussStats") -> float:
        """objf loss from merging (>= 0)."""
        return self.objf() + other.objf() - self.add(other).objf()

    def mean(self):
        return self.x / max(self.count, 1e-10)


def sum_stats(stats: list[GaussStats]) -> GaussStats:
    assert stats
    out = stats[0].copy()
    for s in stats[1:]:
        out.count += s.count
        out.x += s.x
        out.x2 += s.x2
    return out


def objf_given_sum(stats: list[GaussStats]) -> float:
    return sum_stats(stats).objf() if stats else 0.0


def cluster_bottom_up(stats: list[GaussStats], thresh: float = 1e30,
                      min_clust: int = 1):
    """Greedy agglomerative merge (ref: cluster-utils.h:109 ClusterBottomUp).

    -> (clusters [list of GaussStats], assignments [len(stats)])
    """
    n = len(stats)
    clusters = [s.copy() for s in stats]
    parent = list(range(n))
    alive = [True] * n
    heap = []
    for i in range(n):
        for j in range(i + 1, n):
            heapq.heappush(heap, (stats[i].distance(stats[j]), i, j))
    n_alive = n
    version = {i: 0 for i in range(n)}
    cur_version = [0] * n
    while n_alive > min_clust and heap:
        d, i, j = heapq.heappop(heap)
        if not (alive[i] and alive[j]):
            continue
        # recompute distance (lazy heap; stale entries possible after merges)
        d2 = clusters[i].distance(clusters[j])
        if d2 > d + 1e-9:
            heapq.heappush(heap, (d2, i, j))
            continue
        if d2 > thresh:
            break
        clusters[i] = clusters[i].add(clusters[j])
        alive[j] = False
        parent[j] = i
        n_alive -= 1
        for k in range(n):
            if alive[k] and k != i:
                a, b = min(i, k), max(i, k)
                heapq.heappush(heap, (clusters[a].distance(clusters[b]), a, b))
    # compress assignments
    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i
    remap = {}
    out_clusters = []
    assign = []
    for i in range(n):
        r = find(i)
        if r not in remap:
            remap[r] = len(out_clusters)
            out_clusters.append(clusters[r])
        assign.append(remap[r])
    return out_clusters, assign


def cluster_kmeans(stats: list[GaussStats], num_clust: int,
                   num_iters: int = 20, seed: int = 0):
    """K-means-style refinement over clusterables
    (ref: cluster-utils.h:203 ClusterKMeans).
    """
    rng = np.random.RandomState(seed)
    n = len(stats)
    num_clust = min(num_clust, n)
    assign = list(rng.randint(0, num_clust, n))
    # ensure nonempty clusters
    for c in range(num_clust):
        assign[c % n] = c
    for _it in range(num_iters):
        clusters = [None] * num_clust
        for i, c in enumerate(assign):
            clusters[c] = stats[i] if clusters[c] is None else clusters[c].add(stats[i])
        changed = 0
        for i in range(n):
            c_old = assign[i]
            # removal objf delta + insertion delta for each candidate
            best_c, best_delta = c_old, 0.0
            base = clusters[c_old]
            for c in range(num_clust):
                if c == c_old or clusters[c] is None:
                    continue
                # delta = objf change if i moves from c_old to c
                minus = GaussStats(count=base.count - stats[i].count,
                                   x=base.x - stats[i].x,
                                   x2=base.x2 - stats[i].x2,
                                   var_floor=base.var_floor)
                delta = (minus.objf() + clusters[c].add(stats[i]).objf()
                         - base.objf() - clusters[c].objf())
                if delta > best_delta + 1e-9:
                    best_delta = delta
                    best_c = c
            if best_c != c_old:
                clusters[best_c] = clusters[best_c].add(stats[i])
                clusters[c_old] = GaussStats(
                    count=clusters[c_old].count - stats[i].count,
                    x=clusters[c_old].x - stats[i].x,
                    x2=clusters[c_old].x2 - stats[i].x2,
                    var_floor=stats[i].var_floor)
                assign[i] = best_c
                changed += 1
        if changed == 0:
            break
    clusters = [None] * num_clust
    for i, c in enumerate(assign):
        clusters[c] = stats[i] if clusters[c] is None else clusters[c].add(stats[i])
    keep = [c for c in range(num_clust) if clusters[c] is not None]
    remap = {c: k for k, c in enumerate(keep)}
    return [clusters[c] for c in keep], [remap[c] for c in assign]


def tree_cluster(stats: list[GaussStats], max_clust: int,
                 thresh: float = 0.0, branch_factor: int = 2, seed: int = 0):
    """Top-down binary clustering -> (assignments, tree of index sets).

    (ref: cluster-utils.h:252 TreeCluster — used for automatic question
    generation: every tree node's member set is a question.)
    Returns (leaf_assign, node_sets) where node_sets is a list of index
    lists, one per tree node (root first).
    """
    n = len(stats)
    node_sets: list[list[int]] = []

    def rec(indices: list[int], budget: int):
        node_sets.append(list(indices))
        if budget <= 1 or len(indices) <= 1:
            return [indices]
        sub = [stats[i] for i in indices]
        clusters, assign = cluster_kmeans(sub, 2, seed=seed + len(node_sets))
        if len(clusters) < 2:
            return [indices]
        g0 = [indices[i] for i, a in enumerate(assign) if a == 0]
        g1 = [indices[i] for i, a in enumerate(assign) if a == 1]
        if not g0 or not g1:
            return [indices]
        # merge gain check
        merged = sum_stats(sub).objf()
        split_objf = (sum_stats([stats[i] for i in g0]).objf()
                      + sum_stats([stats[i] for i in g1]).objf())
        if split_objf - merged < thresh:
            return [indices]
        b0 = max(1, budget // 2)
        return rec(g0, b0) + rec(g1, budget - b0)

    leaves = rec(list(range(n)), max_clust)
    assign = [0] * n
    for li, idxs in enumerate(leaves):
        for i in idxs:
            assign[i] = li
    return assign, node_sets
