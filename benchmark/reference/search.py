"""Plain reference of best-path beam search over an HCLG in CSR arrays,
and the cost of a given path under given log-likelihoods.

`beam_search` is Kaldi's token passing (decoder/faster-decoder.cc) written
out in plain PyTorch, batched over utterances: per frame every alive
token takes each emitting arc of its state (cost + graph cost - scale *
loglike of the arc's pdf), the best token per state survives, tokens
more than `beam` above the frame's best are dropped and at most
`max_active` kept, then eps arcs are followed until nothing improves.
The utterance's result is its best token with the final cost added, or
its best token when none is final; its words and transition ids come
from back-pointers. Costs are f64.

`path_cost` is the least cost of any path through the graph that emits
exactly the given transition ids, one per frame, and outputs exactly the
given words: the score the reference gives to the program's answer. With
`need_final`, only paths that end in a final state count.

Graph arrays (numpy): "arc_start" [S+1], "ilabel", "olabel", "cost",
"nextstate", "pdf" [A], "final" [S] (inf where not final), "start".
Emitting arcs come before eps arcs within each state. Nothing of the
program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class DeviceGraph:
    """The graph's arrays on `device` with each state's emitting and eps
    arc ranges."""

    def __init__(self, g: dict, device):
        def t(x, dt):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

        self.S = len(g["final"])
        starts = np.asarray(g["arc_start"], np.int64)
        il = np.asarray(g["ilabel"])
        deg = np.diff(starts)
        src = np.repeat(np.arange(self.S), deg)
        n_emit = np.bincount(src[il > 0], minlength=self.S)
        self.a0 = t(starts[:-1], torch.int64)
        self.n_emit = t(n_emit, torch.int64)
        self.n_eps = t(deg - n_emit, torch.int64)
        self.ilabel = t(il, torch.int64)
        self.olabel = t(g["olabel"], torch.int64)
        self.cost = t(g["cost"], torch.float64)
        self.nextstate = t(g["nextstate"], torch.int64)
        self.pdf = t(np.maximum(np.asarray(g["pdf"]), 0), torch.int64)
        self.final = t(g["final"], torch.float64)
        self.start = int(g["start"])
        self.device = device


def _expand(first, count):
    """Arc ids first[i] .. first[i] + count[i] - 1 for every i, and the i
    each came from."""
    src = torch.repeat_interleave(torch.arange(len(first),
                                               device=first.device), count)
    off = torch.cumsum(count, 0) - count
    return first[src] + torch.arange(len(src), device=first.device) \
        - off[src], src


def _best_per_key(key, cost):
    """Index of the least-cost entry of each distinct key (ties: the
    lowest index)."""
    uniq, inv = torch.unique(key, return_inverse=True)
    best = torch.full((len(uniq),), math.inf, dtype=cost.dtype,
                      device=cost.device)
    best.scatter_reduce_(0, inv, cost, "amin")
    hit = cost == best[inv]
    idx = torch.full((len(uniq),), len(key), dtype=torch.int64,
                     device=key.device)
    ar = torch.arange(len(key), device=key.device)
    idx.scatter_reduce_(0, inv[hit], ar[hit], "amin")
    return idx


def _prune(u, c, beam, max_active, n_utt):
    """Keep the entries within `beam` of their utterance's best and at
    most `max_active` per utterance (the best ones). -> kept indices."""
    best = torch.full((n_utt,), math.inf, dtype=c.dtype, device=c.device)
    best.scatter_reduce_(0, u, c, "amin")
    keep = torch.nonzero(c <= best[u] + beam)[:, 0]
    uk, ck = u[keep], c[keep]
    order = torch.argsort(ck, stable=True)
    order = order[torch.argsort(uk[order], stable=True)]
    cnt = torch.bincount(uk, minlength=n_utt)
    first = torch.cumsum(cnt, 0) - cnt
    ranked = keep[order]
    rank = torch.arange(len(order), device=c.device) - first[uk[order]]
    return ranked[rank < max_active]


def beam_search(graph: DeviceGraph, loglikes: list, beam: float,
                max_active: int, acoustic_scale: float,
                max_eps_rounds: int = 4) -> list:
    """loglikes: per utterance a [T, P] tensor on the graph's device.
    -> per utterance (words, tids, cost)."""
    dev, S = graph.device, graph.S
    U = len(loglikes)
    lens = torch.as_tensor([len(x) for x in loglikes], device=dev)
    Tmax = int(lens.max())
    P = loglikes[0].shape[1]
    ll = torch.zeros((U, Tmax, P), dtype=torch.float64, device=dev)
    for i, x in enumerate(loglikes):
        ll[i, : len(x)] = x.to(torch.float64)
    ll = ll * acoustic_scale
    # token lists: one per frame and eps round; each entry points into the
    # list before it (bp) and carries the labels of the arc it took
    lists = []          # (u, bp, il, ol)
    u = torch.arange(U, device=dev)
    s = torch.full((U,), graph.start, dtype=torch.int64, device=dev)
    c = torch.zeros(U, dtype=torch.float64, device=dev)
    zeros = torch.zeros(U, dtype=torch.int64, device=dev)
    lists.append((u, torch.full((U,), -1, dtype=torch.int64, device=dev),
                  zeros, zeros))
    ends = {}           # utterance -> (list index, entry index, cost)

    def eps_rounds(u, s, c):
        for _ in range(max_eps_rounds):
            arcs, src = _expand(graph.a0[s] + graph.n_emit[s],
                                graph.n_eps[s])
            if len(arcs) == 0:
                break
            eu, es = u[src], graph.nextstate[arcs]
            ec = c[src] + graph.cost[arcs]
            n = len(u)
            key = torch.cat([u * S + s, eu * S + es])
            cc = torch.cat([c, ec])
            keep = _best_per_key(key, cc)
            keep = keep[_prune(torch.cat([u, eu])[keep], cc[keep], beam,
                               max_active, U)]
            if bool((keep < n).all()) and len(keep) == n:
                break
            from_eps = keep >= n
            bp = torch.where(from_eps, src[(keep - n).clamp(min=0)], keep)
            ol = torch.where(from_eps, graph.olabel[arcs[(keep - n)
                                                         .clamp(min=0)]], 0)
            u = torch.cat([u, eu])[keep]
            s = torch.cat([s, es])[keep]
            c = cc[keep]
            lists.append((u, bp, torch.zeros_like(bp), ol))
        return u, s, c

    u, s, c = eps_rounds(u, s, c)
    for t in range(Tmax):
        arcs, src = _expand(graph.a0[s], graph.n_emit[s])
        eu = u[src]
        ec = c[src] + graph.cost[arcs] - ll[eu, t, graph.pdf[arcs]]
        es = graph.nextstate[arcs]
        keep = _best_per_key(eu * S + es, ec)
        keep = keep[_prune(eu[keep], ec[keep], beam, max_active, U)]
        u, s, c = eu[keep], es[keep], ec[keep]
        lists.append((u, src[keep], graph.ilabel[arcs[keep]],
                      graph.olabel[arcs[keep]]))
        u, s, c = eps_rounds(u, s, c)
        done = lens[u] == t + 1
        if bool(done.any()):
            for i in torch.unique(u[done]).tolist():
                m = torch.nonzero(u == i)[:, 0]
                tot = c[m] + graph.final[s[m]]
                j = int(torch.argmin(tot)) if bool(torch.isfinite(tot).any()) \
                    else int(torch.argmin(c[m]))
                cost = float(tot[j]) if math.isfinite(float(tot[j])) \
                    else float(c[m][j])
                ends[i] = (len(lists) - 1, int(m[j]), cost)
            # the finished utterances' walks start from `ends`; the rest
            # go on in a list that points at their entries
            alive = ~done
            u, s, c = u[alive], s[alive], c[alive]
            if len(u) == 0:
                break
            keep_idx = torch.nonzero(alive)[:, 0]
            lists.append((u, keep_idx, torch.zeros_like(keep_idx),
                          torch.zeros_like(keep_idx)))
    out = []
    host = [tuple(x.cpu().numpy() for x in lst) for lst in lists]
    for i in range(U):
        li, j, cost = ends[i]
        words, tids = [], []
        while li > 0:
            _u, bp, il, ol = host[li]
            if ol[j]:
                words.append(int(ol[j]))
            if il[j]:
                tids.append(int(il[j]))
            j = int(bp[j])
            li -= 1
        out.append((words[::-1], tids[::-1], cost))
    return out


def path_cost(g: dict, loglikes: np.ndarray, tids, words,
              acoustic_scale: float, need_final: bool = False) -> float:
    """Least f64 cost of a path from the start state that emits `tids` (one
    per frame of loglikes [T, P]) and outputs `words`, with the final cost
    added where the path can end in a final state; inf if no such path
    (or, with `need_final`, none that ends in a final state)."""
    T = len(loglikes)
    if len(tids) != T:
        return math.inf
    a_start, il, ol = g["arc_start"], g["ilabel"], g["olabel"]
    cost, nxt, pdf, final = g["cost"], g["nextstate"], g["pdf"], g["final"]
    ll = np.asarray(loglikes, np.float64) * acoustic_scale
    nw = len(words)

    def take(toks, want_il, t):
        new = {}
        for (s, wp), c in toks.items():
            a0, a1 = int(a_start[s]), int(a_start[s + 1])
            for a in a0 + np.flatnonzero(il[a0:a1] == want_il):
                o, w = int(ol[a]), wp
                if o:
                    if w >= nw or words[w] != o:
                        continue
                    w += 1
                nc = c + float(cost[a])
                if want_il:
                    nc -= float(ll[t, pdf[a]])
                key = (int(nxt[a]), w)
                if nc < new.get(key, math.inf):
                    new[key] = nc
        return new

    def close(toks):
        frontier = toks
        while frontier:
            new = take(frontier, 0, None)
            frontier = {k: v for k, v in new.items()
                        if v < toks.get(k, math.inf)}
            toks.update(frontier)
        return toks

    toks = close({(int(g["start"]), 0): 0.0})
    for t in range(T):
        toks = close(take(toks, int(tids[t]), t))
        if not toks:
            return math.inf
    ends = [(c, final[s]) for (s, w), c in toks.items() if w == nw]
    fin = [c + float(f) for c, f in ends if np.isfinite(f)]
    if fin or need_final:
        return min(fin, default=math.inf)
    return min((c for c, _f in ends), default=math.inf)
