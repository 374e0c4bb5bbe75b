"""Regression-tree MLLR / fMLLR: per-class transforms with occupancy
back-off, the statistics and scoring on a device in f64.

Counterpart of kaldi_tpu/transform/regtree.py (ref:
transform/regression-tree.h RegressionTree — a binary tree over the
acoustic model's gaussians built by clustering means;
transform/regtree-mllr-diag-gmm.h, regtree-fmllr-diag-gmm.h: a node's
transform is estimated only when its occupancy passes a threshold, else
its parent's applies).

The tree is JAX's host 2-means over the AM's means, in its RNG order. The
statistics take the gaussian posteriors within each entry's pdf from the
port's `AmDiagGmm` on its device (as `FmllrStats` does) and build every
leaf's fMLLR K and G and MLLR K and G as f64 GEMMs over all gaussians with
a leaf one-hot, read back once per call. The fMLLR solve per node is the
port's `estimate_fmllr` (host f64, PR 8); the MLLR solves are one batched
`torch.linalg.solve`. `regtree_fmllr_loglikes` scores every gaussian on its
class's transformed features by one f64 GEMM per class.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.estimation import _aligned_posteriors
from kaldi_tpu_torch.transform.fmllr import FmllrStats, estimate_fmllr

F64 = torch.float64


class RegressionTree:
    """Binary tree over all gaussians of an AmDiagGmm; leaves are the base
    classes. JAX's recursive 2-means on the means, on the host."""

    def __init__(self, am, num_base_classes: int = 4, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        means, owner = [], []
        for pdf, g in enumerate(am.pdfs):
            for m in range(g.num_gauss):
                means.append(g.means[m])
                owner.append((pdf, m))
        self.means = np.asarray(means)
        self.owner = owner
        G = len(means)
        rng = np.random.RandomState(seed)
        self.parent = [-1]
        members = [np.arange(G)]
        leaves = [0]
        unsplittable: list = []
        while leaves and len(leaves) + len(unsplittable) < num_base_classes:
            # split the largest splittable leaf; an unsplittable one
            # (identical means) is set aside, not a reason to stop
            leaves.sort(key=lambda n: -len(members[n]))
            node = leaves.pop(0)
            idx = members[node]
            lab = _two_means(self.means[idx], rng) if len(idx) >= 2 else None
            if lab is None or lab.all() or not lab.any():
                unsplittable.append(node)
                continue
            for side in (0, 1):
                self.parent.append(node)
                members.append(idx[lab == side])
                leaves.append(len(self.parent) - 1)
        self.members = members
        self.leaves = sorted(leaves + unsplittable)
        self.gauss2leaf = np.zeros(G, np.int64)
        for leaf in self.leaves:
            self.gauss2leaf[members[leaf]] = leaf

    @property
    def num_nodes(self) -> int:
        return len(self.parent)

    def ancestors(self, node: int):
        out = [node]
        while self.parent[out[-1]] >= 0:
            out.append(self.parent[out[-1]])
        return out

    def leaf_onehot(self) -> torch.Tensor:
        """[G, num_nodes] f64: gaussian g's leaf."""
        oh = np.zeros((len(self.gauss2leaf), self.num_nodes))
        oh[np.arange(len(self.gauss2leaf)), self.gauss2leaf] = 1.0
        return torch.as_tensor(oh, dtype=F64, device=self.device)


def _entry_posteriors(am, feats, post, device):
    """post[t] = [(pdf, weight)] -> (x [E, D] f64, gaussian posteriors
    [E, G] f64 within each entry's pdf, weighted) on `device`: the AM's
    f32 posteriors (`_aligned_posteriors`) on its device."""
    rows, pdfs, ws = [], [], []
    for t, frame in enumerate(post):
        for pdf, w in frame:
            rows.append(t)
            pdfs.append(int(pdf))
            ws.append(float(w))
    x = np.asarray(feats, np.float64)[np.asarray(rows, np.int64)]
    packed, seg, _tab = am.device_pack()
    p, _ll = _aligned_posteriors(
        torch.as_tensor(x.astype(np.float32), device=am.device),
        torch.as_tensor(np.asarray(pdfs, np.int64), device=am.device),
        torch.as_tensor(np.asarray(ws, np.float32), device=am.device),
        packed, seg)
    return (torch.as_tensor(x, dtype=F64, device=device),
            p.to(device=device, dtype=F64))


def _am_arrays(am, device):
    means = np.concatenate([g.means for g in am.pdfs])
    variances = np.concatenate([g.vars for g in am.pdfs])
    return (torch.as_tensor(means, dtype=F64, device=device),
            torch.as_tensor(1.0 / variances, dtype=F64, device=device))


class RegtreeStats:
    """Per-node fMLLR statistics, accumulated at the leaves (on the tree's
    device) and summed up the tree."""

    def __init__(self, tree: RegressionTree, dim: int):
        self.tree = tree
        self.stats = [FmllrStats(dim) for _ in range(tree.num_nodes)]

    def accumulate(self, am, feats, post):
        """post[t] = [(pdf, weight)]; within-pdf gaussian posteriors from
        the AM. Per leaf l, with gamma [E, G], x+ = [x, 1]:
        K_l = (mu/var masked to l)' (gamma' x+), G_l[d] = sum_e (gamma
        (1/var masked to l))_ed x+ x+'."""
        tree = self.tree
        dev = tree.device
        x, gam = _entry_posteriors(am, feats, post, dev)
        E, D = x.shape
        mu, iv = _am_arrays(am, dev)
        oh = tree.leaf_onehot()                                 # [G, L]
        L = oh.shape[1]
        xp = torch.cat([x, x.new_ones((E, 1))], 1)
        sum_gx = gam.T @ xp                                     # [G, D+1]
        K = torch.einsum("gl,gd,gp->ldp", oh, mu * iv, sum_gx)
        wl = (gam @ (oh[:, :, None] * iv[:, None, :]).reshape(-1, L * D))
        xx = (xp[:, :, None] * xp[:, None, :]).reshape(E, -1)
        Gs = (wl.T @ xx).view(L, D, D + 1, D + 1)
        beta = gam.sum(0) @ oh
        K, Gs, beta = (a.cpu().numpy() for a in (K, Gs, beta))
        for leaf in tree.leaves:
            s = self.stats[leaf]
            s.beta += float(beta[leaf])
            s.K += K[leaf]
            s.G += Gs[leaf]

    def summed_up(self):
        """Propagate leaf stats to ancestors; -> list of FmllrStats."""
        tree = self.tree
        out = [FmllrStats(self.stats[0].K.shape[0])
               for _ in range(tree.num_nodes)]
        for leaf in tree.leaves:
            for node in tree.ancestors(leaf):
                out[node].add(self.stats[leaf])
        return out


def _back_off(tree: RegressionTree, ok, estimate, ident):
    """Each gaussian's transform: its leaf's deepest ancestor (itself
    included) with ok(node), identity if even the root fails."""
    node_xform: dict = {}

    def xform_of(node):
        if node in node_xform:
            return node_xform[node]
        if ok(node):
            node_xform[node] = estimate(node)
        elif tree.parent[node] >= 0:
            node_xform[node] = xform_of(tree.parent[node])
        else:
            node_xform[node] = ident
        return node_xform[node]

    return {int(g): xform_of(int(leaf))
            for g, leaf in enumerate(tree.gauss2leaf)}


def estimate_regtree_fmllr(acc: RegtreeStats, min_count: float = 200.0):
    """-> {gaussian flat index: [D, D+1] transform}: a leaf uses the
    deepest ancestor with enough occupancy (ref: regtree-fmllr-diag-gmm.h
    RegtreeFmllrDiagGmmAccs::Update)."""
    summed = acc.summed_up()
    D = summed[0].K.shape[0]
    ident = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
    return _back_off(acc.tree, lambda n: summed[n].beta >= min_count,
                     lambda n: estimate_fmllr(summed[n],
                                              min_count=min_count)[0],
                     ident)


class MllrStats:
    """Mean-only MLLR statistics mu' = W [mu; 1] on `device`
    (ref: transform/regtree-mllr-diag-gmm.h): per dimension
    G_d = sum_m gamma_m / var_md xi xi', k_d = sum_{t,m} gamma_tm x_td /
    var_md xi, xi = [mu; 1]."""

    def __init__(self, dim: int, device="cuda"):
        self.device = resolve_device(device)
        self.beta = 0.0
        self.K = torch.zeros((dim, dim + 1), dtype=F64, device=self.device)
        self.G = torch.zeros((dim, dim + 1, dim + 1), dtype=F64,
                             device=self.device)

    def accumulate(self, feats, means, variances, posteriors):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64,  # noqa: E731
                                      device=self.device)
        x, mu, var, post = t(feats), t(means), t(variances), t(posteriors)
        mu_p = torch.cat([mu, mu.new_ones((len(mu), 1))], 1)
        gamma_m = post.sum(0)
        self.beta += float(gamma_m.sum())
        inv_var = 1.0 / var
        gx = post.T @ x                                         # [M, D]
        w = gamma_m[:, None] * inv_var                          # [M, D]
        self.G += torch.einsum("md,mp,mq->dpq", w, mu_p, mu_p)
        self.K += (gx * inv_var).T @ mu_p


def estimate_mllr(stats: MllrStats, min_count: float = 100.0):
    """-> W [D, D+1] f64 on the statistics' device: each row solves
    (G_d + 1e-8 I) w_d = k_d (one batched solve); identity under
    min_count."""
    D = stats.K.shape[0]
    eye = torch.eye(D + 1, dtype=F64, device=stats.device)
    if stats.beta < min_count:
        return eye[:D]
    return torch.linalg.solve(stats.G + 1e-8 * eye, stats.K)


def apply_mllr_to_means(am, W):
    """A copy of the AM with means mu' = W [mu; 1] (host f64, the AM's
    device)."""
    W = np.asarray(torch.as_tensor(W).cpu())
    out = []
    for g in am.pdfs:
        mu_p = np.concatenate([g.means, np.ones((g.num_gauss, 1))], axis=1)
        out.append(DiagGmm(g.weights.copy(), mu_p @ W.T, g.vars.copy()))
    return AmDiagGmm(out, am.device)


def _two_means(x: np.ndarray, rng, iters: int = 10):
    n = len(x)
    c = x[rng.choice(n, 2, replace=False)]
    lab = np.zeros(n, np.int64)
    for _ in range(iters):
        d0 = ((x - c[0]) ** 2).sum(1)
        d1 = ((x - c[1]) ** 2).sum(1)
        lab = (d1 < d0).astype(np.int64)
        for s in (0, 1):
            if (lab == s).any():
                c[s] = x[lab == s].mean(0)
    return lab


class RegtreeMllrStats:
    """Per-node MLLR statistics on the tree's device: K [nodes, D, D+1],
    G [nodes, D, D+1, D+1], beta [nodes] (ref: regtree-mllr-diag-gmm.h
    RegtreeMllrDiagGmmAccs)."""

    def __init__(self, tree: RegressionTree, dim: int):
        self.tree = tree
        self.dim = dim
        n = tree.num_nodes
        dev = tree.device
        self.K = torch.zeros((n, dim, dim + 1), dtype=F64, device=dev)
        self.G = torch.zeros((n, dim, dim + 1, dim + 1), dtype=F64,
                             device=dev)
        self.beta = torch.zeros(n, dtype=F64, device=dev)

    def accumulate(self, am, feats, post):
        """post[t] = [(pdf, weight)]: per leaf, K += sum_m (sum_t gamma x
        / var_m) xi_m', G[d] += sum_m gamma_m / var_md xi_m xi_m'."""
        tree = self.tree
        x, gam = _entry_posteriors(am, feats, post, tree.device)
        mu, iv = _am_arrays(am, tree.device)
        oh = tree.leaf_onehot()
        xi = torch.cat([mu, mu.new_ones((len(mu), 1))], 1)      # [G, D+1]
        gamma_m = gam.sum(0)
        sum_gx = gam.T @ x                                      # [G, D]
        self.K += torch.einsum("gl,gd,gp->ldp", oh, sum_gx * iv, xi)
        self.G += torch.einsum("gl,gd,gp,gq->ldpq", oh,
                               gamma_m[:, None] * iv, xi, xi)
        self.beta += gamma_m @ oh

    def summed_up(self):
        """-> (K, G, beta) propagated to ancestors."""
        tree = self.tree
        up = np.zeros((tree.num_nodes, tree.num_nodes))
        for leaf in tree.leaves:
            for node in tree.ancestors(leaf):
                up[node, leaf] = 1.0
        U = torch.as_tensor(up, dtype=F64, device=tree.device)
        n = tree.num_nodes
        return ((U @ self.K.reshape(n, -1)).view_as(self.K),
                (U @ self.G.reshape(n, -1)).view_as(self.G), U @ self.beta)


def estimate_regtree_mllr(acc: RegtreeMllrStats, min_count: float = 200.0):
    """-> {gaussian flat index: [D, D+1] mean transform}: rows solve
    W_d = k_d G_d^-1 (ridge 1e-6) for every node at once; occupancy
    back-off up the tree, identity below min_count
    (ref: regtree-mllr-diag-gmm.cc RegtreeMllrDiagGmmAccs::Update)."""
    K, G, beta = acc.summed_up()
    D = acc.dim
    eye = torch.eye(D + 1, dtype=F64, device=K.device)
    W = torch.linalg.solve(G + 1e-6 * eye, K).cpu().numpy()
    beta = beta.cpu().numpy()
    ident = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
    return _back_off(acc.tree, lambda n: beta[n] >= min_count,
                     lambda n: W[n], ident)


def unstack_transforms(tree: RegressionTree, stacked, dim: int) -> dict:
    """Invert the [L*D, D+1] stacking written by gmm-est-regtree-fmllr:
    -> {leaf: [D, D+1]} in sorted-leaf order."""
    leaves = sorted(set(int(l) for l in tree.gauss2leaf))
    return {leaf: np.asarray(stacked[i * dim:(i + 1) * dim], np.float64)
            for i, leaf in enumerate(leaves)}


def regtree_fmllr_loglikes(am, tree: RegressionTree, by_leaf: dict,
                           feats) -> torch.Tensor:
    """[T, num_pdfs] f64 loglikes on the tree's device under per-class
    feature transforms: each gaussian scored on its class's transformed
    features plus log|A_class| (ref: gmm/decodable-am-diag-gmm-regtree.h
    DecodableAmDiagGmmRegtreeFmllr); one f64 GEMM of [x', -0.5 x'^2, 1]
    per class against all gaussians, each gaussian's column taken from its
    class, then a per-pdf log-sum-exp."""
    dev = tree.device
    x = torch.as_tensor(np.asarray(feats), dtype=F64, device=dev)
    T, D = x.shape
    means = np.concatenate([g.means for g in am.pdfs])
    var = np.concatenate([g.vars for g in am.pdfs])
    w = np.concatenate([g.weights for g in am.pdfs])
    gconst = (np.log(np.maximum(w, 1e-30))
              - 0.5 * np.sum(np.log(2 * np.pi * var), axis=1)
              - 0.5 * np.sum(means * means / var, axis=1))
    pack = torch.as_tensor(np.concatenate(
        [(means / var).T, (1.0 / var).T, gconst[None]]), dtype=F64,
        device=dev)

    def scored(xx):
        return torch.cat([xx, -0.5 * xx * xx, xx.new_ones((T, 1))], 1) @ pack

    g2l = tree.gauss2leaf
    ll = scored(x)
    for leaf, W in by_leaf.items():
        cols = torch.as_tensor(np.flatnonzero(g2l == int(leaf)), device=dev)
        if len(cols) == 0:
            continue
        Wt = torch.as_tensor(W, dtype=F64).to(dev)
        A, b = Wt[:, :D], Wt[:, D]
        ld = torch.linalg.slogdet(A)[1]
        ll[:, cols] = scored(x @ A.T + b)[:, cols] + ld
    _packed, seg, table = am.device_pack()
    pad = ll.new_full((T, 1), float("-inf"))
    return torch.logsumexp(torch.cat([ll, pad], 1)[:, table.to(dev)], dim=2)


def apply_regtree_mllr(am, tree: RegressionTree, by_leaf: dict):
    """-> a deep copy of am with per-class MLLR mean transforms applied:
    mu' = A_c mu + b_c (ref: regtree-mllr-diag-gmm.h
    RegtreeMllrDiagGmm::TransformModel); host f64, the AM's device."""
    out = copy.deepcopy(am)
    off = 0
    for g in out.pdfs:
        leaves = tree.gauss2leaf[off: off + g.num_gauss]
        D = g.dim
        for leaf in np.unique(leaves):
            W = by_leaf.get(int(leaf))
            if W is None:
                continue
            W = np.asarray(torch.as_tensor(W).cpu())
            sel = leaves == leaf
            g.means[sel] = g.means[sel] @ W[:, :D].T + W[:, D]
        off += g.num_gauss
    out.invalidate()
    return out
