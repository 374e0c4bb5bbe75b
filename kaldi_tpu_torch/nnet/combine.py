"""Model averaging, combination and mixup, and mixture posteriors.

Counterpart of kaldi_tpu/nnet/combine.py (ref: nnet2bin/nnet-am-average.cc,
the reduce step of parallel training; nnet2/combine-nnet-fast.h,
per-(model, layer) interpolation weights fitted on a validation set, here
by full-batch Adam; nnet2/mixup-nnet.h MixupNnet and MixtureProbComponent).
Params are dicts name -> tensor, named as `Tdnn.state_dict()` names them.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.nnet import optim


def average_params(params_list: list[dict]) -> dict:
    """(ref: nnet-am-average.cc) elementwise mean over the models."""
    return {k: sum(p[k] for p in params_list) / len(params_list)
            for k in params_list[0]}


def combine_params(params_list: list[dict], loss_fn, num_steps: int = 50,
                   learning_rate: float = 0.1) -> tuple[dict, float]:
    """Fit softmax interpolation weights per (model, leaf) to minimise
    loss_fn(params) (a validation loss), starting uniform, with
    `num_steps` Adam steps. -> (combined params, the loss before the last
    step). Column l of the weights is leaf l in the dict's order; each
    column moves on its own gradient, so the order does not change the
    result."""
    names = list(params_list[0])
    stacked = [torch.stack([p[k] for p in params_list]) for k in names]
    w = torch.zeros(len(params_list), len(names),
                    device=stacked[0].device)     # softmax logits [N, L]

    def build(w):
        probs = torch.softmax(w, dim=0)
        return {k: torch.tensordot(probs[:, i], stacked[i], dims=1)
                for i, k in enumerate(names)}

    tx = optim.adam(learning_rate)
    state = tx.init({"w": w})
    loss = None
    for _ in range(num_steps):
        leaf = w.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(build(leaf))
            (g,) = torch.autograd.grad(loss, [leaf])
        with torch.no_grad():
            upd, state = tx.update({"w": g}, state)
            w = optim.apply_updates({"w": w}, upd)["w"]
    with torch.no_grad():
        return build(w), float(loss)


def mixup_softmax_layer(w: np.ndarray, b: np.ndarray, num_mixtures: int,
                        perturb: float = 0.01, seed: int = 0):
    """Mix up the final affine+softmax (numpy): each output row r becomes
    `num_mixtures // num_rows` copies, all but the first perturbed, each
    with log(1 / copies) added to its bias, whose posteriors are summed
    downstream (ref: nnet2/mixup-nnet.h MixupNnet).

    -> (w_new [M, D], b_new [M], group_ids [M]): group_ids maps the
    expanded rows back to original classes."""
    rng = np.random.RandomState(seed)
    C, D = w.shape
    copies = max(1, num_mixtures // C)
    w_new, b_new, gid = [], [], []
    for c in range(C):
        for k in range(copies):
            noise = rng.randn(D) * perturb if k > 0 else 0.0
            w_new.append(w[c] + noise)
            b_new.append(b[c] - np.log(copies))
            gid.append(c)
    return np.stack(w_new), np.asarray(b_new), np.asarray(gid)


def _group_table(group_ids: np.ndarray, num_groups: int) -> np.ndarray:
    """[C, G] column indices of each group's members in ascending order (G
    = the largest group), padded with M, the index of a pad column."""
    gid = np.asarray(group_ids, np.int64)
    counts = np.bincount(gid, minlength=num_groups)
    table = np.full((num_groups, max(int(counts.max(initial=0)), 1)),
                    len(gid), np.int64)
    order = np.argsort(gid, kind="stable")
    pos = np.arange(len(gid)) - np.repeat(np.cumsum(counts) - counts, counts)
    table[gid[order], pos] = order
    return table


def sum_group_log_posteriors(log_post: torch.Tensor, group_ids,
                             num_groups: int) -> torch.Tensor:
    """[..., M] mixed-up log-posteriors -> [..., C] by log-sum-exp over
    each group: a segment max shift, then a segment sum of exp.

    Both segment reductions gather each group's members into a padded
    [..., C, G] block and reduce its last dim, so the order of the sum is
    fixed (an `index_add` would use atomics on CUDA, whose order can change
    from run to run). An empty group gives -inf."""
    dev = log_post.device
    gid = torch.as_tensor(np.asarray(group_ids), dtype=torch.int64,
                          device=dev)
    table = torch.as_tensor(_group_table(group_ids, num_groups), device=dev)
    pad = log_post.new_full(log_post.shape[:-1] + (1,), float("-inf"))
    m = torch.amax(torch.cat([log_post, pad], dim=-1)[..., table], dim=-1)
    shifted = torch.exp(log_post - m.index_select(-1, gid))
    s = torch.sum(torch.cat([shifted, torch.zeros_like(pad)], dim=-1)
                  [..., table], dim=-1)
    return m + torch.log(torch.clamp(s, min=1e-37))
