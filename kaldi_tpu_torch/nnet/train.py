"""DNN training: cross-entropy steps over a TDNN with an optimizer chain.

Counterpart of kaldi_tpu/nnet/train.py (ref: nnet2/nnet-update.h:46-94
NnetUpdater, steps/nnet2/train_multisplice_accel2.sh's learning-rate
schedule). Training is functional, as in JAX: `params` is a dict name ->
tensor named as `Tdnn.state_dict()` names it, a step returns new params
and a new optimizer state, and the module only supplies the forward
(`torch.func.functional_call`). The products and their gradients are
`torch.matmul` under autograd; the JAX package computes them outside any
Pallas kernel too.

With `mesh=` (a parallel.mesh DeviceMesh) the step is SPMD: every rank
passes the same global batch and the same replicated params; each rank
takes its rows over 'data' and, with 'model' > 1, its column shard of the
final affine, whose logits are all-gathered over 'model' before the
log-softmax. The loss keeps JAX's global normaliser (the weight sum of the
whole batch), the gradients are summed over the world before the
optimizer (clip included) sees them, and params, optimizer state, loss and
accuracy come back replicated and global, as JAX's one-program step gives
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.nnet import optim
from kaldi_tpu_torch.nnet.tdnn import Tdnn


@dataclasses.dataclass(frozen=True)
class NnetTrainOpts:
    """(ref: nnet2/nnet-trnopts + train_multisplice_accel2.sh lr schedule)"""

    initial_lr: float = 0.0015
    final_lr: float = 0.00015
    num_epochs: int = 8
    minibatch_size: int = 128
    momentum: float = 0.0
    max_grad_norm: float = 5.0
    l2_regularize: float = 0.0


def _ce(log_post: torch.Tensor, targets: torch.Tensor,
        weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean negative log-likelihood over max(sum(w), 1), and the
    weighted accuracy of the first-index argmax."""
    ll = torch.gather(log_post, -1, targets.long()[..., None])[..., 0]
    tot_w = torch.clamp(torch.sum(weights), min=1.0)
    loss = -torch.sum(ll * weights) / tot_w
    hit = (torch.argmax(log_post, dim=-1) == targets).to(weights.dtype)
    return loss, torch.sum(hit * weights) / tot_w


def cross_entropy_loss(model: Tdnn, params, feats, targets, weights,
                       compute_dtype=None):
    """feats [B, T+ctx, D] (valid-mode), targets [B, T], weights [B, T]
    -> (loss, accuracy) device scalars.

    compute_dtype=torch.bfloat16 runs the affine products (and their
    gradients) in bf16 over the f32 params; the loss stays f32. It is
    passed to the model only when set, as JAX does, so that a model whose
    forward takes no compute_dtype can share the loss."""
    kw = {"pad_context": False}
    if compute_dtype is not None:
        kw["compute_dtype"] = compute_dtype
    log_post = functional_call(model, params, (feats,), kw)
    return _ce(log_post, targets, weights)


def make_optimizer(opts: NnetTrainOpts, num_steps: int
                   ) -> optim.GradientTransformation:
    """Clip -> decayed weights -> SGD (with momentum if set), the SGD rate
    decaying exponentially from initial_lr to final_lr over num_steps."""
    sched = optim.exponential_decay(
        opts.initial_lr, max(num_steps, 1),
        opts.final_lr / opts.initial_lr, end_value=opts.final_lr)
    chain = []
    if opts.max_grad_norm > 0:
        chain.append(optim.clip_by_global_norm(opts.max_grad_norm))
    if opts.l2_regularize > 0:
        chain.append(optim.add_decayed_weights(opts.l2_regularize))
    chain.append(optim.sgd(sched, momentum=opts.momentum
                           if opts.momentum > 0 else None))
    return optim.chain(*chain)


def _grad_step(loss_fn, optimizer, params, opt_state):
    """One step of `optimizer` on loss_fn(params) -> (loss, aux). A param
    the loss does not read (a layer past a progressive stage) gets a zero
    gradient, as under jax.grad."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
    with torch.no_grad():
        updates, opt_state = optimizer.update(
            dict(zip(leaves, grads)), opt_state, params)
        params = optim.apply_updates(params, updates)
    return params, opt_state, loss.detach(), aux.detach()


class _GatherModel(torch.autograd.Function):
    """All-gather over the 'model' group along the last dim, in rank order.
    Every rank of the group computes the same loss from the gathered
    logits, so their gradients are equal: the backward takes this rank's
    slice, and the partial gradients of the layers below are summed with
    the others in the step's all-reduce."""

    @staticmethod
    def forward(ctx, x, group, index: int, size: int):
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.index, ctx.width = index, x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.width, ctx.width), None, None, None


def _mesh_step(model: Tdnn, optimizer, mesh, compute_dtype):
    """The SPMD train step over `mesh` (see the module docstring)."""
    from kaldi_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                               check_mesh, local_shard,
                                               rank_rows, tdnn_param_sharding)
    check_mesh(mesh)
    data_group = mesh.get_group("data")
    M = axis_size(mesh, "model")
    kw = {"pad_context": False}
    if compute_dtype is not None:
        kw["compute_dtype"] = compute_dtype
    if M > 1:
        model_group, mi = mesh.get_group("model"), axis_index(mesh, "model")
        kw["logits_gather"] = lambda x: _GatherModel.apply(x, model_group,
                                                           mi, M)

    def step(params, opt_state, feats, targets, weights):
        rows = rank_rows(mesh, targets.shape[0])
        feats, targets, weights = feats[rows], targets[rows], weights[rows]
        # JAX's normaliser: max(sum of the GLOBAL batch's weights, 1)
        tot_w = torch.sum(weights)
        dist.all_reduce(tot_w, group=data_group)
        tot_w = torch.clamp(tot_w, min=1.0)
        place = tdnn_param_sharding(mesh, params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            local = {k: local_shard(v, mesh, place[k])
                     for k, v in leaves.items()}
            log_post = functional_call(model, local, (feats,), kw)
            ll = torch.gather(log_post, -1, targets.long()[..., None])[..., 0]
            loss = -torch.sum(ll * weights) / tot_w
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            hit = (torch.argmax(log_post, dim=-1) == targets).to(weights.dtype)
            stats = torch.stack([loss, torch.sum(hit * weights) / tot_w])
            # the sum over 'data' of the rows' gradients and, over 'model',
            # of the final shards' (disjoint) and the hidden layers'
            # partial ones: one all-reduce over the world
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            grads = [f.view_as(g) for f, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
            dist.all_reduce(stats, group=data_group)
            updates, opt_state = optimizer.update(
                dict(zip(leaves, grads)), opt_state, params)
            params = optim.apply_updates(params, updates)
        return params, opt_state, stats[0], stats[1]

    return step


def make_train_step(model: Tdnn, optimizer: optim.GradientTransformation,
                    mesh=None, compute_dtype=None):
    """-> step(params, opt_state, feats, targets, weights) -> (params,
    opt_state, loss, acc). It runs where its tensors are; loss and acc
    come back as device scalars (no host sync).

    With a mesh the step is SPMD over it (every rank passes the global
    batch; see the module docstring): the batch shards over 'data', the
    final affine over 'model'."""
    if mesh is not None:
        return _mesh_step(model, optimizer, mesh, compute_dtype)

    def step(params, opt_state, feats, targets, weights):
        return _grad_step(
            lambda p: cross_entropy_loss(model, p, feats, targets, weights,
                                         compute_dtype=compute_dtype),
            optimizer, params, opt_state)

    return step


def shard_params(params: dict, mesh):
    """-> (this rank's shard of each param, their placements): the slices
    JAX's `shard_params` puts on this rank's device under
    `tdnn_param_sharding` (the final affine's columns over 'model', the
    rest replicated). The mesh step takes the replicated params and takes
    these shards itself."""
    from kaldi_tpu_torch.parallel.mesh import local_shard, tdnn_param_sharding
    place = tdnn_param_sharding(mesh, params)
    return {k: local_shard(v, mesh, place[k]) for k, v in params.items()}, \
        place


def train_epochs(model: Tdnn, params, egs, opts: NnetTrainOpts = NnetTrainOpts(),
                 mesh=None, rng: np.random.RandomState | None = None,
                 log_every: int = 50, callback=None, device="cuda"):
    """In-memory trainer over numpy egs {feats [N, chunk+ctx, D], targets
    [N, chunk], weights [N, chunk]}: the same permutations and the same
    full-minibatch tail padding as JAX's, so the batches are equal.
    With a mesh every rank makes this call with the same egs and rng and
    trains its shard of each batch (`make_train_step`), `device` being
    this rank's. -> (params on `device`, history of (epoch, k, loss,
    acc)), replicated."""
    dev = resolve_device(device)
    rng = rng or np.random.RandomState(0)
    N = egs["feats"].shape[0]
    mb = opts.minibatch_size
    steps_per_epoch = max(N // mb, 1)
    optimizer = make_optimizer(opts, steps_per_epoch * opts.num_epochs)
    params = {k: v.to(dev) for k, v in params.items()}
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, optimizer, mesh)
    history = []
    for epoch in range(opts.num_epochs):
        perm = rng.permutation(N)
        for k in range(steps_per_epoch):
            sel = perm[k * mb: (k + 1) * mb]
            if len(sel) < mb:
                # a full minibatch, tiling the permutation if N < mb
                sel = np.concatenate([sel, np.resize(perm, mb - len(sel))])
            params, opt_state, loss, acc = step_fn(
                params, opt_state,
                *(torch.as_tensor(egs[key][sel], device=dev)
                  for key in ("feats", "targets", "weights")))
            if k % log_every == 0:
                history.append((epoch, k, float(loss), float(acc)))
                if callback:
                    callback(epoch, k, float(loss), float(acc))
    return params, history


def make_egs(utts, left_context: int, right_context: int, chunk: int = 8):
    """Chunked frame examples from (feats [T, D], pdf_ids [T]) utterances:
    feats [N, chunk + l + r, D] edge-padded, targets [N, chunk], weights 1
    on real frames and 0 on the tail padding (numpy; ref:
    steps/nnet2/get_egs2.sh)."""
    feats_out, tgt_out, w_out = [], [], []
    width = chunk + left_context + right_context
    for feats, pdfs in utts:
        T, _D = feats.shape
        padded = np.pad(feats, ((left_context, right_context), (0, 0)),
                        mode="edge")
        for start in range(0, T, chunk):
            n = min(start + chunk, T) - start
            win = padded[start: start + width]
            if win.shape[0] < width:
                win = np.pad(win, ((0, width - win.shape[0]), (0, 0)),
                             mode="edge")
            t = np.zeros(chunk, np.int32)
            t[:n] = pdfs[start:start + n]
            w = np.zeros(chunk, np.float32)
            w[:n] = 1.0
            feats_out.append(win)
            tgt_out.append(t)
            w_out.append(w)
    return {"feats": np.stack(feats_out).astype(np.float32),
            "targets": np.stack(tgt_out),
            "weights": np.stack(w_out)}


def default_progressive_optimizer(opts: NnetTrainOpts, num_steps: int
                                  ) -> optim.GradientTransformation:
    """Adam at 2e-3 decaying by 0.25 over the stage, floored at 5e-4: its
    per-parameter normalization bridges the p-norm stack's gradient-scale
    gap between the final affine and the hidden layers."""
    return optim.adam(optim.exponential_decay(2e-3, max(num_steps, 1), 0.25,
                                              end_value=5e-4))


def train_progressive(model: Tdnn, params, feats, targets, weights,
                      opts: NnetTrainOpts = NnetTrainOpts(),
                      steps_per_stage: int = 100, final_steps: int = 300,
                      compute_dtype=None, log_every: int = 0,
                      optimizer_factory=None, device="cuda"):
    """Layer-wise discriminative pretraining (ref: the growing
    num-hidden-layers schedule of steps/nnet2/train_pnorm_accel2.sh):
    stage k trains the first k hidden layers under the final affine, kept
    across stages, with a fresh optimizer from
    optimizer_factory(opts, steps) (default: Adam,
    `default_progressive_optimizer`).

    feats carry the FULL net's context [B, T + ctx, D]; stage k reads the
    output window at lc_full - lc_k. -> (params on `device`, history of
    (stage, loss, acc))."""
    dev = resolve_device(device)
    factory = optimizer_factory or default_progressive_optimizer
    feats, targets, weights = (torch.as_tensor(a, device=dev)
                               for a in (feats, targets, weights))
    params = {k: v.to(dev) for k, v in params.items()}
    n_layers = len(model.config.splice_indexes)
    lc_full = model.config.left_context
    T = targets.shape[1]
    history = []
    for k in range(1, n_layers + 1):
        steps = final_steps if k == n_layers else steps_per_stage
        optimizer = factory(opts, steps)
        opt_state = optimizer.init(params)
        off = lc_full - model.context_of(k)[0]

        def loss_fn(p, k=k, off=off):
            log_post = functional_call(
                model, p, (feats,),
                {"pad_context": False, "compute_dtype": compute_dtype,
                 "num_layers": k})
            return _ce(log_post.narrow(1, off, T), targets, weights)

        loss = acc = None
        for i in range(steps):
            params, opt_state, loss, acc = _grad_step(loss_fn, optimizer,
                                                      params, opt_state)
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"stage {k}/{n_layers} step {i}: "
                      f"loss {float(loss):.3f} acc {float(acc):.3f}")
        history.append((k, float(loss), float(acc)))
    return params, history
