"""nnet3 trainer: objectives at output nodes and NG-SGD over config nets.

Counterpart of kaldi_tpu/nnet3/training.py (ref: nnet3/nnet-training.cc:37
NnetTrainer::Train: one minibatch is a forward to the output node, the
objective and its derivative there, backprop and a natural-gradient
update). The forward is `Nnet3` through `torch.func.functional_call`,
the gradient autograd (`nnet/train._grad_step`), and the preconditioner
the port's `nnet/natural_gradient.py`, applied to every
NaturalGradientAffineComponent's weight matrix. Training runs where the
net's weights are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import functional_call

from kaldi_tpu_torch.nnet import optim
from kaldi_tpu_torch.nnet.am_nnet import AmNnet
from kaldi_tpu_torch.nnet.natural_gradient import natural_gradient
from kaldi_tpu_torch.nnet.train import _grad_step
from kaldi_tpu_torch.nnet3.network import Nnet3, param_name


@dataclasses.dataclass(frozen=True)
class Nnet3TrainOpts:
    """(ref: nnet3/nnet-training.h:40 NnetTrainerOptions)"""

    initial_lr: float = 0.0015
    final_lr: float = 0.00015
    num_epochs: int = 8
    minibatch_size: int = 128
    momentum: float = 0.0
    max_grad_norm: float = 5.0
    use_natural_gradient: bool = True   # NaturalGradientAffineComponent
    ng_alpha: float = 4.0
    ng_update_period: int = 4


def nnet3_objective(net: Nnet3, params, feats, targets, weights,
                    output: str = "output"):
    """Objective and frame accuracy at an output node -> (loss, acc)
    device scalars.

    'linear': the weighted mean of the target row of the output, negated
    (cross-entropy when the output node ends in LogSoftmax). 'quadratic':
    0.5 x the weighted squared error against dense target vectors, with a
    zero accuracy. (ref: nnet3/nnet-training.cc:262
    ComputeObjectiveFunction.)"""
    node = net.by_name[output]
    y = functional_call(net, params, (feats,),
                        {"output": output, "pad_context": False})
    tot_w = torch.clamp(torch.sum(weights), min=1.0)
    if node.objective == "quadratic":
        err = y - targets
        loss = 0.5 * torch.sum(err * err * weights[..., None]) / tot_w
        return loss, torch.zeros((), device=loss.device)
    ll = torch.gather(y, -1, targets.long()[..., None])[..., 0]
    loss = -torch.sum(ll * weights) / tot_w
    hit = (torch.argmax(y, dim=-1) == targets).to(weights.dtype)
    return loss, torch.sum(hit * weights) / tot_w


def ng_param_filter(net: Nnet3):
    """The predicate that picks exactly the NaturalGradientAffineComponent
    weights by their params-dict names (JAX matches the component name
    inside the keystr and leaves the 1-D biases to `is_mat`)."""
    names = frozenset(param_name(c, "w") for c, cfg in net.components.items()
                      if cfg["type"] == "NaturalGradientAffineComponent")
    return lambda name: name in names


def make_nnet3_optimizer(net: Nnet3, opts: Nnet3TrainOpts, num_steps: int
                         ) -> optim.GradientTransformation:
    """NG preconditioner (on NaturalGradientAffineComponent weights) ->
    global-norm clip -> SGD with an exponentially decaying rate."""
    sched = optim.exponential_decay(
        opts.initial_lr, max(num_steps, 1),
        opts.final_lr / opts.initial_lr, end_value=opts.final_lr)
    chain = []
    if opts.use_natural_gradient and any(
            cfg["type"] == "NaturalGradientAffineComponent"
            for cfg in net.components.values()):
        chain.append(natural_gradient(
            alpha=opts.ng_alpha, update_period=opts.ng_update_period,
            param_filter=ng_param_filter(net)))
    if opts.max_grad_norm > 0:
        chain.append(optim.clip_by_global_norm(opts.max_grad_norm))
    chain.append(optim.sgd(sched, momentum=opts.momentum
                           if opts.momentum > 0 else None))
    return optim.chain(*chain)


def make_nnet3_train_step(net: Nnet3, optimizer: optim.GradientTransformation,
                          output: str = "output"):
    """-> step(params, opt_state, feats, targets, weights) -> (params,
    opt_state, loss, acc), where its tensors are."""

    def step(params, opt_state, feats, targets, weights):
        return _grad_step(
            lambda p: nnet3_objective(net, p, feats, targets, weights,
                                      output),
            optimizer, params, opt_state)

    return step


def train_nnet3(net: Nnet3, params, egs, opts: Nnet3TrainOpts =
                Nnet3TrainOpts(), output: str = "output",
                rng: np.random.RandomState | None = None,
                log_every: int = 50):
    """In-memory nnet3 training loop (the nnet3-train binary role) on the
    net's device, over numpy egs {feats, targets, weights}: JAX's
    permutations and full-minibatch tail padding, so the batches are
    equal. -> (params, history of (epoch, k, loss, acc))."""
    dev = net.device
    rng = rng or np.random.RandomState(0)
    N = egs["feats"].shape[0]
    mb = opts.minibatch_size
    steps_per_epoch = max(N // mb, 1)
    optimizer = make_nnet3_optimizer(net, opts,
                                     steps_per_epoch * opts.num_epochs)
    params = {k: v.to(dev) for k, v in params.items()}
    opt_state = optimizer.init(params)
    step_fn = make_nnet3_train_step(net, optimizer, output)
    history = []
    for epoch in range(opts.num_epochs):
        perm = rng.permutation(N)
        for k in range(steps_per_epoch):
            sel = perm[k * mb: (k + 1) * mb]
            if len(sel) < mb:
                sel = np.concatenate([sel, np.resize(perm, mb - len(sel))])
            params, opt_state, loss, acc = step_fn(
                params, opt_state,
                *(torch.as_tensor(egs[key][sel], device=dev)
                  for key in ("feats", "targets", "weights")))
            if k % log_every == 0:
                history.append((epoch, k, float(loss), float(acc)))
    return params, history


class AmNnet3(AmNnet):
    """AmNnet over a config-defined Nnet3 (the same pseudo-loglike scoring;
    ref: nnet3/am-nnet-simple.h AmNnetSimple). The net holds its weights;
    no mixed-up rows on config nets."""

    def __init__(self, net: Nnet3, priors: np.ndarray | None = None):
        super().__init__(net, priors)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def num_pdfs(self) -> int:
        return self.model.dims["output"]

    def replace_params(self, params) -> "AmNnet3":
        """A new AmNnet3 over a copy of the net holding `params`: the port's
        params dict, or JAX's {component: {leaf: array}} tree. The priors
        are shared."""
        from kaldi_tpu_torch.params import nnet3_params_from_jax
        order = None
        if isinstance(next(iter(params.values())), dict):
            # the tree's order is the file order (io/model_io.py)
            order = [(c, k) for c, leaf in params.items() for k in leaf]
            params = nnet3_params_from_jax(params)
        net = Nnet3(self.model.config_text, device=self.device)
        net.load_state_dict(params)
        net.param_order = order
        return AmNnet3(net, self.priors)
