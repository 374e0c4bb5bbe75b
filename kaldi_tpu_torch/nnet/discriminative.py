"""Sequence-discriminative nnet training: MMI / bMMI / MPE / sMBR.

Counterpart of kaldi_tpu/nnet/discriminative.py (ref:
nnet2/nnet-compute-discriminative.h:35 NnetDiscriminativeUpdate and
steps/nnet2/train_discriminative2.sh). The gradient of every lattice-based
sequence objective w.r.t. the log acoustic likelihood at (t, pdf) is the
signed posterior computed by the lattice forward-backward — numerator
minus denominator for (b)MMI, the MPE "gamma" for MPE/sMBR. The posterior
pass runs on the host over lattices (the port's copies of
`lat/posteriors.py`); the parameter update is one step of the surrogate
loss  L = -Σ post[t,pdf] · logprob[t,pdf]  whose gradient equals the true
objective's gradient, with `post` detached: `torch.func.functional_call`
and `torch.autograd.grad` (`nnet/train._grad_step`) with the port's
`nnet/optim.sgd`, on the AM's device.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
from torch.func import functional_call

from kaldi_tpu_torch.lat.posteriors import (
    lattice_boost, lattice_forward_backward_mmi,
    lattice_forward_backward_mpe_variants, rescore_lattice)
from kaldi_tpu_torch.nnet import optim
from kaldi_tpu_torch.nnet.train import _grad_step
from kaldi_tpu_torch.steps.mono import _PhaseClock

log = logging.getLogger("kaldi_tpu_torch.nnet.discriminative")


@dataclasses.dataclass
class NnetDiscriminativeOpts:
    """(ref: nnet2/nnet-compute-discriminative.h:35
    NnetDiscriminativeUpdateOptions)"""
    criterion: str = "smbr"       # 'mmi' | 'smbr' | 'mpfe'
    acoustic_scale: float = 0.1
    boost: float = 0.0
    drop_frames: bool = True
    learning_rate: float = 1e-4
    num_epochs: int = 1
    one_silence_class: bool = True


def compute_discriminative_post(
    am_nnet, lat, num_ali, tm, opts: NnetDiscriminativeOpts,
    loglikes: np.ndarray, silence_phones=frozenset(),
):
    """-> (post [T, num_pdfs] dense signed gradient, objf).

    `loglikes` are the current model's (prior-divided, unscaled) acoustic
    log-likelihoods for this utterance, numpy on the host; the lattice is
    rescored with them before the forward-backward (ref:
    nnet2/nnet-compute-discriminative.cc LatticeComputations).
    """
    rescore_lattice(lat, loglikes, tm, opts.acoustic_scale)
    T = loglikes.shape[0]
    P = loglikes.shape[1]
    if opts.criterion == "mmi":
        sparse, den_like = lattice_forward_backward_mmi(
            lat, num_ali, tm, opts.drop_frames, cancel=True)
        # true MMI objective = num loglike - den loglike (the num term
        # moves with the params, so -den alone would not show divergence)
        pdfs = np.fromiter(
            (tm.transition_id_to_pdf(int(t)) for t in num_ali), np.int64,
            count=T)
        num_like = opts.acoustic_scale * float(
            loglikes[np.arange(T), pdfs].sum())
        objf = num_like - den_like
    else:
        sparse, objf = lattice_forward_backward_mpe_variants(
            lat, num_ali, tm, opts.criterion, silence_phones,
            opts.one_silence_class)
    dense = np.zeros((T, P), np.float32)
    for t, frame in enumerate(sparse):
        for pdf, w in frame:
            dense[t, pdf] = w
    return dense, objf


def make_discriminative_step(model, tx: optim.GradientTransformation):
    """-> step(params, opt_state, feats [T+ctx, D], post [T, P]) ->
    (params, opt_state, loss): one step of the surrogate loss, where its
    tensors are."""

    def loss_fn(p, feats, post):
        logprob = functional_call(model, p, (feats[None],),
                                  {"pad_context": False})[0]
        loss = -torch.sum(post.detach() * logprob)
        return loss, loss

    def step(params, opt_state, feats, post):
        params, opt_state, loss, _ = _grad_step(
            lambda p: loss_fn(p, feats, post), tx, params, opt_state)
        return params, opt_state, loss

    return step


def train_nnet_discriminative(
    am_nnet,                      # AmNnet (model + priors)
    tm,                           # TransitionModel
    egs,                          # [(feats [T+ctx, D], num_ali [T], lattice)]
    opts: NnetDiscriminativeOpts = NnetDiscriminativeOpts(),
    silence_phones=frozenset(),
    iter_stats: list | None = None,
):
    """Sequence-discriminative fine-tuning of a hybrid TDNN on its device.

    Returns (new_params, objf_history): the params a dict named as
    `Tdnn.state_dict()` names them. Lattices are rescored with the current
    model each epoch (ref: steps/nnet2/train_discriminative2.sh
    regenerates posteriors per iteration against fixed denlats).

    Two forwards per utterance, as in JAX: `loglikes_np` of the current
    params for the lattice pass, then the one inside the step; the
    posterior pass is host code between the two.

    iter_stats: if a list is given, one dict per epoch is appended with
    the seconds of its phases ("loglikes", "boost", "post" (rescore,
    forward-backward, dense posteriors), "step"; the device is
    synchronised after each) and the objective per frame."""
    model = am_nnet.model
    dev = am_nnet.device
    clock = _PhaseClock(dev, iter_stats is not None)
    params = model.params()
    tx = optim.sgd(opts.learning_rate)
    opt_state = tx.init(params)
    step = make_discriminative_step(model, tx)
    # Tdnn exposes its context through its config; a net that carries
    # left_context itself is read first, as in JAX
    lc = getattr(model, "left_context", None)
    if lc is None:
        lc = model.config.left_context

    hist = []
    boosted = set()
    for epoch in range(opts.num_epochs):
        tot_objf, tot_frames = 0.0, 0
        for i, (feats, num_ali, lat) in enumerate(egs):
            cur = am_nnet.replace_params(params)
            # feats carry the model's context; the lattice's frame t is the
            # output frame at offset left_context under pad_context=True
            ll = clock("loglikes", lambda: cur.loglikes_np(feats[None])[0])
            T = len(num_ali)
            ll = ll[lc:lc + T]
            if opts.boost != 0.0 and i not in boosted:
                clock("boost", lambda: lattice_boost(
                    lat, num_ali, tm, opts.boost, silence_phones))
                boosted.add(i)
            post, objf = clock("post", lambda: compute_discriminative_post(
                cur, lat, num_ali, tm, opts, ll, silence_phones))
            params, opt_state, _loss = clock("step", lambda: step(
                params, opt_state,
                torch.as_tensor(np.asarray(feats, np.float32), device=dev),
                torch.as_tensor(post, device=dev)))
            tot_objf += objf
            tot_frames += T
        hist.append(tot_objf / max(tot_frames, 1))
        log.info("epoch %d: %s objf/frame %.6f", epoch, opts.criterion,
                 hist[-1])
        clock.flush(iter_stats, iter=epoch, objf=hist[-1])
    return params, hist
