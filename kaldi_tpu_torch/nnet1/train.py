"""nnet1 trainers: frame-shuffled per-frame and multi-stream BPTT.

Counterpart of kaldi_tpu/nnet1/train.py (ref: nnet/nnet-randomizer.h:66
MatrixRandomizer, nnet/nnet-loss.h:59 Xent and :112 Mse with per-frame
weights, nnetbin/nnet-train-lstm-streams.cc: S parallel utterance
streams, truncated-BPTT chunks with carried LSTM state, a per-stream
reset when an utterance ends). The shuffles and the stream schedule are
host numpy, in JAX's order; the steps run where the params are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.nnet import optim


def xent_loss(log_post, targets, weights):
    """Per-frame weighted cross-entropy and accuracy (ref: nnet-loss.h:59
    Xent) -> (loss, acc) device scalars."""
    ll = torch.gather(log_post, -1, targets.long()[..., None])[..., 0]
    w = torch.clamp(weights.sum(), min=1.0)
    loss = -(ll * weights).sum() / w
    hit = (torch.argmax(log_post, dim=-1) == targets).to(weights.dtype)
    return loss, (hit * weights).sum() / w


def mse_loss(pred, targets, weights):
    """(ref: nnet-loss.h:112 Mse)"""
    w = torch.clamp(weights.sum(), min=1.0)
    if pred.ndim == 2:
        return 0.5 * torch.dot(((pred - targets) ** 2).sum(-1),
                               weights.reshape(-1)) / w
    return 0.5 * (((pred - targets) ** 2).sum(-1) * weights).sum() / w


class FrameShuffler:
    """Host analogue of MatrixRandomizer: shuffle frames across utterances
    and emit fixed-size minibatches. feats and targets are numpy arrays or
    tensors (indexed on their own device)."""

    def __init__(self, feats, targets, minibatch: int = 256, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.feats, self.targets = feats, targets
        self.minibatch = minibatch

    def _take(self, a, idx: np.ndarray):
        if isinstance(a, torch.Tensor):
            return a[torch.as_tensor(idx, device=a.device)]
        return a[idx]

    def __iter__(self):
        # a fresh permutation per pass; the tail wraps with frames from the
        # permutation's head, so every frame is trained on every epoch
        order = self.rng.permutation(len(self.feats))
        n = len(order)
        if n >= self.minibatch and n % self.minibatch:
            order = np.concatenate(
                [order, order[: self.minibatch - n % self.minibatch]])
        for lo in range(0, len(order) - self.minibatch + 1,
                        self.minibatch):
            idx = order[lo: lo + self.minibatch]
            yield self._take(self.feats, idx), self._take(self.targets, idx)


@dataclasses.dataclass
class StreamTrainOpts:
    num_streams: int = 4          # S parallel utterances
    bptt_chunk: int = 20          # truncated-BPTT length (frames)
    learning_rate: float = 1e-2
    num_epochs: int = 1
    grad_clip: float = 5.0


def _detach_states(states):
    return [tuple(s.detach() for s in st) if st is not None else None
            for st in states]


def train_lstm_streams(model, params: dict, utts, opts: StreamTrainOpts):
    """Multi-stream truncated BPTT (ref: nnet-train-lstm-streams.cc) where
    the params are.

    utts: list of (feats [T, D], targets [T]). Streams are filled with
    utterances; each step consumes `bptt_chunk` frames per stream with the
    LSTM state carried across chunks (detached: the gradient stops at the
    chunk boundary) and zeroed, out of place, in a stream whose utterance
    changes. -> (params, history of per-epoch mean loss)."""
    tx = optim.chain(optim.clip_by_global_norm(opts.grad_clip),
                     optim.sgd(opts.learning_rate))
    opt_state = tx.init(params)
    dev = next(iter(params.values())).device
    S, K = opts.num_streams, opts.bptt_chunk
    D = utts[0][0].shape[1]

    def step(params, opt_state, states, x, t, w):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            log_post, new_states = model.apply(leaves, x, states)
            loss, _acc = xent_loss(log_post, t, w)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            updates, opt_state = tx.update(dict(zip(leaves, grads)),
                                           opt_state, params)
            params = optim.apply_updates(params, updates)
        return params, opt_state, _detach_states(new_states), loss.detach()

    hist = []
    for _epoch in range(opts.num_epochs):
        queue = list(utts)
        cur = [None] * S        # per-stream (feats, targets, position)
        states = None           # model states; reset per stream
        losses = []
        while True:
            # refill streams
            for s in range(S):
                if cur[s] is None or cur[s][2] >= len(cur[s][0]):
                    if queue:
                        f, t = queue.pop(0)
                        cur[s] = (f, t, 0)
                        if states is not None:
                            # zero this stream's carried state
                            idx = torch.tensor([s], device=dev)
                            states = [
                                tuple(part.index_fill(0, idx, 0.0)
                                      for part in layer_st)
                                if layer_st is not None else None
                                for layer_st in states]
                    else:
                        cur[s] = None
            if all(c is None for c in cur):
                break
            x = np.zeros((S, K, D), np.float32)
            t = np.zeros((S, K), np.int32)
            w = np.zeros((S, K), np.float32)
            for s in range(S):
                if cur[s] is None:
                    continue
                f, tt, pos = cur[s]
                n = min(K, len(f) - pos)
                x[s, :n] = f[pos: pos + n]
                t[s, :n] = tt[pos: pos + n]
                w[s, :n] = 1.0
                cur[s] = (f, tt, pos + n)
            params, opt_state, states, loss = step(
                params, opt_state, states,
                *(torch.as_tensor(a, device=dev) for a in (x, t, w)))
            losses.append(float(loss))
        hist.append(float(np.mean(losses)) if losses else 0.0)
    return params, hist
