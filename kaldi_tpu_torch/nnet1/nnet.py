"""nnet1 component-stack networks: proto parsing, forward, SGD.

Counterpart of kaldi_tpu/nnet1/nnet.py (ref: nnet/nnet-nnet.h:36 Nnet, a
vector of components run in sequence; nnetbin/nnet-initialize.cc, proto
-> random net; the `<AffineTransform> <InputDim> ..` proto line format).

Components: AffineTransform, Sigmoid, Tanh, ReLU, Softmax, Splice,
AddShift, Rescale. As in JAX the net is a list of (kind, static config)
and the params live outside it: here a dict named "<index>.<leaf>"
("0.w", "0.b", "4.s"), the dotted form of JAX's list of per-component
dicts (`params.nnet1_params_from_jax`). `save_nnet1` / `load_nnet1` use
JAX's npz layout, so each package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.nnet import optim
from kaldi_tpu_torch.nnet.components import splice


@dataclasses.dataclass
class Component:
    kind: str
    in_dim: int
    out_dim: int
    extra: tuple = ()          # e.g. splice offsets


_MARKER = re.compile(r"<(\w+)>")


def parse_proto(text: str) -> list[Component]:
    comps = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line == "<NnetProto>" \
                or line == "</NnetProto>":
            continue
        toks = line.split()
        m = _MARKER.match(toks[0])
        if not m:
            raise ValueError(f"bad proto line: {line}")
        kind = m.group(1)
        kv = {}
        i = 1
        while i < len(toks):
            key = _MARKER.match(toks[i])
            if key and i + 1 < len(toks):
                kv[key.group(1)] = toks[i + 1]
                i += 2
            else:
                i += 1
        in_dim = int(kv.get("InputDim", 0))
        out_dim = int(kv.get("OutputDim", in_dim))
        extra = ()
        if kind == "Splice":
            extra = tuple(int(t) for t in
                          kv.get("BuildVector", "0").strip("()")
                          .replace(":", " ").split())
        comps.append(Component(kind, in_dim, out_dim, extra))
    return comps


class Nnet1:
    """Sequential component stack (ref: nnet/nnet-nnet.h Nnet). `init`
    puts its params on `device`; `apply` runs where the params are."""

    PARAMETRIC = {"AffineTransform"}

    def __init__(self, components: list[Component], device="cuda"):
        self.components = components
        self.device = resolve_device(device)

    @classmethod
    def from_proto(cls, text: str, device="cuda") -> "Nnet1":
        return cls(parse_proto(text), device)

    @property
    def input_dim(self) -> int:
        return self.components[0].in_dim

    @property
    def output_dim(self) -> int:
        return self.components[-1].out_dim

    def to_proto(self) -> str:
        lines = ["<NnetProto>"]
        for c in self.components:
            extra = ""
            if c.kind == "Splice":
                extra = " <BuildVector> " + ":".join(map(str, c.extra))
            lines.append(f"<{c.kind}> <InputDim> {c.in_dim} "
                         f"<OutputDim> {c.out_dim}{extra}")
        lines.append("</NnetProto>")
        return "\n".join(lines) + "\n"

    def init(self, generator: torch.Generator | None = None,
             param_stddev: float = 0.1) -> dict[str, torch.Tensor]:
        """Affine weights N(0, param_stddev^2) (drawn on the generator's
        device, in component order), zero biases and shifts, unit
        rescales; on the net's device."""
        gdev = generator.device if generator is not None else None
        params = {}
        for i, c in enumerate(self.components):
            if c.kind == "AffineTransform":
                w = torch.randn(c.out_dim, c.in_dim, generator=generator,
                                device=gdev) * param_stddev
                params[f"{i}.w"] = w.to(self.device)
                params[f"{i}.b"] = torch.zeros(c.out_dim, device=self.device)
            elif c.kind == "AddShift":
                params[f"{i}.b"] = torch.zeros(c.in_dim, device=self.device)
            elif c.kind == "Rescale":
                params[f"{i}.s"] = torch.ones(c.in_dim, device=self.device)
        return params

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x [..., T, D] -> output; Softmax yields log-probabilities (the
        decoder-facing convention)."""
        for i, c in enumerate(self.components):
            if c.kind == "AffineTransform":
                x = torch.matmul(x, params[f"{i}.w"].T) + params[f"{i}.b"]
            elif c.kind == "Sigmoid":
                x = torch.sigmoid(x)
            elif c.kind == "Tanh":
                x = torch.tanh(x)
            elif c.kind == "ReLU":
                x = torch.relu(x)
            elif c.kind == "Softmax":
                x = torch.log_softmax(x, dim=-1)
            elif c.kind == "Splice":
                x = splice(x, c.extra)
            elif c.kind == "AddShift":
                x = x + params[f"{i}.b"]
            elif c.kind == "Rescale":
                x = x * params[f"{i}.s"]
            else:
                raise ValueError(f"unknown component {c.kind}")
        return x

    def concat(self, other: "Nnet1") -> "Nnet1":
        return Nnet1(self.components + other.components, self.device)


def save_nnet1(path: str, net: Nnet1, params: dict) -> None:
    """JAX's npz layout: the proto as bytes, "n" (the component count) and
    "c<i>.<leaf>" arrays."""
    blobs = {"proto": np.frombuffer(net.to_proto().encode(), np.uint8),
             "n": np.int64(len(net.components))}
    for name, v in params.items():
        blobs[f"c{name}"] = v.detach().cpu().numpy()
    with open(path, "wb") as f:
        np.savez(f, **blobs)


def load_nnet1(path: str, device="cuda") -> tuple[Nnet1, dict]:
    """-> (net, params on `device`) from a file of either package."""
    z = np.load(path)
    net = Nnet1.from_proto(z["proto"].tobytes().decode(), device)
    params = {}
    for i in range(int(z["n"])):
        for key in z.files:
            if key.startswith(f"c{i}."):
                params[f"{i}.{key.split('.', 1)[1]}"] = torch.as_tensor(
                    z[key], device=net.device)
    return net, params


def train_frmshuff(net: Nnet1, params: dict, feats, targets,
                   learn_rate: float = 0.008, minibatch: int = 256,
                   num_epochs: int = 1, momentum: float = 0.0,
                   seed: int = 0):
    """Frame-shuffled cross-entropy SGD (ref: nnetbin/nnet-train-frmshuff.cc
    + nnet/nnet-randomizer.h) where the params are. feats [N, D] and
    targets [N] (numpy, or tensors on the params' device); every epoch
    shuffles with `seed`, as JAX's does. -> (params, history of the last
    minibatch's (loss, acc) per epoch)."""
    from kaldi_tpu_torch.nnet1.train import FrameShuffler
    from kaldi_tpu_torch.nnet.train import _grad_step

    dev = next(iter(params.values())).device
    minibatch = min(minibatch, len(feats))  # tiny corpora: one batch
    tx = optim.sgd(learn_rate, momentum=momentum)
    opt_state = tx.init(params)

    def loss_fn(p, x, t):
        lp = net.apply(p, x)
        ll = torch.gather(lp, -1, t[:, None])[:, 0]
        acc = torch.mean((torch.argmax(lp, dim=-1) == t).to(torch.float32))
        return -torch.mean(ll), acc

    hist = []
    for _ep in range(num_epochs):
        loss = acc = None
        for x, t in FrameShuffler(feats, targets, minibatch, seed=seed):
            x = torch.as_tensor(x, device=dev)
            t = torch.as_tensor(t, device=dev).long()
            params, opt_state, loss, acc = _grad_step(
                lambda p: loss_fn(p, x, t), tx, params, opt_state)
        hist.append((float(loss), float(acc)))
    return params, hist
