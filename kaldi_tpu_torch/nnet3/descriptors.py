"""The nnet3 Descriptor language over [B, T, D] tensors.

Counterpart of kaldi_tpu/nnet3/descriptors.py (ref:
nnet3/nnet-descriptor.h:41-54: Append, Sum, Offset, Scale, Round and
IfDefined over (n, t, x) indexes). Time is a dense tensor axis: Offset(X,
k) is a shift along T, Append concatenates along D, Sum adds. A
descriptor knows its (left, right) context, so the network computes how
many input frames produce T output frames (the role of the reference's
ComputationGraphBuilder dependency closure,
nnet3/nnet-computation-graph.h:97). The parser and the context arithmetic
are JAX's host code, copied; `evaluate` and `evaluate_step` work on torch
tensors.
"""

from __future__ import annotations

import dataclasses
import re

import torch


@dataclasses.dataclass
class Descriptor:
    op: str                   # 'ref' | 'offset' | 'append' | 'sum' | 'scale' | 'round'
    args: tuple = ()          # child descriptors
    name: str = ""            # for 'ref'
    t: int = 0                # for 'offset'
    scale: float = 1.0        # for 'scale'
    modulus: int = 1          # for 'round'

    # --- context arithmetic ---

    def context(self):
        """-> (left, right): how far this descriptor reaches in time.
        IfDefined subtrees contribute NOTHING: optional dependencies are
        zero when unavailable, so they impose no required context
        (ref: nnet-descriptor.h IfDefined — 'the arg if defined, else
        zero')."""
        if self.op == "ref":
            return (0, 0)
        if self.op == "ifdef":
            return (0, 0)
        if self.op == "offset":
            l, r = self.args[0].context()
            return (l + max(0, -self.t), r + max(0, self.t))
        if self.op in ("append", "sum"):
            ls, rs = zip(*(a.context() for a in self.args))
            return (max(ls), max(rs))
        if self.op in ("scale", "round"):
            return self.args[0].context()
        raise ValueError(self.op)

    def referenced(self, required_only: bool = False) -> set:
        if self.op == "ref":
            return {self.name}
        if self.op == "ifdef" and required_only:
            return set()
        out = set()
        for a in self.args:
            out |= a.referenced(required_only)
        return out

    def ref_offsets(self, _off: int = 0, _opt: bool = False) -> list:
        """-> [(name, accumulated_offset, optional)] over every leaf ref
        (the dependency list the reference's ComputationGraphBuilder
        derives, nnet-computation-graph.h:97)."""
        if self.op == "ref":
            return [(self.name, _off, _opt)]
        if self.op == "offset":
            return self.args[0].ref_offsets(_off + self.t, _opt)
        if self.op == "ifdef":
            return self.args[0].ref_offsets(_off, True)
        out = []
        for a in self.args:
            out.extend(a.ref_offsets(_off, _opt))
        return out

    def evaluate_step(self, get):
        """Per-frame evaluation for the recurrent (scan) executor:
        `get(name, offset, optional)` -> [B, D] value of `name` at the
        current frame + offset."""
        return self._step(get, 0, False)

    def _step(self, get, off: int, opt: bool):
        if self.op == "ref":
            return get(self.name, off, opt)
        if self.op == "offset":
            return self.args[0]._step(get, off + self.t, opt)
        if self.op == "ifdef":
            return self.args[0]._step(get, off, True)
        if self.op == "append":
            return torch.cat(
                [a._step(get, off, opt) for a in self.args], dim=-1)
        if self.op == "sum":
            parts = [a._step(get, off, opt) for a in self.args]
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        if self.op == "scale":
            return self.scale * self.args[0]._step(get, off, opt)
        if self.op == "round":
            return self.args[0]._step(get, off, opt)
        raise ValueError(self.op)

    def dim(self, dims: dict) -> int:
        if self.op == "ref":
            return dims[self.name]
        if self.op == "ifdef":
            return self.args[0].dim(dims)
        if self.op == "append":
            return sum(a.dim(dims) for a in self.args)
        if self.op == "sum":
            d = self.args[0].dim(dims)
            assert all(a.dim(dims) == d for a in self.args)
            return d
        return self.args[0].dim(dims)

    def evaluate(self, values: dict, offset: int, length: int):
        """Gather [B, length, dim] at time offset `offset` relative to each
        node's own valid-frame origin. `values[name] = (tensor, origin)`
        where origin is the node tensor's time index corresponding to the
        network's t=0."""
        if self.op == "ref":
            x, origin = values[self.name]
            start = origin + offset
            return x[:, start: start + length]
        if self.op == "offset":
            return self.args[0].evaluate(values, offset + self.t, length)
        if self.op == "ifdef":
            # dense path only reaches ifdef on fully-defined windows
            # (nets with possibly-undefined reads use the scan executor)
            return self.args[0].evaluate(values, offset, length)
        if self.op == "append":
            parts = [a.evaluate(values, offset, length) for a in self.args]
            return torch.cat(parts, dim=-1)
        if self.op == "sum":
            parts = [a.evaluate(values, offset, length) for a in self.args]
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        if self.op == "scale":
            return self.scale * self.args[0].evaluate(values, offset, length)
        if self.op == "round":
            # Round(x, m): dependency time rounded down to a multiple of m;
            # with dense frame-synchronous evaluation this is a no-op read
            # (the reference uses it for reduced-rate components)
            return self.args[0].evaluate(values, offset, length)
        raise ValueError(self.op)


_TOKEN = re.compile(r"[A-Za-z_][-A-Za-z0-9._]*|\(|\)|,|-?\d+\.?\d*")


def parse_descriptor(text: str) -> Descriptor:
    """Parse `Append(Offset(input, -2), input, Offset(input, 2))` etc.
    (ref: nnet3/nnet-descriptor.cc Descriptor::Parse)."""
    toks = _TOKEN.findall(text.replace(" ", ""))
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else None

    def take(expect=None):
        nonlocal pos
        t = toks[pos]
        if expect is not None and t != expect:
            raise ValueError(f"expected {expect}, got {t} in {text}")
        pos += 1
        return t

    def parse():
        t = take()
        if t in ("Append", "Sum"):
            take("(")
            args = [parse()]
            while peek() == ",":
                take(",")
                args.append(parse())
            take(")")
            return Descriptor(op=t.lower(), args=tuple(args))
        if t == "Offset":
            take("(")
            inner = parse()
            take(",")
            off = int(float(take()))
            take(")")
            return Descriptor(op="offset", args=(inner,), t=off)
        if t == "Scale":
            take("(")
            sc = float(take())
            take(",")
            inner = parse()
            take(")")
            return Descriptor(op="scale", args=(inner,), scale=sc)
        if t == "Round":
            take("(")
            inner = parse()
            take(",")
            m = int(float(take()))
            take(")")
            return Descriptor(op="round", args=(inner,), modulus=m)
        if t == "IfDefined":
            take("(")
            inner = parse()
            take(")")
            return Descriptor(op="ifdef", args=(inner,))
        if t in ("(", ")", ","):
            raise ValueError(f"unexpected {t} in {text}")
        return Descriptor(op="ref", name=t)

    d = parse()
    if pos != len(toks):
        raise ValueError(f"trailing tokens in descriptor: {text}")
    return d
