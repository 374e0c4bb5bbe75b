"""Config-defined computation-graph network (the nnet3 Nnet equivalent).

Counterpart of kaldi_tpu/nnet3/network.py (ref: nnet3/nnet-nnet.h:81,115
node kinds kInput / kComponent / kDescriptor / kOutput; config lines
parsed as nnet3/nnet-parse.h:145 ReadConfigFile reads them, e.g. those of
steps/nnet3/make_tdnn_configs.py):

    input-node name=input dim=40
    component name=l1.affine type=NaturalGradientAffineComponent \\
        input-dim=120 output-dim=512
    component-node name=l1.affine_node component=l1.affine \\
        input=Append(Offset(input,-1), input, Offset(input,1))
    output-node name=output input=l1.affine_node objective=linear

`Nnet3` is an `nn.Module` that holds each component's parameters. The
parsing, dims, contexts and cycle analysis are JAX's host code, copied.
Two executors run the nodes over dense [B, T, D] tensors: a dense one for
feed-forward nets, and a recurrent one for nets with IfDefined reads or
cycles, which steps a Python loop over the output frames with JAX's ring
buffers (where JAX has one `lax.scan`). Autograd runs through both.

Component names hold dots ("tdnn0.affine") and torch refuses a dot in a
parameter or module name, so a component's parameters live under
`comp.<param_key(name)>` ("comp.tdnn0%2Eaffine.w"): `param_key` escapes
"%" and "." as %25 and %2E, and `component_of_key` inverts it.
"""

from __future__ import annotations

import dataclasses
import re
import shlex

import torch
import torch.nn.functional as F
from torch import nn

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.nnet3.components import COMPONENT_TYPES
from kaldi_tpu_torch.nnet3.descriptors import Descriptor, parse_descriptor


def param_key(component: str) -> str:
    """A component name as a torch module name: "%" -> "%25", "." ->
    "%2E"."""
    return component.replace("%", "%25").replace(".", "%2E")


_ESCAPE = re.compile(r"%(25|2E)")


def component_of_key(key: str) -> str:
    """The inverse of `param_key`."""
    return _ESCAPE.sub(lambda m: "%" if m.group(1) == "25" else ".", key)


def param_name(component: str, leaf: str) -> str:
    """The params-dict (state_dict) name of a component's leaf."""
    return f"comp.{param_key(component)}.{leaf}"


def split_param_name(name: str) -> tuple[str, str]:
    """The inverse of `param_name`: -> (component, leaf)."""
    prefix, key, leaf = name.split(".")
    if prefix != "comp":
        raise ValueError(f"not an Nnet3 param name: {name!r}")
    return component_of_key(key), leaf


@dataclasses.dataclass
class _Node:
    kind: str                 # 'input' | 'component' | 'output'
    name: str
    component: str = ""       # component name for component-nodes
    descriptor: Descriptor | None = None
    dim: int = 0
    objective: str = "linear"  # output nodes: 'linear' | 'quadratic'


def parse_config(text: str):
    """-> (nodes ordered, components dict name -> cfg dict)."""
    nodes, components = [], {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = shlex.split(line)
        kind = parts[0]
        kv: dict = {}
        last = None
        for p in parts[1:]:
            if "=" in p and not p.startswith(("(", ",")):
                k, v = p.split("=", 1)
                kv[k] = v
                last = k
            elif last is not None:
                # descriptors may contain spaces: glue continuation tokens
                kv[last] += p
            else:
                raise ValueError(f"bad config token {p!r} in: {line}")
        if kind == "input-node":
            nodes.append(_Node("input", kv["name"], dim=int(kv["dim"])))
        elif kind == "component":
            components[kv["name"]] = kv
        elif kind == "component-node":
            nodes.append(_Node("component", kv["name"],
                               component=kv["component"],
                               descriptor=parse_descriptor(kv["input"])))
        elif kind == "output-node":
            nodes.append(_Node("output", kv["name"],
                               descriptor=parse_descriptor(kv["input"]),
                               objective=kv.get("objective", "linear")))
        else:
            raise ValueError(f"unknown config line kind: {kind}")
    return nodes, components


class Nnet3(nn.Module):
    """forward(feats [B, T, D], output="output", pad_context=True) -> the
    output node's value [B, T(out), dim]. The parameters do not require
    gradients: training is functional (nnet3/training.py) through
    `torch.func.functional_call` with a params dict named as
    `state_dict()` names it."""

    def __init__(self, config_text: str, device="cuda"):
        super().__init__()
        self._device = resolve_device(device)
        self.config_text = config_text
        self.nodes, self.components = parse_config(config_text)
        self.by_name = {n.name: n for n in self.nodes}
        for comp in self.components.values():
            if comp["type"] not in COMPONENT_TYPES:
                raise ValueError(f"unknown component type {comp['type']}")
        self._compute_dims()
        self._compute_contexts()
        self._plan = None
        # parameters at the shapes of an init draw, zero until `init`
        self.comp = nn.ModuleDict()
        shape_gen = torch.Generator().manual_seed(0)
        for name, cfg in self.components.items():
            has_params, make, _apply = COMPONENT_TYPES[cfg["type"]]
            if not has_params:
                continue
            holder = nn.Module()
            for leaf, v in make(shape_gen, cfg).items():
                holder.register_parameter(leaf, nn.Parameter(
                    torch.zeros(v.shape, device=self._device),
                    requires_grad=False))
            self.comp[param_key(name)] = holder

    @property
    def device(self) -> torch.device:
        """Where the weights are, and so where the net runs."""
        p = next(self.parameters(), None)
        return self._device if p is None else p.device

    # --- static analysis (the ComputationGraphBuilder role) ---

    def _compute_dims(self):
        """Two phases so recurrent (cyclic) references resolve: component
        output dims come from their configs alone, then descriptors are
        validated against the complete dim table."""
        dims: dict = {}
        for n in self.nodes:
            if n.kind == "input":
                dims[n.name] = n.dim
            elif n.kind == "component":
                cfg = self.components[n.component]
                out_dim = cfg.get("output-dim", cfg.get("dim"))
                if out_dim is not None:
                    n.dim = int(out_dim)
                    dims[n.name] = n.dim
        for n in self.nodes:
            if n.kind == "component":
                cfg = self.components[n.component]
                in_dim = n.descriptor.dim(dims)
                want = int(cfg.get("input-dim", cfg.get("dim", in_dim)))
                if in_dim != want:
                    raise ValueError(
                        f"node {n.name}: descriptor dim {in_dim} != "
                        f"component input-dim {want}")
                if n.name not in dims:
                    n.dim = in_dim
                    dims[n.name] = in_dim
            elif n.kind == "output":
                n.dim = n.descriptor.dim(dims)
                dims[n.name] = n.dim
        self.dims = dims

    def _compute_contexts(self):
        """Accumulated (left, right) required context of every node against
        the input. IfDefined dependencies are optional (zero when absent)
        and add nothing, which gives recurrent nets a finite context."""
        ctx = {n.name: (0, 0) for n in self.nodes}
        non_input = [n for n in self.nodes if n.kind != "input"]
        for _ in range(len(self.nodes) + 1):
            changed = False
            for n in non_input:
                dl, dr = n.descriptor.context()
                l = r = 0
                for ref in n.descriptor.referenced(required_only=True):
                    bl, br = ctx[ref]
                    l = max(l, bl)
                    r = max(r, br)
                new = (l + dl, r + dr)
                if new != ctx[n.name]:
                    ctx[n.name] = new
                    changed = True
            if not changed:
                break
        else:
            raise ValueError(
                "required (non-IfDefined) dependencies form a cycle — "
                "recurrence must go through IfDefined")
        self.contexts = ctx
        outs = [n for n in self.nodes if n.kind == "output"]
        self.left_context, self.right_context = ctx[outs[0].name] \
            if outs else (0, 0)
        # recurrent iff a node reaches itself through the full (required
        # and optional) reference graph
        self.is_recurrent = self._has_cycle()
        self._has_ifdef = any(
            self._desc_has_ifdef(n.descriptor) for n in self.nodes
            if n.descriptor is not None)

    @staticmethod
    def _desc_has_ifdef(d) -> bool:
        if d.op == "ifdef":
            return True
        return any(Nnet3._desc_has_ifdef(a) for a in d.args)

    def _has_cycle(self) -> bool:
        names = {n.name for n in self.nodes}
        deps = {n.name: (n.descriptor.referenced() & names
                         if n.descriptor is not None else set())
                for n in self.nodes}
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {k: WHITE for k in deps}

        def visit(u):
            color[u] = GRAY
            for v in deps.get(u, ()):
                if color[v] == GRAY:
                    return True
                if color[v] == WHITE and visit(v):
                    return True
            color[u] = BLACK
            return False

        return any(color[k] == WHITE and visit(k) for k in deps)

    # --- parameters ---

    def params(self) -> dict[str, torch.Tensor]:
        """A copy of the weights as a params dict, named as `state_dict()`
        names them (what the train step takes)."""
        return {k: v.detach().clone() for k, v in self.state_dict().items()}

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None
             ) -> dict[str, torch.Tensor]:
        """Draw every component's parameters in config order, as JAX's
        `init` does (its stddevs, not its draws), in place. -> `params()`."""
        for name, cfg in self.components.items():
            has_params, make, _apply = COMPONENT_TYPES[cfg["type"]]
            if has_params:
                holder = self.comp[param_key(name)]
                for leaf, v in make(generator, cfg).items():
                    getattr(holder, leaf).copy_(v)
        return self.params()

    def num_params(self, params: dict | None = None) -> int:
        leaves = (params.values() if params is not None
                  else self.parameters())
        return sum(p.numel() for p in leaves)

    def _component_params(self) -> dict:
        """{component name: {leaf: tensor}} as forward reads them (the
        params `functional_call` put in place, if any)."""
        return {component_of_key(key): {leaf: getattr(holder, leaf)
                                        for leaf, _p in
                                        holder._parameters.items()}
                for key, holder in self.comp.items()}

    # --- evaluation (the NnetComputer role) ---

    def forward(self, feats: torch.Tensor, output: str = "output",
                pad_context: bool = True) -> torch.Tensor:
        """feats [B, T, D]. pad_context=True edge-clamps, so the output has
        T frames (decode mode); False consumes the context (training
        chunks)."""
        params = self._component_params()
        lc, rc = self.left_context, self.right_context
        x = feats
        if pad_context and (lc or rc):
            x = torch.cat([x[:, :1].expand(-1, lc, -1), x,
                           x[:, -1:].expand(-1, rc, -1)], dim=1)
        if self.is_recurrent or self._has_ifdef:
            return self._apply_scan(params, x, output)
        T_in = x.shape[1]
        # values[name] = (tensor over its own valid frames, origin index):
        # node n's tensor covers frames [ctx_l(n), T_in - ctx_r(n))
        values: dict = {}
        for n in self.nodes:
            if n.kind == "input":
                values[n.name] = (x, 0)
                continue
            out = self._eval_dense(n, params, values, T_in)
            values[n.name] = (out, 0)
            if n.kind == "output" and n.name == output:
                return out
        return values[output][0]

    def _eval_dense(self, n, params, values, T_in: int) -> torch.Tensor:
        """Node n over its window of valid frames: each child's read is
        relative to the child's own origin."""
        l, r = self.contexts[n.name]
        length = T_in - l - r
        child_vals = {}
        for ref in n.descriptor.referenced():
            t_ref, _origin = values[ref]
            bl, _br = self.contexts[ref]
            # offset of this node's first frame within the child tensor
            child_vals[ref] = (t_ref, l - bl)
        out = n.descriptor.evaluate(child_vals, 0, length)
        if n.kind == "component":
            cfg = self.components[n.component]
            apply_fn = COMPONENT_TYPES[cfg["type"]][2]
            out = apply_fn(params.get(n.component), out, cfg)
        return out

    # --- recurrent executor (the looped computation of the nnet3 compiler
    #     for RNN / LSTM configs, ref: nnet3/nnet-compile-looped.h): a loop
    #     over the output frames with ring buffers carrying the
    #     IfDefined(Offset(..., -k)) recurrences ---

    def _scan_plan(self) -> dict:
        """The nodes that must step (those on or downstream of a cycle, and
        those with IfDefined reads), their intra-step order, each one's
        ring-buffer depth and the (dense node, offset) windows they read.
        Raises on a positive offset into a stepped node and on a
        zero-delay cycle."""
        if self._plan is not None:
            return self._plan
        names = {n.name for n in self.nodes}
        # nodes transitively depending on a cycle run inside the loop;
        # everything else (a feed-forward prefix) stays dense
        deps = {n.name: ({r for (r, _o, _p) in n.descriptor.ref_offsets()}
                         & names if n.descriptor is not None else set())
                for n in self.nodes}
        on_cycle = self._cycle_nodes(deps)
        scan_set = set()

        def taints(u, seen):
            if u in seen:
                return u in scan_set
            seen.add(u)
            if u in on_cycle or any(
                    taints(v, seen) for v in deps.get(u, ())):
                scan_set.add(u)
                return True
            return False

        for n in self.nodes:
            taints(n.name, set())
        # IfDefined-containing acyclic nodes also need step semantics (their
        # reads may fall out of range)
        for n in self.nodes:
            if n.descriptor is not None and \
                    self._desc_has_ifdef(n.descriptor) and \
                    n.name not in scan_set:
                scan_set.add(n.name)
        # anything reading a stepped node must itself step
        changed = True
        while changed:
            changed = False
            for n in self.nodes:
                if n.name not in scan_set and deps[n.name] & scan_set:
                    scan_set.add(n.name)
                    changed = True

        scan_nodes = [n for n in self.nodes if n.name in scan_set]
        # ring-buffer sizes: the largest negative offset at which each
        # stepped node is read by another stepped node
        back: dict = {}
        pos_err = []
        for n in scan_nodes:
            for (r, off, _opt) in n.descriptor.ref_offsets():
                if r in scan_set:
                    if off > 0:
                        pos_err.append((n.name, r, off))
                    elif off < 0:
                        back[r] = max(back.get(r, 0), -off)
        if pos_err:
            raise ValueError(
                f"positive time offsets into recurrent nodes are not "
                f"supported by the causal scan executor: {pos_err}")
        # intra-step topological order over offset-0 references
        zero_deps = {n.name: {r for (r, off, _p)
                              in n.descriptor.ref_offsets()
                              if r in scan_set and off == 0}
                     for n in scan_nodes}
        order: list = []
        seen: dict = {}

        def visit(u):
            if seen.get(u) == 2:
                return
            if seen.get(u) == 1:
                raise ValueError(
                    f"zero-delay recurrence through {u} — every cycle "
                    f"needs a strictly negative Offset")
            seen[u] = 1
            for v in zero_deps.get(u, ()):
                visit(v)
            seen[u] = 2
            order.append(u)

        for n in scan_nodes:
            visit(n.name)
        node_of = {n.name: n for n in scan_nodes}
        pairs = sorted({(r, off) for n in scan_nodes
                        for (r, off, _p) in n.descriptor.ref_offsets()
                        if r not in scan_set})
        self._plan = dict(scan_set=scan_set, back=back, pairs=pairs,
                          order=[node_of[u] for u in order])
        return self._plan

    def _apply_scan(self, params, x: torch.Tensor, output: str
                    ) -> torch.Tensor:
        plan = self._scan_plan()
        scan_set = plan["scan_set"]
        lc = self.left_context
        T_in, B = x.shape[1], x.shape[0]
        T_out = T_in - lc - self.right_context

        # ---- dense prefix
        values: dict = {}
        for n in self.nodes:
            if n.name in scan_set:
                continue
            if n.kind == "input":
                values[n.name] = (x, 0)
                continue
            values[n.name] = (self._eval_dense(n, params, values, T_in), 0)

        if output not in scan_set:
            # the requested output is feed-forward (IfDefined only in an
            # unrelated branch): slice its dense value to the out window
            t_ref, _ = values[output]
            bl, _br = self.contexts[output]
            start = lc - bl
            return t_ref[:, start: start + T_out]

        # xs: for every (dense ref, offset) pair the stepped nodes read, a
        # [T_out, B, D] window, zero-padded out of range
        xs = {}
        for (r, off) in plan["pairs"]:
            t_ref, _orig = values[r]
            bl, _br = self.contexts[r]
            start = lc - bl + off
            pad_l = max(0, -start)
            pad_r = max(0, start + T_out - t_ref.shape[1])
            w = F.pad(t_ref, (0, 0, pad_l, pad_r))
            w = w[:, start + pad_l: start + pad_l + T_out]
            xs[(r, off)] = w.transpose(0, 1)                # [T_out, B, D]

        # ring buffers: bufs[name][:, j] = value at t - 1 - j
        bufs = {r: x.new_zeros((B, k, self.dims[r]))
                for r, k in plan["back"].items()}
        ys = []
        for t in range(T_out):
            vals: dict = {}

            def get(name, off, _opt):
                if name not in scan_set:
                    return xs[(name, off)][t]
                if off == 0:
                    return vals[name]
                return bufs[name][:, -off - 1]

            for n in plan["order"]:
                inp = n.descriptor.evaluate_step(get)
                if n.kind == "component":
                    cfg = self.components[n.component]
                    apply_fn = COMPONENT_TYPES[cfg["type"]][2]
                    inp = apply_fn(params.get(n.component), inp, cfg)
                vals[n.name] = inp
            bufs = {r: torch.cat([vals[r][:, None], bufs[r][:, :-1]], dim=1)
                    for r in bufs}
            ys.append(vals[output])
        if not ys:
            return x.new_zeros((B, 0, self.dims[output]))
        return torch.stack(ys, dim=1)

    @staticmethod
    def _cycle_nodes(deps: dict) -> set:
        """Names on at least one reference cycle (Tarjan SCCs, iterative)."""
        index: dict = {}
        low: dict = {}
        stack: list = []
        on_stack: set = set()
        counter = [0]
        out: set = set()

        def strongconnect(v0):
            work = [(v0, iter(deps.get(v0, ())))]
            index[v0] = low[v0] = counter[0]
            counter[0] += 1
            stack.append(v0)
            on_stack.add(v0)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in deps:
                        continue
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(deps.get(w, ()))))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == v:
                            break
                    if len(scc) > 1 or v in deps.get(v, ()):
                        out.update(scc)

        for v in deps:
            if v not in index:
                strongconnect(v)
        return out
