"""Conversion between kaldi_tpu params pytrees and the port's modules.

The JAX `Tdnn` keeps its weights as a pytree
`{"layers": [{"w": [in, out], "b": [out]}, ...], "final": {"w", "b"}}`
(kaldi_tpu/nnet/tdnn.py `Tdnn.init`), and `quantize_tdnn` makes the int8
tree `{"layers": [{"wq": [out, in], "scale", "b"}], "final": {...}}`. The
port keeps the same layouts, so conversion copies leaf for leaf. Leaves are numpy arrays (or
anything `np.asarray` takes); this module never imports jax.

The port's params dicts are named as `state_dict()` names them
("layers.0.w"); `name_to_keystr` and `keystr_to_name` map such a name to
and from the `jax.tree_util.keystr` of the same leaf ("['layers'][0]['w']"),
which keys checkpoints and NG-SGD's `param_filter` in the JAX package.

The GMMs and the i-vector extractor are numpy objects in both packages;
their converters copy the arrays into the port's classes, as do those of
the speaker-recognition objects (`plda_from_jax`,
`logistic_regression_from_jax`, and `sre_system_from_jax` for a whole
system: UBM, extractor, PLDA and options). A monophone
GMM-HMM (`mono_model_from_jax`) is copied pdf by pdf, with its transition
log-probs; a triphone GMM-HMM (`tri_model_from_jax`) also carries its
decision tree across (`event_map_from_jax`, rebuilt node for node into the
port's classes), and the LDA+MLLT and SAT models their transforms
(`lda_mllt_model_from_jax`, `sat_model_from_jax`). Lattices
(`lattice_from_jax`) are copied arc for arc, and an fMPE transform
(`fmpe_from_jax`) with its projection and posterior GMM.

The neural families: an nnet3 params tree {component: {"w", "b"}} maps to
the `Nnet3` state-dict names, whose component part escapes the dots of
the component name (`nnet3_params_from_jax` / `nnet3_params_to_jax`);
nnet1's list of per-component dicts and the projected LSTM's tree map to
their dotted tree paths ("0.w", "layers.0.fwd.w_gifo_x":
`nnet1_params_from_jax`, `lstm_params_from_jax`, through
`flatten_tree`, the inverse of `params_to_jax`). An RBM carries its
weights, biases and momentum velocities (`rbm_from_jax`), an `AmNnet3`
its config, params and priors (`am_nnet3_from_jax`).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.gmm.full_gmm import FullGmm
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
from kaldi_tpu_torch.steps.mono import MonoModel
from kaldi_tpu_torch.tree import event_map as em
from kaldi_tpu_torch.tree.context_dep import (MonophoneContextDependency,
                                              TreeContextDependency)


def tdnn_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX Tdnn params pytree -> state dict of `kaldi_tpu_torch.nnet.tdnn.Tdnn`
    (f32 CPU tensors; `load_state_dict` copies them to the module's device)."""
    out = {}
    for i, layer in enumerate(tree["layers"]):
        out[f"layers.{i}.w"] = torch.from_numpy(
            np.array(layer["w"], np.float32))
        out[f"layers.{i}.b"] = torch.from_numpy(
            np.array(layer["b"], np.float32))
    out["final.w"] = torch.from_numpy(np.array(tree["final"]["w"], np.float32))
    out["final.b"] = torch.from_numpy(np.array(tree["final"]["b"], np.float32))
    return out


def tdnn_qparams_from_jax(qtree) -> dict[str, torch.Tensor]:
    """`quantize_tdnn` pytree {"layers": [{"wq", "scale", "b"}], "final"}
    -> state dict of `kaldi_tpu_torch.nnet.quantized.QuantizedTdnn` (CPU
    tensors: wq int8 [out, in], scale and b f32 [out])."""
    out = {}
    named = [(f"layers.{i}", l) for i, l in enumerate(qtree["layers"])]
    for name, leaf in named + [("final", qtree["final"])]:
        out[f"{name}.wq"] = torch.from_numpy(np.array(leaf["wq"], np.int8))
        out[f"{name}.scale"] = torch.from_numpy(
            np.array(leaf["scale"], np.float32))
        out[f"{name}.b"] = torch.from_numpy(np.array(leaf["b"], np.float32))
    return out


def random_tdnn_params(config, rng: np.random.Generator) -> dict:
    """Seeded random weights in the JAX pytree layout, drawn with numpy so
    both frameworks can be fed the same arrays. Hidden layers use
    `affine_init`'s stddevs (weights 1/sqrt(in), biases 1); the final layer
    gets weights of stddev 1/sqrt(in) and zero bias, so that acoustic costs
    are not all tied as with `Tdnn.init`'s zero final layer."""
    layers = []
    in_dim = config.feat_dim
    for ctx in config.splice_indexes:
        spliced = in_dim * len(ctx)
        layers.append({
            "w": (rng.standard_normal((spliced, config.hidden_dim))
                  / np.sqrt(spliced)).astype(np.float32),
            "b": rng.standard_normal(config.hidden_dim).astype(np.float32)})
        in_dim = (config.pnorm_output_dim if config.nonlinearity == "pnorm"
                  else config.hidden_dim)
    final = {"w": (rng.standard_normal((in_dim, config.num_pdfs))
                   / np.sqrt(in_dim)).astype(np.float32),
             "b": np.zeros(config.num_pdfs, np.float32)}
    return {"layers": layers, "final": final}


def tdnn_params_to_jax(model) -> dict:
    """The inverse: a port Tdnn -> JAX-layout pytree with numpy leaves."""
    return params_to_jax(model.state_dict())


def params_to_jax(params: dict) -> dict:
    """A params dict named as `state_dict()` names it ("layers.0.w") ->
    the equivalent JAX pytree with numpy leaves (a numeric part indexes a
    list: {"layers": [{"w": ...}], ...}). bf16 leaves become f32."""
    root: dict = {}
    for name, t in params.items():
        parts = name.split(".")
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            key = int(part) if part.isdigit() else part
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = child
                node = node[key]
            else:
                node = node.setdefault(key, child)
        leaf = t.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        node[parts[-1]] = leaf.numpy()
    return root


def name_to_keystr(name: str) -> str:
    """"layers.0.w" -> "['layers'][0]['w']", the `jax.tree_util.keystr`
    of the same leaf in the JAX pytree."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def keystr_to_name(key: str) -> str:
    """The inverse of `name_to_keystr`; an attribute part (".trace", of a
    NamedTuple field) becomes a name part too."""
    parts, pos = [], 0
    while pos < len(key):
        m = _KEY_PART.match(key, pos)
        if m is None:
            raise ValueError(f"not a keystr: {key!r}")
        parts.append(next(g for g in m.groups() if g is not None))
        pos = m.end()
    return ".".join(parts)


def diag_gmm_from_jax(gmm):
    """A kaldi_tpu `DiagGmm` (numpy weights, means, vars) -> the port's."""
    return DiagGmm(gmm.weights, gmm.means, gmm.vars)


def full_gmm_from_jax(gmm):
    """A kaldi_tpu `FullGmm` (numpy weights, means, covars) -> the port's."""
    return FullGmm(gmm.weights, gmm.means, gmm.covars)


def ivector_extractor_from_jax(ext):
    """A kaldi_tpu `IvectorExtractor` (numpy means, inv_covars, weights, M,
    prior_offset) -> the port's, with the same parameters."""
    return IvectorExtractor.from_arrays(ext.means, ext.inv_covars,
                                        ext.weights, ext.M, ext.prior_offset)


def plda_from_jax(plda):
    """A kaldi_tpu `Plda` (numpy mean, transform, psi) -> the port's."""
    from kaldi_tpu_torch.ivector.plda import Plda
    return Plda(mean=np.array(plda.mean, np.float64),
                transform=np.array(plda.transform, np.float64),
                psi=np.array(plda.psi, np.float64))


def logistic_regression_from_jax(lr):
    """A kaldi_tpu `LogisticRegression` (numpy weights [C, D+1]) -> the
    port's."""
    from kaldi_tpu_torch.ivector.logistic_regression import \
        LogisticRegression
    return LogisticRegression(None if lr.weights is None
                              else np.array(lr.weights))


def sre_system_from_jax(system, device="cuda"):
    """A kaldi_tpu `SreSystem` -> the port's on `device`: its full UBM,
    extractor and PLDA copied, its options rebuilt field for field (VAD
    options included), its `post_fn` kept."""
    import dataclasses
    from kaldi_tpu_torch.ivector.vad import VadOpts
    from kaldi_tpu_torch.steps.sre import SrePipelineOpts, SreSystem
    fields = dataclasses.asdict(system.opts)
    fields["vad"] = VadOpts(**fields["vad"])
    return SreSystem(ubm=full_gmm_from_jax(system.ubm),
                     extractor=ivector_extractor_from_jax(system.extractor),
                     plda=plda_from_jax(system.plda),
                     opts=SrePipelineOpts(**fields), post_fn=system.post_fn,
                     device=device)


def mono_model_from_jax(model, lang, device="cuda"):
    """A kaldi_tpu `MonoModel` -> the port's `MonoModel` over `lang`, the
    port's own Lang of the same lexicon: each pdf's DiagGmm copied into an
    `AmDiagGmm` on `device`, and the transition log-probs (through
    `state_dict` / `load_log_probs`) into a `TransitionModel` built from
    `lang`'s topology, whose tuples must equal the JAX model's."""
    ctx = MonophoneContextDependency.from_topo(lang.topo)
    tm = TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    return _gmm_model_from_jax(model, lang, ctx, tm, device)


def event_map_from_jax(node):
    """A kaldi_tpu EventMap tree -> the same tree of the port's classes
    (`ConstantEventMap`, `TableEventMap`, `SplitEventMap`), table order
    kept."""
    kind = type(node).__name__
    if kind == "ConstantEventMap":
        return em.ConstantEventMap(int(node.answer))
    if kind == "TableEventMap":
        return em.TableEventMap(node.key, {v: event_map_from_jax(m)
                                           for v, m in node.table.items()})
    if kind == "SplitEventMap":
        return em.SplitEventMap(node.key, node.yes_set,
                                event_map_from_jax(node.yes),
                                event_map_from_jax(node.no))
    raise TypeError(f"not a kaldi_tpu event map: {kind}")


def tri_model_from_jax(model, lang, device="cuda"):
    """A kaldi_tpu tied-triphone `MonoModel` (a `TreeContextDependency`
    over an event map) -> the port's: the tree rebuilt by
    `event_map_from_jax`, the transition model rebuilt from it and `lang`
    (`transition_model_from_tree`, whose tuples must equal the JAX
    model's) with the log-probs copied, and each pdf's DiagGmm copied into
    an `AmDiagGmm` on `device`."""
    from kaldi_tpu_torch.steps.deltas import transition_model_from_tree
    c = model.ctx_dep
    ctx = TreeContextDependency(c.context_width, c.central_position,
                                event_map_from_jax(c.event_map), c.num_pdfs)
    return _gmm_model_from_jax(model, lang, ctx,
                               transition_model_from_tree(lang, ctx), device)


def lda_mllt_model_from_jax(lda, lang, device="cuda"):
    """A kaldi_tpu `LdaMlltModel` -> the port's: its triphone model by
    `tri_model_from_jax`, its [lda_dim, D_spliced + 1] transform copied."""
    from kaldi_tpu_torch.steps.lda_mllt import LdaMlltModel
    return LdaMlltModel(tri_model_from_jax(lda.model, lang, device),
                        np.array(lda.transform, np.float64))


def sat_model_from_jax(sat, lang, device="cuda"):
    """A kaldi_tpu `SatModel` -> the port's: its triphone model by
    `tri_model_from_jax`, each speaker's [D, D+1] transform copied."""
    from kaldi_tpu_torch.steps.sat import SatModel
    return SatModel(tri_model_from_jax(sat.model, lang, device),
                    {spk: np.array(w) for spk, w in sat.transforms.items()})


def _gmm_model_from_jax(model, lang, ctx, tm, device):
    """The JAX model's transition log-probs and pdfs into the port's `tm`
    (whose tuples must equal the JAX model's) and a new `AmDiagGmm`."""
    sd = model.trans_model.state_dict()
    if not np.array_equal(np.asarray(tm.tuples, np.int32).reshape(-1, 3),
                          np.asarray(sd["tuples"]).reshape(-1, 3)):
        raise ValueError("the JAX model's transition tuples differ from "
                         "the ones `lang` gives")
    tm.load_log_probs(np.asarray(sd["log_probs"]))
    am = AmDiagGmm([diag_gmm_from_jax(p) for p in model.am.pdfs], device)
    return MonoModel(am, tm, ctx, lang)


def lattice_from_jax(lat):
    """A kaldi_tpu `Lattice` -> the port's: states, arcs in their order
    (with a determinized arc's tid string), finals and start copied."""
    from kaldi_tpu_torch.lat.lattice import Lattice
    out = Lattice()
    for s, arcs in enumerate(lat.arcs):
        out.add_state()
        for a in arcs:
            out.add_arc(s, int(a.ilabel), int(a.olabel), a.graph_cost,
                        a.acoustic_cost, int(a.nextstate))
            if a.tids:
                out.arcs[s][-1].tids = tuple(int(t) for t in a.tids)
    out.start = int(lat.start)
    out.finals = {int(s): (float(g), float(a))
                  for s, (g, a) in lat.finals.items()}
    return out


def fmpe_from_jax(fmpe):
    """A kaldi_tpu `Fmpe` -> the port's: the posterior GMM, the options
    and the projection M copied."""
    import dataclasses
    from kaldi_tpu_torch.transform.fmpe import Fmpe, FmpeOptions
    out = Fmpe(diag_gmm_from_jax(fmpe.gmm), fmpe.dim,
               FmpeOptions(**dataclasses.asdict(fmpe.opts)))
    out.M = np.array(fmpe.M, np.float64)
    return out


def flatten_tree(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """A nested tree of dicts and lists with array leaves -> f32 CPU
    tensors named by their dotted path ("layers.0.fwd.w"), the inverse of
    `params_to_jax`'s naming."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: torch.from_numpy(np.array(tree, np.float32))}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def nnet3_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """kaldi_tpu `Nnet3` params {component: {leaf: array}} -> the port's
    `Nnet3` state dict (f32 CPU tensors)."""
    from kaldi_tpu_torch.nnet3.network import param_name
    return {param_name(c, leaf): torch.from_numpy(np.array(v, np.float32))
            for c, leaves in tree.items() for leaf, v in leaves.items()}


def nnet3_params_to_jax(params: dict) -> dict:
    """The inverse: the port's `Nnet3` params -> {component: {leaf: numpy
    array}}."""
    from kaldi_tpu_torch.nnet3.network import split_param_name
    out: dict = {}
    for name, t in params.items():
        c, leaf = split_param_name(name)
        out.setdefault(c, {})[leaf] = t.detach().cpu().numpy()
    return out


def nnet1_params_from_jax(params_list) -> dict[str, torch.Tensor]:
    """kaldi_tpu `Nnet1` params (one dict per component, empty for the
    parameterless ones) -> the port's {"<i>.<leaf>": tensor}."""
    return flatten_tree(list(params_list))


def lstm_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """kaldi_tpu `LstmProjected` params {"layers": [{"fwd": {...}, "bwd":
    ...}], "out_w", "out_b"} -> the port's flat dict."""
    return flatten_tree(tree)


def rbm_from_jax(rbm, device="cuda"):
    """A kaldi_tpu `Rbm` -> the port's: its config, W, biases and momentum
    velocities copied (f32 on `device`)."""
    import dataclasses
    from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
    out = Rbm(RbmConfig(**dataclasses.asdict(rbm.cfg)), device=device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=out.device)
    out.W, out.vis_bias, out.hid_bias = t(rbm.W), t(rbm.vis_bias), \
        t(rbm.hid_bias)
    out._vel = tuple(t(v) for v in rbm._vel)
    return out


def am_nnet3_from_jax(am, device="cuda"):
    """A kaldi_tpu `AmNnet3` -> the port's: an `Nnet3` of the same config
    text on `device` holding its params, and its priors."""
    from kaldi_tpu_torch.nnet3.network import Nnet3
    from kaldi_tpu_torch.nnet3.training import AmNnet3
    net = Nnet3(am.model.config_text, device=device)
    net.load_state_dict(nnet3_params_from_jax(am.params))
    return AmNnet3(net, np.array(am.priors))
