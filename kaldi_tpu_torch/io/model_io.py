"""Model file I/O: single-file save/load for trained systems.

Counterpart of kaldi_tpu/io/model_io.py (ref: the reference's
'everything is a file' contract — models are single-object Kaldi binary
files written every iteration and read back by ReadKaldiObject
(util/kaldi-io.h:234, SURVEY.md §5)). One .npz per model holding all
arrays + a JSON header for structure; host-side graph objects (topology,
tree) ride along pickled inside the npz, versioned.

The files are the JAX package's, key for key: the same npz names, dtypes,
JSON headers and FORMAT_VERSION, written through a file handle (no '.npz'
suffix is added). A model that either package saved loads in the other.
Each `load_*` builds the port's class; the ones whose class lives on a
device (the GMM system's `AmDiagGmm`, the nnets, the SGMM and its
statistics) take `device`, "cuda" unless the caller asks for the CPU.

Pickled host objects name their classes by module. The JAX package's
files name `kaldi_tpu.<module>`; `_loads` maps those (and the port's own
names) onto the port's host copies for an explicit allow-list of classes
(`HOST_CLASSES`), plus the numpy and builtin globals that arrays and sets
need, and refuses anything else. `_dumps` pickles at protocol 2, whose
GLOBAL opcodes spell module and class as text lines, and rewrites each
`kaldi_tpu_torch.` module to `kaldi_tpu.`, so the JAX package reads the
port's files with a plain `pickle.loads`.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import pickle
import pickletools

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device

FORMAT_VERSION = 1

#: the host classes a model file may pickle, by module under the package
HOST_CLASSES = {
    ("fst.fst", "Fst"), ("fst.fst", "SymbolTable"), ("fst.lang", "Lang"),
    ("hmm.topology", "HmmTopology"), ("hmm.topology", "HmmState"),
    ("tree.context_dep", "MonophoneContextDependency"),
    ("tree.context_dep", "TreeContextDependency"),
    ("tree.event_map", "ConstantEventMap"),
    ("tree.event_map", "TableEventMap"),
    ("tree.event_map", "SplitEventMap"),
    ("tree.clustering", "GaussStats"),
    ("nnet1.lstm", "LstmConfig"), ("nnet1.kl_hmm", "KlHmm"),
    ("transform.regtree", "RegressionTree"),
}
#: what arrays, numpy scalars and sets pickle through
SAFE_GLOBALS = {
    ("builtins", "frozenset"), ("builtins", "set"),
    ("__builtin__", "frozenset"), ("__builtin__", "set"),
    ("_codecs", "encode"), ("numpy", "dtype"), ("numpy", "ndarray"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"),
}
_JAX, _PORT = "kaldi_tpu.", "kaldi_tpu_torch."


class _HostUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in SAFE_GLOBALS:
            return super().find_class(module, name)
        for prefix in (_JAX, _PORT):
            if module.startswith(prefix):
                rel = module[len(prefix):]
                if (rel, name) in HOST_CLASSES:
                    return getattr(importlib.import_module(_PORT + rel), name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: not a host class of a "
            f"model file")


def _loads(data: bytes):
    """Unpickle a model file's host payload into the port's classes."""
    return _HostUnpickler(io.BytesIO(data)).load()


def _dumps(obj) -> bytes:
    """Pickle host objects as the JAX package's classes (see the module
    docstring); raises on a global outside the allow-lists."""
    raw = pickle.dumps(obj, protocol=2)
    out, last = bytearray(), 0
    for op, arg, pos in pickletools.genops(raw):
        if op.name != "GLOBAL":
            continue
        module, name = arg.split(" ", 1)
        if (module, name) in SAFE_GLOBALS:
            continue
        if not (module.startswith(_PORT)
                and (module[len(_PORT):], name) in HOST_CLASSES):
            raise pickle.PicklingError(f"{module}.{name} is not a host class "
                                       f"of a model file")
        old = f"c{module}\n{name}\n".encode()
        assert raw[pos:pos + len(old)] == old
        out += raw[last:pos]
        out += f"c{_JAX}{module[len(_PORT):]}\n{name}\n".encode()
        last = pos + len(old)
    out += raw[last:]
    return bytes(out)


class JaxNamePickler(pickle._Pickler):
    """The pure-Python pickler naming the port's classes by the JAX
    package's modules, as `_dumps` does at protocol 2, for the pickles
    that JAX writes at protocol 4 or later (`compile-questions`): the
    result is JAX's byte for byte and loads there."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", "")
        if self.proto < 4 or not module.startswith(_PORT):
            return super().save_global(obj, name)
        self.save(_JAX + module[len(_PORT):])
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=np.uint8)


def _np(x) -> np.ndarray:
    """A host array of a tensor (any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _savez(path: str, blobs: dict):
    # write through a file handle: np.savez(str) appends '.npz' when the
    # suffix is missing, which would break load(path-verbatim) round-trips
    with open(path, "wb") as f:
        np.savez(f, **blobs)


def _open(path: str, kind: bytes | None = None):
    z = np.load(path, allow_pickle=False)
    assert int(z["__version__"]) == FORMAT_VERSION
    if kind is not None:
        assert z["__kind__"].tobytes() == kind, \
            f"not a {kind.decode()} file"
    return z


# ------------------------------------------------------------- GMM system

def save_gmm_system(path: str, model) -> None:
    """Save a MonoModel-shaped system (am, trans_model, ctx_dep, lang)."""
    am = model.am
    blobs = {
        "__version__": np.int64(FORMAT_VERSION),
        "num_pdfs": np.int64(am.num_pdfs),
        "trans_log_probs": np.asarray(model.trans_model.log_probs),
    }
    for i, g in enumerate(am.pdfs):
        blobs[f"pdf{i}_weights"] = g.weights
        blobs[f"pdf{i}_means"] = g.means
        blobs[f"pdf{i}_vars"] = g.vars
    blobs["__host__"] = _u8(_dumps({
        "topo": model.lang.topo,
        "ctx_dep": model.ctx_dep,
        "lang": model.lang,
    }))
    _savez(path, blobs)


def load_gmm_system(path: str, device="cuda"):
    """-> MonoModel whose `AmDiagGmm` scores on `device`."""
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.steps.mono import MonoModel

    dev = resolve_device(device)
    z = _open(path)
    host = _loads(z["__host__"].tobytes())
    lang, ctx = host["lang"], host["ctx_dep"]
    pdfs = [DiagGmm(z[f"pdf{i}_weights"], z[f"pdf{i}_means"],
                    z[f"pdf{i}_vars"]) for i in range(int(z["num_pdfs"]))]
    tm = TransitionModel(lang.topo, lambda ph, pc: _pdfs_of(ctx, ph, pc))
    tm.load_log_probs(z["trans_log_probs"])
    return MonoModel(AmDiagGmm(pdfs, dev), tm, ctx, lang)


def _pdfs_of(ctx, phone, pdf_class):
    """Rebuild the (phone, pdf_class)->pdfs mapping from the saved tree
    (the ContextDependency::GetPdfInfo role)."""
    from kaldi_tpu_torch.tree.context_dep import MonophoneContextDependency
    if isinstance(ctx, MonophoneContextDependency):
        return ctx.compute([phone], pdf_class)
    from kaldi_tpu_torch.tree.event_map import KPDF_CLASS
    return ctx.event_map.multi_map(
        {KPDF_CLASS: pdf_class, ctx.central_position: phone})


# ------------------------------------------------------------------ graph

def save_hclg(path: str, packed) -> None:
    """Save a PackedGraph (the immutable decode graph artifact)."""
    _savez(path, dict(
        __version__=np.int64(FORMAT_VERSION),
        start=np.int64(packed.start),
        arc_start=packed.arc_start, ilabel=packed.ilabel,
        olabel=packed.olabel, cost=packed.cost, nextstate=packed.nextstate,
        pdf=(packed.pdf if packed.pdf is not None
             else np.zeros(0, np.int32)),
        final=packed.final))


def load_hclg(path: str):
    """-> PackedGraph (host arrays; a decoder puts it on its device)."""
    from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
    z = _open(path)
    pdf = z["pdf"] if z["pdf"].size else None
    return PackedGraph(start=int(z["start"]), arc_start=z["arc_start"],
                       ilabel=z["ilabel"], olabel=z["olabel"],
                       cost=z["cost"], nextstate=z["nextstate"],
                       pdf=pdf, final=z["final"])


# ------------------------------------------------------------------ nnets

def _in_leaf_order(model, layers: list) -> list:
    """A TDNN's hidden layers (JAX-layout dicts) with each layer's leaves
    in `model.leaf_order`, the order of the file it was loaded from or of
    the tree it was built from, when it names them: JAX's files list
    "w, b" after an init and "b, w" after a tree map, and a copy keeps
    its input's order."""
    order = getattr(model, "leaf_order", None)
    if not order or len(order) != len(layers) or any(
            sorted(o) != sorted(l) for o, l in zip(order, layers)):
        return layers
    return [{k: l[k] for k in o} for o, l in zip(order, layers)]


def _tdnn_blobs(kind: bytes, config, tree) -> tuple[dict, dict, dict]:
    """A TDNN file's header, final layer and hidden layers (JAX's layout),
    apart, since the AM file puts its priors between them."""
    blobs = {
        "__version__": np.int64(FORMAT_VERSION),
        "__kind__": _u8(kind),
        "config_json": _u8(json.dumps(dataclasses.asdict(config)).encode()),
    }
    return blobs, {
        "final_w": np.asarray(tree["final"]["w"]),
        "final_b": np.asarray(tree["final"]["b"]),
        "n_layers": np.int64(len(tree["layers"])),
    }, {f"layer{i}.{k}": np.asarray(v)
        for i, layer in enumerate(tree["layers"]) for k, v in layer.items()}


def _load_tdnn(z, device):
    """The file's Tdnn on `device`, shaped by its params."""
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.params import tdnn_params_from_jax
    cfg = json.loads(z["config_json"].tobytes().decode())
    cfg["splice_indexes"] = tuple(tuple(x) for x in cfg["splice_indexes"])
    tree = {
        "final": {"w": z["final_w"], "b": z["final_b"]},
        "layers": [{k.split(".", 1)[1]: z[k] for k in z.files
                    if k.startswith(f"layer{i}.")}
                   for i in range(int(z["n_layers"]))],
    }
    model = Tdnn.from_params(TdnnConfig(**cfg), tdnn_params_from_jax(tree),
                             device=device)
    model.leaf_order = [list(layer) for layer in tree["layers"]]
    return model


def save_am_nnet(path: str, am) -> None:
    """Save an AmNnet (Tdnn + params + priors) as one npz
    (ref: nnet2/am-nnet.h Write — model + priors in one object); the
    layers in JAX's layout (`layer{i}.w`, `final_w`, ...)."""
    from kaldi_tpu_torch.params import tdnn_params_to_jax
    tree = tdnn_params_to_jax(am.model)
    tree["layers"] = _in_leaf_order(am.model, tree["layers"])
    save_am_tree(path, am.model.config, tree, am.priors,
                 getattr(am, "group_ids", None),
                 getattr(am, "lr_scales", None), getattr(am, "meta", None))


def save_am_tree(path: str, config, tree, priors=None, group_ids=None,
                 lr_scales=None, meta=None) -> None:
    """An AmNnet file from a TdnnConfig and a JAX-layout tree of numpy
    arrays, each written as given (its leaf order and memory order: JAX
    writes a transposed output layer Fortran-ordered) and without a
    module, so the widths need not chain (JAX writes such files too).
    priors None: uniform over config.num_pdfs, as JAX's AmNnet."""
    if priors is None:
        priors = np.ones(config.num_pdfs) / config.num_pdfs
    head, final, layers = _tdnn_blobs(b"am_nnet2", config, tree)
    blobs = {**head, "priors": np.asarray(priors, np.float64), **final}
    if group_ids is not None:
        blobs["group_ids"] = np.asarray(group_ids, np.int32)
    if lr_scales:
        blobs["lr_scales_json"] = _u8(json.dumps(lr_scales).encode())
    if meta:
        blobs["meta_json"] = _u8(json.dumps(meta).encode())
    _savez(path, {**blobs, **layers})


def load_am_nnet(path: str, device="cuda"):
    """-> AmNnet whose TDNN is on `device`."""
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    dev = resolve_device(device)
    z = _open(path)
    gid = z["group_ids"] if "group_ids" in z.files else None
    lr = (json.loads(z["lr_scales_json"].tobytes().decode())
          if "lr_scales_json" in z.files else None)
    am = AmNnet(_load_tdnn(z, dev), z["priors"], group_ids=gid,
                lr_scales=lr)
    if "meta_json" in z.files:
        am.meta = json.loads(z["meta_json"].tobytes().decode())
    return am


def save_raw_nnet(path: str, model, params: dict | None = None) -> None:
    """Save a raw nnet (Tdnn + params, no priors / transition info)
    (ref: nnet2bin/nnet-to-raw-nnet.cc). `params` is a params dict named as
    `state_dict()` names it (the model's own weights when None)."""
    from kaldi_tpu_torch.params import params_to_jax
    tree = params_to_jax(model.state_dict() if params is None else params)
    tree["layers"] = _in_leaf_order(model, tree.get("layers", []))
    save_raw_tree(path, model.config, tree)


def save_raw_tree(path: str, config, tree) -> None:
    """A raw nnet file from a TdnnConfig and a JAX-layout tree, each
    array written as given (see `save_am_tree`)."""
    head, final, layers = _tdnn_blobs(b"raw_nnet2", config, tree)
    _savez(path, {**head, **final, **layers})


def load_raw_nnet(path: str, device="cuda"):
    """-> (Tdnn on `device`, its params dict)."""
    model = _load_tdnn(_open(path), resolve_device(device))
    return model, model.params()


def save_am_nnet3(path: str, am) -> None:
    """Save an AmNnet3 (config-defined net + params + priors): the nnet3
    write contract is the config text plus raw parameters
    (ref: nnet3/nnet-nnet.h Write — config lines + component params)."""
    from kaldi_tpu_torch.params import nnet3_params_to_jax
    blobs = {
        "__version__": np.int64(FORMAT_VERSION),
        "__kind__": _u8(b"am_nnet3"),
        "config_text": _u8(am.model.config_text.encode()),
        "priors": np.asarray(am.priors, np.float64),
    }
    tree = nnet3_params_to_jax(am.model.state_dict())
    keys = [(comp, k) for comp, leaf in tree.items() for k in leaf]
    order = getattr(am.model, "param_order", None)
    if order and sorted(order) == sorted(keys):
        keys = order          # the file's or the tree's order (a copy's)
    for comp, k in keys:
        blobs[f"param:{comp}:{k}"] = tree[comp][k]
    _savez(path, blobs)


def load_am_nnet3(path: str, device="cuda"):
    """-> AmNnet3 whose net is on `device`."""
    from kaldi_tpu_torch.nnet3.network import Nnet3
    from kaldi_tpu_torch.nnet3.training import AmNnet3
    from kaldi_tpu_torch.params import nnet3_params_from_jax
    z = _open(path)
    net = Nnet3(z["config_text"].tobytes().decode(), device=device)
    params: dict = {}
    for key in z.files:
        if key.startswith("param:"):
            _tag, comp, k = key.split(":", 2)
            params.setdefault(comp, {})[k] = z[key]
    net.load_state_dict(nnet3_params_from_jax(params))
    net.param_order = [(c, k) for c, leaf in params.items() for k in leaf]
    return AmNnet3(net, z["priors"])


# ------------------------------------------------------ speaker models, LM

def save_ivector_extractor(path: str, ext) -> None:
    """Save an IvectorExtractor (UBM params + factor loading matrix)
    (ref: ivector/ivector-extractor.h IvectorExtractor::Write)."""
    _savez(path, dict(
        __version__=np.int64(FORMAT_VERSION),
        __kind__=_u8(b"ivector_extractor"),
        means=ext.means, inv_covars=ext.inv_covars,
        weights=ext.weights, M=ext.M,
        prior_offset=np.float64(ext.prior_offset)))


def load_ivector_extractor(path: str):
    """-> IvectorExtractor (host arrays; its batch methods take a device)."""
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    z = _open(path)
    return IvectorExtractor.from_arrays(z["means"], z["inv_covars"],
                                        z["weights"], z["M"],
                                        float(z["prior_offset"]))


_CLM_ARRAYS = ("backoff_cost", "backoff_state", "row_lo", "col_word",
               "col_cost", "col_next")


def save_const_arpa(path: str, clm) -> None:
    """Save a built ConstArpaLm (the arpa-to-const-arpa artifact;
    ref: lm/const-arpa-lm.h ConstArpaLm::Write — packed arrays + the
    host-side history index rides pickled like the lang bundle)."""
    host = _dumps({
        "_hist_index": clm._hist_index,
        "_ext_index": clm._ext_index,
        "_state_hist": clm._state_hist,
        "order": clm.order, "bos": clm.bos, "eos": clm.eos,
        "unk_cost": clm.unk_cost,
    })
    _savez(path, dict(__version__=np.int64(FORMAT_VERSION),
                      __kind__=_u8(b"const_arpa"),
                      **{k: getattr(clm, k) for k in _CLM_ARRAYS},
                      __host__=_u8(host)))


def load_const_arpa(path: str):
    """-> ConstArpaLm (without re-parsing/re-packing the ARPA; its batch
    queries take a device)."""
    from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm
    z = _open(path)
    clm = ConstArpaLm.__new__(ConstArpaLm)
    for k, v in _loads(z["__host__"].tobytes()).items():
        setattr(clm, k, v)
    for k in _CLM_ARRAYS:
        setattr(clm, k, z[k])
    return clm


def save_ubm(path: str, ubm) -> None:
    """Save a DiagGmm or FullGmm UBM (ref: gmm-global-copy /
    fgmm-global-* single-object files)."""
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    blobs = {"__version__": np.int64(FORMAT_VERSION),
             "weights": np.asarray(ubm.weights),
             "means": np.asarray(ubm.means)}
    if isinstance(ubm, FullGmm):
        blobs["__kind__"] = _u8(b"full_ubm")
        blobs["covars"] = np.asarray(ubm.covars)
    else:
        blobs["__kind__"] = _u8(b"diag_ubm")
        blobs["vars"] = np.asarray(ubm.vars)
    _savez(path, blobs)


def load_ubm(path: str):
    """-> DiagGmm or FullGmm (host arrays)."""
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    z = _open(path)
    if z["__kind__"].tobytes() == b"full_ubm":
        return FullGmm(z["weights"], z["means"], z["covars"])
    return DiagGmm(z["weights"], z["means"], z["vars"])


def save_plda(path: str, plda) -> None:
    """(ref: ivector/plda.h Plda::Write)"""
    _savez(path, dict(__version__=np.int64(FORMAT_VERSION),
                      __kind__=_u8(b"plda"),
                      mean=np.asarray(plda.mean),
                      transform=np.asarray(plda.transform),
                      psi=np.asarray(plda.psi)))


def load_plda(path: str):
    """-> Plda (host arrays)."""
    from kaldi_tpu_torch.ivector.plda import Plda
    z = _open(path)
    return Plda(mean=z["mean"], transform=z["transform"], psi=z["psi"])


# ---------------------------------------------------- statistics and trees

def save_gmm_accs(path: str, acc, trans_counts=None) -> None:
    """Save AccumAmDiagGmm stats (+ optional transition counts) — the
    artifact gmm-acc-stats-ali writes and gmm-sum-accs/gmm-est read
    (ref: gmmbin/gmm-acc-stats-ali.cc writes {TransitionAccs, GmmAccs})."""
    blobs = {"__version__": np.int64(FORMAT_VERSION),
             "__kind__": _u8(b"gmm_accs"),
             "num_pdfs": np.int64(len(acc.accs)),
             "tot_like": np.float64(acc.tot_like),
             "tot_frames": np.float64(acc.tot_frames)}
    for i, a in enumerate(acc.accs):
        blobs[f"acc{i}_occ"] = a.occ
        blobs[f"acc{i}_mean"] = a.mean_acc
        blobs[f"acc{i}_var"] = a.var_acc
    if trans_counts is not None:
        blobs["trans_counts"] = np.asarray(trans_counts, np.float64)
    _savez(path, blobs)


def load_gmm_accs(path: str):
    """-> (AccumAmDiagGmm-shaped object, trans_counts or None)."""
    from kaldi_tpu_torch.gmm.estimation import AccumAmDiagGmm, AccumDiagGmm
    z = _open(path, b"gmm_accs")
    acc = AccumAmDiagGmm.__new__(AccumAmDiagGmm)
    acc.accs = []
    for i in range(int(z["num_pdfs"])):
        occ = z[f"acc{i}_occ"]
        a = AccumDiagGmm(occ.shape[0], z[f"acc{i}_mean"].shape[1])
        a.occ, a.mean_acc, a.var_acc = occ, z[f"acc{i}_mean"], z[f"acc{i}_var"]
        acc.accs.append(a)
    acc.tot_like = float(z["tot_like"])
    acc.tot_frames = float(z["tot_frames"])
    tc = z["trans_counts"] if "trans_counts" in z.files else None
    return acc, tc


def save_tree_stats(path: str, stats: dict, context_width: int,
                    central_position: int) -> None:
    """Tree-accumulation stats: {event frozenset -> GaussStats} — the
    acc-tree-stats output build-tree consumes (ref: bin/acc-tree-stats.cc
    writes BuildTreeStatsType)."""
    payload = _dumps({
        "N": int(context_width), "P": int(central_position),
        "stats": {ev: (st.count, st.x, st.x2, st.var_floor)
                  for ev, st in stats.items()},
    })
    _savez(path, {"__version__": np.int64(FORMAT_VERSION),
                  "__kind__": _u8(b"tree_stats"),
                  "__host__": _u8(payload)})


def load_tree_stats(path: str):
    """-> (stats dict, context_width, central_position)."""
    from kaldi_tpu_torch.tree.clustering import GaussStats
    z = _open(path, b"tree_stats")
    host = _loads(z["__host__"].tobytes())
    stats = {ev: GaussStats(count=c, x=x, x2=x2, var_floor=vf)
             for ev, (c, x, x2, vf) in host["stats"].items()}
    return stats, host["N"], host["P"]


def save_tree(path: str, ctx) -> None:
    """Decision tree / context dependency (ref: the 'tree' file
    build-tree writes and gmm-init-model reads)."""
    _savez(path, {"__version__": np.int64(FORMAT_VERSION),
                  "__kind__": _u8(b"tree"),
                  "__host__": _u8(_dumps(ctx))})


def load_tree(path: str):
    """-> the port's context dependency (host classes)."""
    return _loads(_open(path, b"tree")["__host__"].tobytes())


# ------------------------------------------------------------------- SGMM

#: optional SGMM sidecar arrays round-tripped verbatim when set on the
#: SgmmAm adapter (ref: Sgmm2FmllrGlobalParams riding in the model file,
#: sgmm2bin/sgmm2-comp-prexform.cc / sgmmbin/sgmm-est-fmllrbasis.cc)
_SGMM_EXTRAS = ("pre_xform", "inv_xform", "mean_scatter", "fmllr_basis")


def save_sgmm2(path: str, sgmm_am, kind: str = "sgmm2") -> None:
    """Save an SGMM acoustic model (SgmmAm adapter around AmSgmm2)
    (ref: sgmm2/am-sgmm2.h AmSgmm2::Write — global params Sigma_inv/M/w/N
    plus ragged per-state substate vectors v_j / weights c_j); the port's
    flat substates are written as JAX's per-state lists. kind 'sgmm' tags
    the legacy-SGMM variant."""
    from kaldi_tpu_torch.params import sgmm2_to_lists
    sgmm = sgmm_am.sgmm
    v, c = sgmm2_to_lists(sgmm)
    blobs = {
        "__version__": np.int64(FORMAT_VERSION),
        "__kind__": _u8(kind.encode()),
        "Sigma_inv": _np(sgmm.Sigma_inv), "M": _np(sgmm.M), "w": _np(sgmm.w),
        "num_states": np.int64(sgmm.num_states),
        "num_gselect": np.int64(sgmm_am.num_gselect),
    }
    if sgmm.N is not None:
        blobs["N"] = _np(sgmm.N)
    if getattr(sgmm, "norm_set_ids", None) is not None:
        blobs["norm_set_ids"] = np.asarray(sgmm.norm_set_ids, np.int64)
    for name in _SGMM_EXTRAS:
        val = getattr(sgmm_am, name, None)
        if val is not None:
            blobs[f"__extra_{name}"] = _np(val)
    for j in range(sgmm.num_states):
        blobs[f"v{j}"] = np.stack(v[j])
        blobs[f"c{j}"] = np.asarray(c[j])
    _savez(path, blobs)


def load_sgmm2(path: str, device="cuda"):
    """-> SgmmAm whose AmSgmm2 is on `device`; accepts both the sgmm2 and
    the legacy sgmm kinds (the adapter carries .kind)."""
    from types import SimpleNamespace

    from kaldi_tpu_torch.params import sgmm2_from_jax
    from kaldi_tpu_torch.steps.sgmm_steps import SgmmAm
    z = _open(path)
    kind = z["__kind__"].tobytes().decode()
    assert kind in ("sgmm2", "sgmm"), "not an sgmm/sgmm2 file"
    J = int(z["num_states"])
    lists = SimpleNamespace(
        Sigma_inv=z["Sigma_inv"], M=z["M"], w=z["w"],
        N=z["N"] if "N" in z.files else None,
        v=[list(z[f"v{j}"]) for j in range(J)],
        c=[z[f"c{j}"] for j in range(J)],
        norm_set_ids=z["norm_set_ids"] if "norm_set_ids" in z.files
        else None)
    am = SgmmAm(sgmm2_from_jax(lists, device), int(z["num_gselect"]))
    am.kind = kind
    for name in _SGMM_EXTRAS:
        if f"__extra_{name}" in z.files:
            setattr(am, name, z[f"__extra_{name}"])
    return am


def save_sgmm2_accs(path: str, accs) -> None:
    """Save Sgmm2Accs (ref: MleAmSgmm2Accs::Write — per-state ragged
    gamma/y plus global Y/Q/S stats); the port's flat substate rows are
    written per state."""
    o = accs._offsets
    gamma, y = _np(accs.gamma), _np(accs.y)
    blobs = {
        "__version__": np.int64(FORMAT_VERSION),
        "__kind__": _u8(b"sgmm2_accs"),
        "Y": _np(accs.Y), "Q": _np(accs.Q),
        "S_centered": _np(accs.S_centered),
        "tot_like": np.float64(accs.tot_like),
        "tot_frames": np.float64(accs.tot_frames),
        "num_states": np.int64(len(o) - 1),
    }
    for j in range(len(o) - 1):
        blobs[f"gamma{j}"] = gamma[o[j]:o[j + 1]]
        blobs[f"y{j}"] = y[o[j]:o[j + 1]]
    _savez(path, blobs)


def load_sgmm2_accs(path: str, device="cuda"):
    """-> Sgmm2Accs on `device` (no model needed: shapes ride in)."""
    from kaldi_tpu_torch.sgmm.estimate import Sgmm2Accs
    dev = resolve_device(device)
    z = _open(path, b"sgmm2_accs")
    J = int(z["num_states"])

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64, device=dev)
    accs = Sgmm2Accs.__new__(Sgmm2Accs)
    accs.gamma = t(np.concatenate([z[f"gamma{j}"] for j in range(J)]))
    accs.y = t(np.concatenate([z[f"y{j}"] for j in range(J)]))
    accs.Y, accs.Q = t(z["Y"]), t(z["Q"])
    S = z["S_centered"]
    accs._S2 = t(S.reshape(S.shape[0], -1))
    accs._Sx = torch.zeros(S.shape, dtype=torch.float64, device=dev)
    accs._tot_like = t(z["tot_like"])
    accs._tot_frames = t(z["tot_frames"])
    accs._offsets = np.concatenate(
        [[0], np.cumsum([len(z[f"gamma{j}"]) for j in range(J)])]
    ).astype(np.int64)
    return accs
