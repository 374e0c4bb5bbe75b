"""Checkpoint/resume: atomic versioned checkpoints of params dicts.

Counterpart of kaldi_tpu/utils/checkpoint.py, in its on-disk format, so
each package reads the other's checkpoints: `step_{step:010d}/` holds
`arrays.npz`, keyed by the `jax.tree_util.keystr` of each leaf in the
equivalent JAX pytree ("['layers'][0]['w']", with "/" written as "╱"),
and `meta.json` with the step, the sorted keys and `extra`. A checkpoint
is written into a temporary directory and renamed into place; the
directory is then pruned to the newest `keep`.

A tree is any nest of dicts, lists, tuples and NamedTuples over tensors,
numpy arrays and Python numbers (None holds nothing, as an empty optax
state). It is flattened to the paths `jax.tree_util.keystr` gives the
equivalent JAX tree: a dict key keyed by a params name ("layers.0.w")
expands to that name's path (`params.name_to_keystr`: "['layers'][0]['w']"),
a list or tuple item is "[i]" and a NamedTuple field ".field". So the
port's params and optimizer states (kaldi_tpu_torch.nnet.optim, which keeps
optax's state structure) write the paths JAX writes for its params and the
optax state of the same transform.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch

from kaldi_tpu_torch.params import keystr_to_name, name_to_keystr


def _savable(t) -> np.ndarray:
    """A host numpy copy; dtypes numpy cannot store (bf16) go as f32 and
    `load_checkpoint(like=...)` casts them back."""
    if torch.is_tensor(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _key(k) -> str:
    return name_to_keystr(k) if isinstance(k, str) else f"[{k!r}]"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, object]]:
    """(path part, child) of a container, or [] for a leaf or None."""
    if isinstance(tree, dict):
        return [(_key(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return []


def _is_leaf(x) -> bool:
    return x is not None and not isinstance(x, (dict, list, tuple))


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if _is_leaf(tree):
        return {prefix: _savable(tree)}
    flat = {}
    for part, child in _children(tree):
        flat.update(_flatten(child, prefix + part))
    return flat


def _unflatten(like, flat: dict, prefix: str = ""):
    """A tree shaped like `like` with the leaves of `flat`, each cast to
    its like leaf's type (and device)."""
    if like is None:
        return None
    if _is_leaf(like):
        arr = flat[prefix]
        if torch.is_tensor(like):
            return torch.from_numpy(np.asarray(arr)).to(device=like.device,
                                                        dtype=like.dtype)
        if isinstance(like, np.ndarray):
            return np.asarray(arr).astype(like.dtype)
        return type(like)(np.asarray(arr).item())
    vals = [_unflatten(child, flat, prefix + part)
            for part, child in _children(like)]
    if isinstance(like, dict):
        return dict(zip(like, vals))
    return type(like)(*vals) if _is_namedtuple(like) else type(like)(vals)


def save_checkpoint(ckpt_dir: str, step: int, tree, keep: int = 3,
                    extra: dict | None = None) -> str:
    """Atomically write checkpoint `step` of `tree`; prune to the newest
    `keep`. -> the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "╱"): v for k, v in flat.items()})
        meta = {"step": step, "keys": sorted(flat), "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            # default=str: scalars in `extra` must not abort the checkpoint
            json.dump(meta, f, default=str)
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for s in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
    return final


def list_checkpoints(ckpt_dir: str) -> list[int]:
    """The steps of the complete checkpoints in ckpt_dir, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d{10})", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def load_checkpoint(ckpt_dir: str, step: int | None = None, like=None):
    """-> (step, tree, extra); step=None loads the newest. The tree is a
    flat dict name -> CPU tensor (the name of "[0].trace['layers'][0]['w']"
    is "0.trace.layers.0.w"), or, with `like`, a tree of like's structure,
    each leaf of like's type, dtype and device."""
    steps = list_checkpoints(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as arrs:
        flat = {k.replace("╱", "/"): arrs[k] for k in arrs.files}
    if like is not None:
        return step, _unflatten(like, flat), meta.get("extra", {})
    return step, {keystr_to_name(k): torch.from_numpy(v)
                  for k, v in flat.items()}, meta.get("extra", {})
