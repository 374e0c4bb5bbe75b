"""Checkpoint/resume: atomic versioned checkpoints of params dicts.

Counterpart of kaldi_tpu/utils/checkpoint.py, in its on-disk format, so
each package reads the other's checkpoints: `step_{step:010d}/` holds
`arrays.npz`, keyed by the `jax.tree_util.keystr` of each leaf in the
equivalent JAX pytree ("['layers'][0]['w']", with "/" written as "╱"),
and `meta.json` with the step, the sorted keys and `extra`. A checkpoint
is written into a temporary directory and renamed into place; the
directory is then pruned to the newest `keep`.

The port's trees are flat dicts named as `state_dict()` names them
("layers.0.w"); `params.name_to_keystr` maps the names.
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


def save_checkpoint(ckpt_dir: str, step: int, tree: dict, keep: int = 3,
                    extra: dict | None = None) -> str:
    """Atomically write checkpoint `step` of the dict `tree`; prune to the
    newest `keep`. -> the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {name_to_keystr(k): _savable(v) for k, v in tree.items()}
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
    dict name -> CPU tensor, or, with `like` (a dict name -> tensor), one
    with like's keys, each leaf in its like's dtype and on its device."""
    steps = list_checkpoints(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as arrs:
        flat = {keystr_to_name(k.replace("╱", "/")): torch.from_numpy(arrs[k])
                for k in arrs.files}
    if like is not None:
        flat = {k: flat[k].to(device=v.device, dtype=v.dtype)
                for k, v in like.items()}
    return step, flat, meta.get("extra", {})
