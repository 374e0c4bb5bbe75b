"""Device mesh construction, sharding rules and utterance-sharded decode.

Counterpart of kaldi_tpu/parallel/mesh.py (the TPU replacement for the
reference's NFS + qsub job arrays, SURVEY.md §2.11). JAX's mesh holds the
devices of one controller; here the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the world,
one device per rank, with the JAX mesh's axis names ("data", "model").
A sharding is a tuple of placements, one per mesh dim (`Shard(d)` or
`Replicate()`), and a rank holds the slice that its coordinates select.
Every rank runs the same calls (SPMD): `decode_sharded` takes the whole
batch on every rank, decodes its rows and gathers the results, so every
rank returns the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor.placement_types import Replicate, Shard

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.parallel.launch import default_backend, free_port

AXES = ("data", "model")


def make_mesh(data: int | None = None, model: int = 1, device="cuda",
              backend: str | None = None) -> DeviceMesh:
    """2-D mesh ('data', 'model') over the world's ranks (rank = d * model +
    m). Defaults to every rank on 'data'. Without a process group (one
    process, `init_distributed`'s no-op) it first makes a world of one over
    `backend` (NCCL for CUDA, gloo for the CPU)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend or default_backend(dev),
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) does not cover the world "
                         f"of {n} ranks")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)


def check_mesh(mesh) -> DeviceMesh:
    """`mesh` itself if it is a ('data', 'model') DeviceMesh; TypeError
    otherwise."""
    if not (isinstance(mesh, DeviceMesh) and mesh.mesh_dim_names == AXES):
        raise TypeError(f"expected a DeviceMesh with dims {AXES} (make_mesh), "
                        f"got {mesh!r}")
    return mesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on `axis`."""
    return mesh.get_local_rank(axis)


def data_parallel_sharding(mesh: DeviceMesh):
    """(batch placements, replicated placements) for the common DP case."""
    return batch_sharding(mesh, 1), (Replicate(), Replicate())


def batch_sharding(mesh: DeviceMesh, ndim: int):
    """Leading (batch) dim sharded over 'data', replicated over 'model'
    (ndim is taken, as JAX's spec takes it, and does not matter here)."""
    return (Shard(0), Replicate())


def tdnn_param_sharding(mesh: DeviceMesh, params: dict) -> dict:
    """Placements per Tdnn param (named as `Tdnn.state_dict()` names them):
    the final affine sharded over 'model' on its output (pdf) dim, the
    hidden layers replicated."""
    out = {}
    for name, leaf in params.items():
        if name.split(".")[0] == "final":
            out[name] = (Replicate(), Shard(leaf.dim() - 1))
        else:
            out[name] = (Replicate(), Replicate())
    return out


def local_shard(x: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's slice of the global tensor `x` under `placements` (even
    splits only, as JAX's shardings need)."""
    for axis, p in zip(AXES, placements):
        if isinstance(p, Shard):
            n = axis_size(mesh, axis)
            if x.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not "
                                 f"split evenly over {axis}={n}")
            w = x.shape[p.dim] // n
            x = x.narrow(p.dim, axis_index(mesh, axis) * w, w)
    return x


def rank_rows(mesh: DeviceMesh, B: int, axis: str = "data") -> slice:
    """Rows [r*B/D, (r+1)*B/D) of a batch of B that this rank holds."""
    D = axis_size(mesh, axis)
    if B % D:
        raise ValueError(f"batch {B} does not split over {axis}={D}")
    r = axis_index(mesh, axis)
    return slice(r * (B // D), (r + 1) * (B // D))


def gather_objects(obj, mesh: DeviceMesh, axis: str) -> list:
    """Every rank's `obj` on `axis`, in rank order (pickled)."""
    if axis_size(mesh, axis) == 1:
        return [obj]
    out = [None] * axis_size(mesh, axis)
    dist.all_gather_object(out, obj, group=mesh.get_group(axis))
    return out


def broadcast_object(obj, src_index: int, mesh: DeviceMesh, axis: str):
    """The object of the rank at coordinate `src_index` on `axis`, on
    every rank of the axis."""
    if axis_size(mesh, axis) == 1:
        return obj
    group = mesh.get_group(axis)
    buf = [obj]
    dist.broadcast_object_list(
        buf, src=dist.get_global_rank(group, src_index), group=group)
    return buf[0]


def decode_sharded(decoder, loglikes, num_frames, mesh: DeviceMesh):
    """Batched decode with the utterance batch sharded over the mesh's
    'data' axis: the replacement for job-array decode sharding (`$cmd
    JOB=1:N gmm-latgen-faster`, SURVEY.md §2.11).

    Every rank passes the whole batch; rank r decodes rows
    [r*B/D, (r+1)*B/D) on its device with its own `decoder` (graph tables
    replicated), then the results and the decoder's per-row counters
    (`last_overflow` etc.) are gathered over 'data', so every rank returns
    the whole batch. B must be divisible by the data-axis size. Works with
    DenseViterbiDecoder, BeamSearchDecoder and CsrBeamDecoder."""
    nf = np.asarray(num_frames)
    rows = rank_rows(check_mesh(mesh), len(nf))
    res = decoder.decode(loglikes[rows], nf[rows])
    n_local = rows.stop - rows.start
    counters = {k: v for k, v in vars(decoder).items()
                if k.startswith("last_") and isinstance(v, np.ndarray)
                and v.ndim >= 1 and v.shape[0] == n_local}
    parts = gather_objects((list(res), counters), mesh, "data")
    for k in counters:
        setattr(decoder, k, np.concatenate([c[k] for _r, c in parts]))
    return [r for part, _c in parts for r in part]
