"""Model surgery for TDNN acoustic models: widen, shrink, rank-limit,
fix dead/saturated units, replace the output layer, per-layer lr scales.

Counterpart of kaldi_tpu/nnet/surgery.py (ref: nnet2/widen-nnet.h,
nnet2/shrink-nnet.h, nnet2bin/nnet-am-limit-rank.cc, nnet2/nnet-fix.h,
nnet2bin/nnet-replace-last-layers.cc, nnet2bin/nnet-modify-learning-
rates.cc). Every function maps a params dict (name -> tensor, named as
`Tdnn.state_dict()` names it: "layers.{i}.w", "final.b") to a new one;
the per-layer learning rates are a `multi_transform` label dict.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kaldi_tpu_torch.nnet import optim
from kaldi_tpu_torch.nnet.components import affine_init


def num_hidden_layers(params: dict) -> int:
    return len({k.split(".")[1] for k in params if k.startswith("layers.")})


def _layer_label(name: str) -> str:
    """"layers.3.w" -> "layer3", "final.b" -> "final"."""
    parts = name.split(".")
    return f"layer{parts[1]}" if parts[0] == "layers" else parts[0]


def widen(params: dict, config, new_hidden_dim: int,
          generator: torch.Generator | None = None,
          new_unit_stddev_scale: float = 1e-4) -> dict:
    """Grow every hidden layer's output dim to new_hidden_dim: new units
    get small random incoming weights (stddev new_unit_stddev_scale /
    sqrt(in)) and zero outgoing weights; the successor's old input rows
    are scaled by 1 / sqrt(new / old), which the RMS normalize's wider
    mean asks for, so the function is preserved. relu nets only."""
    if config.nonlinearity == "pnorm":
        raise ValueError("widen() applies to relu nets; pnorm group "
                         "structure ties hidden_dim to output_dim")
    old = config.hidden_dim
    add = new_hidden_dim - old
    if add <= 0:
        return params
    k = math.sqrt(new_hidden_dim / old)
    out = dict(params)
    n = num_hidden_layers(params)
    for i in range(n):
        w, b = out[f"layers.{i}.w"], out[f"layers.{i}.b"]
        in_dim = w.shape[0]
        stddev = new_unit_stddev_scale / math.sqrt(in_dim)
        gdev = generator.device if generator is not None else None
        neww = stddev * torch.randn(in_dim, add, generator=generator,
                                    device=gdev).to(w.device)
        out[f"layers.{i}.w"] = torch.cat([w, neww], dim=1)
        out[f"layers.{i}.b"] = torch.cat([b, b.new_zeros(add)])
        # successor's input rows: one block of `old` rows per splice offset,
        # old rows scaled by 1/k, new rows zero
        nxt_ctx = (config.splice_indexes[i + 1] if i + 1 < n else (0,))
        nxt = f"layers.{i + 1}.w" if i + 1 < n else "final.w"
        sw = out[nxt].reshape(len(nxt_ctx), old, -1) / k
        sw = torch.cat([sw, sw.new_zeros(len(nxt_ctx), add, sw.shape[-1])],
                       dim=1)
        out[nxt] = sw.reshape(len(nxt_ctx) * new_hidden_dim, -1)
    return out


def shrink(apply_fn, params: dict, feats, labels, num_steps: int = 50,
           lr: float = 0.1) -> dict:
    """Fit one log-scale per layer (hidden layers, then the final one) by
    Adam on held-out frames and keep the best step by strict < (ref:
    nnet2/shrink-nnet.h ShrinkNnet).

    apply_fn(params, feats) -> log-posteriors [..., T, num_pdfs]; labels:
    ints broadcastable to the output frames. -> new params."""
    n = num_hidden_layers(params)
    dev = next(iter(params.values())).device
    labels = torch.as_tensor(labels, device=dev).long()

    def scaled(logs):
        sc = torch.exp(logs)
        return {k: p * (sc[int(k.split(".")[1])] if k.startswith("layers.")
                        else sc[-1])
                for k, p in params.items()}

    def objective(logs):
        lp = apply_fn(scaled(logs), feats)
        return -torch.mean(torch.gather(lp, -1, labels[..., None]))

    logs = torch.zeros(n + 1, device=dev)
    tx = optim.adam(lr)
    state = tx.init({"s": logs})
    with torch.no_grad():
        best = (logs, float(objective(logs)))
    for _ in range(num_steps):
        leaf = logs.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(objective(leaf), [leaf])
        with torch.no_grad():
            upd, state = tx.update({"s": g}, state)
            logs = optim.apply_updates({"s": logs}, upd)["s"]
            val = float(objective(logs))
        if val < best[1]:
            best = (logs, val)
    with torch.no_grad():
        return scaled(best[0])


def limit_rank(params: dict, rank: int, layers: list[int] | None = None):
    """Rank-limit hidden affines by truncated SVD in float64 (ref:
    nnet2bin/nnet-am-limit-rank.cc); the low-rank matrix is kept in one
    piece. -> (new params, factors) where factors[i] = (U_r*S_r [in, r],
    Vt_r [r, out]) as float32 numpy."""
    out = dict(params)
    idxs = range(num_hidden_layers(params)) if layers is None else layers
    factors = {}
    for i in idxs:
        w0 = params[f"layers.{i}.w"]
        u, s, vt = np.linalg.svd(w0.detach().cpu().numpy().astype(np.float64),
                                 full_matrices=False)
        r = min(rank, len(s))
        a = (u[:, :r] * s[:r]).astype(np.float32)
        b = vt[:r].astype(np.float32)
        factors[i] = (a, b)
        out[f"layers.{i}.w"] = torch.from_numpy(a @ b).to(w0.device)
    return out, factors


def fix(params: dict, config, apply_hidden_stats, feats,
        min_average: float = 0.1, max_average: float = 2.0,
        parameter_factor: float = 2.0) -> dict:
    """Rescale hidden units that are dead (mean |activation| below
    min_average of the layer's mean: scale up) or oversaturated (above
    max_average: scale down), by at most parameter_factor (ref:
    nnet2/nnet-fix.h FixNnet).

    apply_hidden_stats(params, feats) -> list of per-layer mean
    |activation| vectors [hidden] (`Tdnn.hidden_mean_abs` over params)."""
    stats = apply_hidden_stats(params, feats)
    out = dict(params)
    for i, avg in enumerate(stats):
        avg = avg.detach().cpu().numpy() if torch.is_tensor(avg) \
            else np.asarray(avg)
        mean = max(float(avg.mean()), 1e-20)
        rel = avg / mean
        scale = np.ones_like(rel)
        low = rel < min_average
        high = rel > max_average
        scale[low] = np.minimum(min_average / np.maximum(rel[low], 1e-20),
                                parameter_factor)
        scale[high] = np.maximum(max_average / rel[high],
                                 1.0 / parameter_factor)
        s = torch.as_tensor(scale, dtype=torch.float32,
                            device=out[f"layers.{i}.w"].device)
        out[f"layers.{i}.w"] = out[f"layers.{i}.w"] * s[None, :]
        out[f"layers.{i}.b"] = out[f"layers.{i}.b"] * s
    return out


def replace_last_layers(params: dict, config, new_num_pdfs: int,
                        generator: torch.Generator | None = None) -> dict:
    """A fresh zero output affine for a new pdf inventory, over the
    trained hidden stack (ref: nnet2bin/nnet-replace-last-layers.cc)."""
    w = params["final.w"]
    new = affine_init(generator, w.shape[0], new_num_pdfs, param_stddev=0.0,
                      bias_stddev=0.0, device=w.device)
    return {**params, "final.w": new["w"], "final.b": new["b"]}


def layerwise_lr_labels(params: dict) -> dict:
    """Label dict for `optim.multi_transform`: 'layer0'..'layerN-1',
    'final' (ref: nnet2bin/nnet-modify-learning-rates.cc)."""
    return {k: _layer_label(k) for k in params}


def layerwise_optimizer(params: dict, base_lr: float,
                        scales: dict[str, float]
                        ) -> optim.GradientTransformation:
    """multi_transform SGD with per-layer lr = base_lr * scales[label]
    (missing labels: 1.0)."""
    labels = layerwise_lr_labels(params)
    txs = {n: optim.sgd(base_lr * scales.get(n, 1.0))
           for n in sorted(set(labels.values()))}
    return optim.multi_transform(txs, labels)
