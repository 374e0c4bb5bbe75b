"""nnet2/nnet1 model-surgery, compute and egs CLI subcommands of the port.

Counterpart of kaldi_tpu/cli_nnet.py: model surgery (widen, shrink,
mixup, limit-rank, fix, insert, replace-last-layers), forward-compute
and logprob dumps, raw nnets, egs transforms, perturbed, ensemble and
discriminative training, forced alignment with nnet scores. Registered
into the main parser by kaldi_tpu_torch.cli.main via register(sub).

Host commands (surgery that rewrites parameters, raw-nnet and egs files)
load their models on the CPU and do their arithmetic in numpy on JAX's
parameter layout (`_tree`: {"layers": [{"w", "b"}], "final"}), so they
write JAX's bytes. The commands in DEVICE_COMMANDS run a network (a
forward, a gradient, a trainer, an aligner) on `--device` (default:
cuda) and raise without a card. `nnet-am-widen` draws its new units from
a torch.Generator seeded with --seed, not JAX's key.

(ref: nnet2bin/*.cc, nnetbin/*.cc — one section per reference binary,
cited per command.)
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device

# the subcommands of this module that run a network on `--device`
DEVICE_COMMANDS = (
    "nnet-am-shrink", "nnet-shrink", "nnet-am-fix", "nnet-am-rescale",
    "nnet-am-stats", "nnet-show-progress", "nnet-limit-degradation",
    "nnet-compute", "nnet-logprob", "nnet-logprob2", "nnet-compute-prob",
    "nnet-compute-from-egs", "nnet-gradient", "nnet-train-simple-perturbed",
    "nnet-train-ensemble", "nnet-train-discriminative-simple",
    "nnet-align-compiled")


# ---------------------------------------------------------------- helpers

def _load_am(path, device="cpu"):
    from kaldi_tpu_torch.io.model_io import load_am_nnet
    return load_am_nnet(path, device=device)


def _save_am(path, am):
    from kaldi_tpu_torch.io.model_io import save_am_nnet
    save_am_nnet(path, am)


def _read_egs(egs_dir):
    from kaldi_tpu_torch.cli import _read_egs_dir
    return _read_egs_dir(egs_dir)


def _rewrite(*args):
    from kaldi_tpu_torch.cli import _rewrite_egs
    return _rewrite_egs(*args)


def _tree(am) -> dict:
    """An AmNnet's (or raw Tdnn's) weights in JAX's layout, numpy leaves,
    each layer's in its file order (io/model_io.py `leaf_order`)."""
    from kaldi_tpu_torch.io.model_io import _in_leaf_order
    from kaldi_tpu_torch.params import tdnn_params_to_jax
    model = getattr(am, "model", am)
    tree = tdnn_params_to_jax(model)
    tree["layers"] = _in_leaf_order(model, tree["layers"])
    return tree


def _save_tree(path, am, tree, keep=True, **cfg):
    """JAX's AM file of a JAX-layout `tree` under am's config with `cfg`
    replaced (JAX's `_replace_config`), written array for array: with
    `keep` am's priors, group_ids and lr_scales (JAX's replace_params),
    else a fresh AmNnet's uniform priors."""
    from kaldi_tpu_torch.io.model_io import save_am_tree
    config = dataclasses.replace(am.model.config, **cfg)
    if keep:
        save_am_tree(path, config, tree, am.priors, am.group_ids,
                     am.lr_scales)
    else:
        save_am_tree(path, config, tree)


def _flat_norms(params):
    """-> {label: l2 norm} per layer + final (JAX-layout tree)."""
    out = {}
    for i, layer in enumerate(params["layers"]):
        out[f"layer{i}"] = float(np.sqrt(sum(
            float(np.sum(np.square(np.asarray(v)))) for v in layer.values())))
    out["final"] = float(np.sqrt(sum(
        float(np.sum(np.square(np.asarray(v))))
        for v in params["final"].values())))
    return out


def _param_diff_norms(old, new):
    out = {}
    for i, (a, b) in enumerate(zip(old["layers"], new["layers"])):
        out[f"layer{i}"] = float(np.sqrt(sum(
            float(np.sum(np.square(np.asarray(b[k]) - np.asarray(a[k]))))
            for k in a)))
    out["final"] = float(np.sqrt(sum(
        float(np.sum(np.square(np.asarray(new["final"][k])
                               - np.asarray(old["final"][k]))))
        for k in old["final"])))
    return out


def _egs_objf(am, egs, max_examples: int = 4096):
    """Mean per-frame log-prob + frame accuracy of an AmNnet on egs (the
    forward on the AmNnet's device, the sums on the host)."""
    n = min(len(egs["feats"]), max_examples)
    targets = np.asarray(egs["targets"][:n])
    weights = np.asarray(egs["weights"][:n])
    log_post = am.log_posteriors(egs["feats"][:n],
                                 pad_context=False).cpu().numpy()
    t = np.clip(targets, 0, log_post.shape[-1] - 1)
    lp = np.take_along_axis(log_post, t[..., None], axis=-1)[..., 0]
    w = weights * (targets >= 0)
    tot = max(float(w.sum()), 1e-8)
    objf = float((lp * w).sum()) / tot
    acc = float(((log_post.argmax(-1) == t) * w).sum()) / tot
    return objf, acc


def _interp_params(old, new, alpha: float):
    """old + alpha * (new - old), leaf-wise (JAX-layout trees)."""
    def mix(a, b):
        return np.asarray(a) + alpha * (np.asarray(b) - np.asarray(a))
    return {"layers": [{k: mix(a[k], b[k]) for k in a}
                       for a, b in zip(old["layers"], new["layers"])],
            "final": {k: mix(old["final"][k], new["final"][k])
                      for k in old["final"]}}


# ------------------------------------------------------- model surgery

def cmd_nnet_am_widen(args):
    """(ref: nnet2bin/nnet-am-widen.cc + nnet2/widen-nnet.h); the new
    units' incoming weights come from a torch.Generator seeded with
    --seed."""
    from kaldi_tpu_torch.nnet.surgery import widen
    am = _load_am(args.nnet_in)
    params = widen(am.model.params(), am.model.config, args.hidden_dim,
                   torch.Generator().manual_seed(args.seed))
    from kaldi_tpu_torch.params import params_to_jax
    _save_tree(args.nnet_out, am, params_to_jax(params),
               hidden_dim=args.hidden_dim)
    print(f"nnet-am-widen: hidden {am.model.config.hidden_dim} -> "
          f"{args.hidden_dim}", file=sys.stderr)


def cmd_nnet_am_shrink(args):
    """Per-layer scales optimized on validation egs, on the device
    (ref: nnet2bin/nnet-am-shrink.cc + nnet2/shrink-nnet.h)."""
    from torch.func import functional_call
    from kaldi_tpu_torch.nnet.surgery import shrink
    dev = resolve_device(args.device)
    am = _load_am(args.nnet_in, dev)
    egs = _read_egs(args.valid_egs)
    n = min(len(egs["feats"]), args.max_examples)
    params = shrink(lambda p, f: functional_call(am.model, p, (f,), {
                        "pad_context": False}), am.model.params(),
                    torch.as_tensor(egs["feats"][:n], device=dev),
                    egs["targets"][:n], num_steps=args.num_steps)
    _save_am(args.nnet_out, am.replace_params(params))
    print(f"nnet-am-shrink: {args.num_steps} scale steps on {n} egs",
          file=sys.stderr)


def cmd_nnet_am_mixup(args):
    """Mix up the softmax layer into per-class mixtures
    (ref: nnet2bin/nnet-am-mixup.cc + nnet2/mixup-nnet.h MixupNnet)."""
    from kaldi_tpu_torch.io.model_io import save_am_tree
    from kaldi_tpu_torch.nnet.combine import mixup_softmax_layer
    am = _load_am(args.nnet_in)
    if am.group_ids is not None:
        raise SystemExit("nnet-am-mixup: model is already mixed up")
    tree = _tree(am)
    w = np.asarray(tree["final"]["w"]).T    # [C, D]
    b = np.asarray(tree["final"]["b"])
    w_new, b_new, gid = mixup_softmax_layer(
        w, b, args.num_mixtures, perturb=args.perturb, seed=args.seed)
    tree["final"] = {"w": w_new.T.astype(np.float32),
                     "b": b_new.astype(np.float32)}
    save_am_tree(args.nnet_out, dataclasses.replace(
        am.model.config, num_pdfs=len(b_new)), tree, am.priors, gid,
        am.lr_scales)
    print(f"nnet-am-mixup: {w.shape[0]} -> {len(b_new)} mixture rows",
          file=sys.stderr)


def cmd_nnet_am_limit_rank(args):
    """Truncated-SVD rank limit on hidden affines
    (ref: nnet2bin/nnet-am-limit-rank.cc)."""
    from kaldi_tpu_torch.nnet.surgery import limit_rank
    am = _load_am(args.nnet_in)
    params, _factors = limit_rank(am.model.params(), args.rank)
    tree = _tree(am)
    for i, layer in enumerate(tree["layers"]):
        layer["w"] = params[f"layers.{i}.w"].numpy()
    _save_tree(args.nnet_out, am, tree)
    print(f"nnet-am-limit-rank: rank {args.rank} on "
          f"{len(tree['layers'])} hidden layers", file=sys.stderr)


def cmd_nnet_am_limit_rank_final(args):
    """Rank-limit ONLY the final affine
    (ref: nnet2bin/nnet-am-limit-rank-final.cc)."""
    am = _load_am(args.nnet_in)
    tree = _tree(am)
    w = np.asarray(tree["final"]["w"], np.float64)
    u, s, vt = np.linalg.svd(w, full_matrices=False)
    r = min(args.rank, len(s))
    w_lr = (u[:, :r] * s[:r]) @ vt[:r]
    tree["final"] = {"w": w_lr.astype(np.float32), "b": tree["final"]["b"]}
    _save_tree(args.nnet_out, am, tree)
    kept = float(np.sum(s[:r] ** 2) / max(np.sum(s ** 2), 1e-20))
    print(f"nnet-am-limit-rank-final: rank {r}, energy kept {kept:.4f}",
          file=sys.stderr)


def cmd_nnet_am_fix(args):
    """Rescale dead/oversaturated hidden units, the statistics on the
    device (ref: nnet2bin/nnet-am-fix.cc + nnet2/nnet-fix.h)."""
    from kaldi_tpu_torch.nnet.surgery import fix
    dev = resolve_device(args.device)
    am = _load_am(args.nnet_in, dev)
    egs = _read_egs(args.egs)
    n = min(len(egs["feats"]), args.max_examples)
    with torch.no_grad():
        params = fix(am.model.params(), am.model.config,
                     lambda p, f: am.model.hidden_mean_abs(f),
                     torch.as_tensor(egs["feats"][:n], device=dev),
                     min_average=args.min_average,
                     max_average=args.max_average,
                     parameter_factor=args.parameter_factor)
    _save_am(args.nnet_out, am.replace_params(params))
    print(f"nnet-am-fix: stats over {n} egs", file=sys.stderr)


def cmd_nnet_am_reinitialize(args):
    """Keep the hidden stack, fresh (zero) output layer sized to another
    system's pdf count (ref: nnet2bin/nnet-am-reinitialize.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.nnet.surgery import replace_last_layers
    am = _load_am(args.nnet_in)
    new_pdfs = load_gmm_system(args.model, device="cpu").am.num_pdfs
    params = replace_last_layers(
        am.model.params(), am.model.config, new_pdfs,
        torch.Generator().manual_seed(args.seed))
    tree = _tree(am)
    tree["final"] = {k: params[f"final.{k}"].numpy() for k in ("w", "b")}
    _save_tree(args.nnet_out, am, tree, keep=False, num_pdfs=new_pdfs)
    print(f"nnet-am-reinitialize: {am.num_pdfs} -> {new_pdfs} pdfs",
          file=sys.stderr)


def _load_raw(path, device="cpu"):
    """-> (raw Tdnn, its JAX-layout tree)."""
    from kaldi_tpu_torch.io.model_io import load_raw_nnet
    model, _params = load_raw_nnet(path, device=device)
    return model, _tree(model)


def cmd_nnet_replace_last_layers(args):
    """Drop the last --remove-layers hidden layers + output, splice in a
    raw nnet (ref: nnet2bin/nnet-replace-last-layers.cc)."""
    am = _load_am(args.nnet_in)
    tree = _tree(am)
    raw_model, raw_params = _load_raw(args.raw_nnet)
    keep = len(tree["layers"]) - args.remove_layers
    if keep < 0:
        raise SystemExit("nnet-replace-last-layers: --remove-layers "
                         "exceeds hidden layer count")
    cfg = am.model.config
    rcfg = raw_model.config
    if cfg.hidden_dim != rcfg.hidden_dim and keep > 0:
        raise SystemExit("nnet-replace-last-layers: hidden dims differ "
                         f"({cfg.hidden_dim} vs {rcfg.hidden_dim})")
    params = {"layers": tree["layers"][:keep] + raw_params["layers"],
              "final": raw_params["final"]}
    splice = cfg.splice_indexes[:keep] + rcfg.splice_indexes
    _save_tree(args.nnet_out, am, params, keep=False, splice_indexes=splice,
               num_pdfs=rcfg.num_pdfs)
    print(f"nnet-replace-last-layers: kept {keep} layers, appended "
          f"{len(raw_params['layers'])} + output", file=sys.stderr)


def cmd_nnet_insert(args):
    """Insert a raw nnet's hidden layers before the output layer
    (ref: nnet2bin/nnet-insert.cc; --insert-at counts hidden layers,
    -1 = just before the output like the reference default)."""
    am = _load_am(args.nnet_in)
    tree = _tree(am)
    raw_model, raw_params = _load_raw(args.raw_nnet)
    cfg = am.model.config
    at = args.insert_at if args.insert_at >= 0 else len(tree["layers"])
    tree["layers"] = (tree["layers"][:at] + raw_params["layers"]
                      + tree["layers"][at:])
    splice = (cfg.splice_indexes[:at] + raw_model.config.splice_indexes
              + cfg.splice_indexes[at:])
    _save_tree(args.nnet_out, am, tree, splice_indexes=splice)
    print(f"nnet-insert: {len(raw_params['layers'])} layers at {at}",
          file=sys.stderr)


def cmd_nnet_am_rescale(args):
    """Scale hidden layers so mean |activation| hits a target, computed
    on egs on the device (ref: nnet2bin/nnet-am-rescale.cc NnetRescale —
    the reference targets the average sigmoid derivative; for relu/pnorm
    stacks the analogous observable is mean |activation|)."""
    dev = resolve_device(args.device)
    am = _load_am(args.nnet_in, dev)
    egs = _read_egs(args.egs)
    n = min(len(egs["feats"]), args.max_examples)
    feats = torch.as_tensor(egs["feats"][:n], device=dev)
    params = am.model.params()
    tree = _tree(am)
    for _ in range(args.num_iters):
        with torch.no_grad():
            stats = am.replace_params(params).model.hidden_mean_abs(feats)
        for i, avg in enumerate(stats):
            mean = max(float(avg.cpu().numpy().mean()), 1e-8)
            # the clipped scale is numpy f64, so the scaled leaves are f64
            # host arrays as in JAX's file; the forward reads them in f32
            s = np.clip(args.target_avg / mean, 0.5, 2.0)
            layer = tree["layers"][i]
            for k in ("w", "b"):
                layer[k] = layer[k] * s
                params[f"layers.{i}.{k}"] = torch.as_tensor(
                    np.asarray(layer[k], np.float32), device=dev)
    _save_tree(args.nnet_out, am, tree)
    print(f"nnet-am-rescale: target {args.target_avg} over {n} egs",
          file=sys.stderr)


def cmd_nnet_normalize_stddev(args):
    """Scale each hidden layer's parameters to a target stddev
    (ref: nnet2bin/nnet-normalize-stddev.cc; --stddev-from copies the
    per-layer stddevs of a reference model)."""
    am = _load_am(args.nnet_in)
    targets = None
    if args.stddev_from:
        ref = _tree(_load_am(args.stddev_from))
        targets = [float(np.std(np.asarray(l["w"])))
                   for l in ref["layers"]]
    params = _tree(am)
    for i, layer in enumerate(params["layers"]):
        cur = float(np.std(np.asarray(layer["w"])))
        tgt = targets[i] if targets else args.stddev
        if cur > 1e-10:
            s = tgt / cur
            layer["w"] = layer["w"] * s
            layer["b"] = layer["b"] * s
    _save_tree(args.nnet_out, am, params)
    print("nnet-normalize-stddev: done", file=sys.stderr)


def cmd_nnet_am_switch_preconditioning(args):
    """Record the NG-SGD preconditioner config on the model; the trainer
    reads it (ref: nnet2bin/nnet-am-switch-preconditioning.cc — here
    preconditioning is an optimizer property (nnet/natural_gradient.py),
    so the command stores the requested ranks as model metadata)."""
    am = _load_am(args.nnet_in)
    am.meta["precond"] = {
        "rank_in": args.rank_in, "rank_out": args.rank_out,
        "update_period": args.update_period, "alpha": args.alpha,
        "num_samples_history": args.num_samples_history,
    }
    _save_am(args.nnet_out, am)
    print(f"nnet-am-switch-preconditioning: rank_in={args.rank_in} "
          f"rank_out={args.rank_out}", file=sys.stderr)


def cmd_nnet_am_stats(args):
    """Per-layer parameter stats, plus activation stats over egs if given,
    on the device (ref: nnet2bin/nnet-am-stats.cc)."""
    dev = resolve_device(args.device)
    am = _load_am(args.nnet, dev)
    tree = _tree(am)
    for i, layer in enumerate(tree["layers"]):
        w = np.asarray(layer["w"])
        print(f"layer {i}: w {w.shape} mean {w.mean():.4f} "
              f"stddev {w.std():.4f} "
              f"b stddev {np.std(np.asarray(layer['b'])):.4f}")
    fw = np.asarray(tree["final"]["w"])
    print(f"final: w {fw.shape} mean {fw.mean():.4f} stddev {fw.std():.4f}")
    if args.egs:
        egs = _read_egs(args.egs)
        n = min(len(egs["feats"]), args.max_examples)
        with torch.no_grad():
            stats = am.model.hidden_mean_abs(
                torch.as_tensor(egs["feats"][:n], device=dev))
        for i, avg in enumerate(stats):
            a = avg.cpu().numpy()
            dead = int((a < 1e-3 * max(float(a.mean()), 1e-20)).sum())
            print(f"layer {i}: mean|act| {a.mean():.4f} min {a.min():.5f} "
                  f"max {a.max():.4f} dead-ish {dead}/{len(a)}")


def cmd_nnet_modify_learning_rates(args):
    """Set per-layer learning-rate scales so every layer progresses at a
    similar rate, measured from the prev->cur parameter change
    (ref: nnet2bin/nnet-modify-learning-rates.cc)."""
    prev = _load_am(args.prev_model)
    cur = _load_am(args.cur_model)
    diffs = _param_diff_norms(_tree(prev), _tree(cur))
    norms = _flat_norms(_tree(cur))
    rel = {k: diffs[k] / max(norms[k], 1e-20) for k in diffs}
    mean_rel = max(np.mean(list(rel.values())), 1e-20)
    scales = {k: float(np.clip(mean_rel / max(r, 1e-20),
                               1.0 / args.max_factor, args.max_factor))
              for k, r in rel.items()}
    if args.last_layer_factor != 1.0:
        scales["final"] = scales.get("final", 1.0) * args.last_layer_factor
    cur.lr_scales = scales
    _save_am(args.modified_model, cur)
    for k in sorted(scales):
        print(f"{k}: rel-change {rel[k]:.2e} lr-scale {scales[k]:.3f}",
              file=sys.stderr)


def cmd_nnet_show_progress(args):
    """Per-layer parameter-change norms between two models (host), and
    the objf change on egs when given (on the device)
    (ref: nnet2bin/nnet-show-progress.cc)."""
    dev = resolve_device(args.device)
    old = _load_am(args.old_model, dev)
    new = _load_am(args.new_model, dev)
    diffs = _param_diff_norms(_tree(old), _tree(new))
    norms = _flat_norms(_tree(new))
    for k in sorted(diffs):
        print(f"{k}: param-change {diffs[k]:.4f} "
              f"(relative {diffs[k] / max(norms[k], 1e-20):.4f})")
    if args.egs:
        egs = _read_egs(args.egs)
        o_old, a_old = _egs_objf(old, egs)
        o_new, a_new = _egs_objf(new, egs)
        print(f"objf: {o_old:.4f} -> {o_new:.4f} "
              f"(change {o_new - o_old:+.4f}); "
              f"accuracy {a_old:.4f} -> {a_new:.4f}")


def cmd_nnet_limit_degradation(args):
    """Scale back the old->new parameter step until validation objf
    degrades at most --max-degradation, the objf on the device
    (ref: nnet2bin/nnet-limit-degradation.cc)."""
    dev = resolve_device(args.device)
    old = _load_am(args.old_model, dev)
    new = _load_am(args.new_model, dev)
    egs = _read_egs(args.egs)
    objf_old, _ = _egs_objf(old, egs)
    alpha = 1.0
    old_t, new_t = _tree(old), _tree(new)
    params = new_t
    for _ in range(args.max_iters):
        objf_new, _ = _egs_objf(new.replace_params(params), egs)
        if objf_new >= objf_old - args.max_degradation:
            break
        alpha *= args.scale
        params = _interp_params(old_t, new_t, alpha)
    else:
        objf_new, _ = _egs_objf(new.replace_params(params), egs)
    _save_am(args.nnet_out, new.replace_params(params))
    print(f"nnet-limit-degradation: alpha {alpha:.3f}, objf "
          f"{objf_old:.4f} -> {objf_new:.4f}", file=sys.stderr)


# ------------------------------------------------------------- raw nnets

def cmd_nnet_to_raw_nnet(args):
    """Strip the AM wrapper (priors); --truncate keeps the first N hidden
    layers (ref: nnet2bin/nnet-to-raw-nnet.cc)."""
    from kaldi_tpu_torch.io.model_io import save_raw_tree
    am = _load_am(args.nnet_in)
    tree = _tree(am)
    config = am.model.config
    if args.truncate >= 0:
        tree = {"layers": tree["layers"][: args.truncate],
                "final": tree["final"]}
        config = dataclasses.replace(
            config, splice_indexes=config.splice_indexes[: args.truncate])
    save_raw_tree(args.raw_out, config, tree)
    print(f"nnet-to-raw-nnet: {len(tree['layers'])} hidden layers",
          file=sys.stderr)


def cmd_raw_nnet_copy(args):
    from kaldi_tpu_torch.io.model_io import save_raw_nnet
    model, _tree_ = _load_raw(args.raw_in)
    save_raw_nnet(args.raw_out, model)
    print("raw-nnet-copy: done", file=sys.stderr)


def cmd_raw_nnet_info(args):
    model, params = _load_raw(args.raw_in)
    cfg = model.config
    n_params = sum(int(np.prod(np.shape(v)))
                   for layer in params["layers"] for v in layer.values())
    n_params += sum(int(np.prod(np.shape(v)))
                    for v in params["final"].values())
    print(f"num-components {len(params['layers']) + 1}")
    print(f"input-dim {cfg.feat_dim}")
    print(f"output-dim {cfg.num_pdfs}")
    print(f"left-context {cfg.left_context}")
    print(f"right-context {cfg.right_context}")
    print(f"num-parameters {n_params}")


def cmd_raw_nnet_concat(args):
    """Stack two raw nets: the first net's hidden layers + output become
    hidden context for the second (ref: nnet2bin/raw-nnet-concat.cc)."""
    from kaldi_tpu_torch.io.model_io import save_raw_tree
    m1, p1 = _load_raw(args.raw_in1)
    m2, p2 = _load_raw(args.raw_in2)
    if m1.config.num_pdfs != m2.config.feat_dim:
        raise SystemExit(
            f"raw-nnet-concat: output dim {m1.config.num_pdfs} != "
            f"second net input dim {m2.config.feat_dim}")
    if m1.config.hidden_dim != m2.config.hidden_dim:
        raise SystemExit("raw-nnet-concat: hidden dims differ")
    # first net's output affine becomes a plain hidden layer of the stack
    tree = {"layers": p1["layers"] + [p1["final"]] + p2["layers"],
            "final": p2["final"]}
    splice = (m1.config.splice_indexes + ((0,),)
              + m2.config.splice_indexes)
    save_raw_tree(args.raw_out, dataclasses.replace(
        m1.config, splice_indexes=splice, num_pdfs=m2.config.num_pdfs), tree)
    print(f"raw-nnet-concat: {len(tree['layers'])} hidden layers",
          file=sys.stderr)


def cmd_nnet1_to_raw_nnet(args):
    """Convert an nnet1 affine+nonlinearity stack to a raw nnet2-style
    net (ref: nnet2bin/nnet1-to-raw-nnet.cc; supported component pattern:
    (AffineTransform [+ Sigmoid|ReLU])* AffineTransform [+ Softmax])."""
    from kaldi_tpu_torch.io.model_io import save_raw_tree
    from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
    from kaldi_tpu_torch.nnet1.nnet import load_nnet1
    net, params1 = load_nnet1(args.nnet1_in, device="cpu")
    affines = [(i, c) for i, c in enumerate(net.components)
               if c.kind == "AffineTransform"]
    if not affines:
        raise SystemExit("nnet1-to-raw-nnet: no affine components")

    def leaf(i, k):
        return params1[f"{i}.{k}"].numpy()
    layers = [{"w": leaf(i, "w").T.astype(np.float32),
               "b": leaf(i, "b").astype(np.float32)}
              for i, _c in affines[:-1]]
    fi = affines[-1][0]
    final = {"w": leaf(fi, "w").T.astype(np.float32),
             "b": leaf(fi, "b").astype(np.float32)}
    in_dim = leaf(affines[0][0], "w").shape[1]
    hidden = layers[0]["w"].shape[1] if layers else in_dim
    cfg = TdnnConfig(feat_dim=in_dim, num_pdfs=len(final["b"]),
                     hidden_dim=hidden, nonlinearity="relu",
                     splice_indexes=tuple((0,) for _ in layers))
    save_raw_tree(args.raw_out, cfg, {"layers": layers, "final": final})
    print(f"nnet1-to-raw-nnet: {len(layers)} hidden layers",
          file=sys.stderr)


def cmd_nnet2_boost_silence(args):
    """Boost silence-pdf likelihoods by scaling their priors down by the
    boost factor: loglike = log p(pdf|x) - log prior, so prior /= boost
    raises silence loglikes by log(boost)
    (ref: nnet2bin/nnet2-boost-silence.cc, gmm-boost-silence semantics)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    am = _load_am(args.nnet_in)
    tm = load_gmm_system(args.model, device="cpu").trans_model
    sil = {int(p) for p in args.silence_phones.split(":") if p}
    pdfs = sorted({int(tm.id2pdf_array[t])
                   for t in range(1, tm.num_transition_ids + 1)
                   if tm.transition_id_to_phone(t) in sil})
    priors = np.asarray(am.priors, np.float64).copy()
    priors[pdfs] = priors[pdfs] / max(args.boost, 1e-20)
    am.priors = priors / priors.sum()
    _save_am(args.nnet_out, am)
    print(f"nnet2-boost-silence: boosted {len(pdfs)} pdfs by "
          f"{args.boost}", file=sys.stderr)


# ---------------------------------------------------------------- compute

def _forward_to_ark(am, rspecifier, wspecifier, divide_by_priors: bool,
                    apply_exp: bool = False):
    """Each utterance's features through `am` on its device -> an ark of
    log-posteriors (or pseudo-loglikes, or their exp)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(wspecifier) as w:
        for key, feats in open_rspecifier(rspecifier):
            out = (am.loglikes(feats[None])[0] if divide_by_priors
                   else am.log_posteriors(feats[None])[0])
            out = out.cpu().numpy()
            if apply_exp:
                out = np.exp(out)
            w.write(key, out.astype(np.float32))
            n += 1
    return n


def cmd_nnet_am_compute(args):
    """Forward features through an AmNnet, write outputs
    (ref: nnet2bin/nnet-am-compute.cc; --divide-by-priors gives
    pseudo-loglikes, --apply-exp posteriors)."""
    am = _load_am(args.nnet, device=args.device)
    n = _forward_to_ark(am, args.rspecifier, args.wspecifier,
                        args.divide_by_priors, args.apply_exp)
    print(f"nnet-am-compute: {n} utterances", file=sys.stderr)


def cmd_nnet_compute(args):
    """Forward features through a raw nnet (or AmNnet without prior
    division), write log-outputs (ref: nnet2bin/nnet-compute.cc)."""
    from kaldi_tpu_torch.io.model_io import load_raw_nnet
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    dev = resolve_device(args.device)
    with np.load(args.nnet) as z:
        kind = (bytes(z["__kind__"]).decode() if "__kind__" in z.files
                else "")
    if kind == "raw_nnet2":
        am = AmNnet(load_raw_nnet(args.nnet, device=dev)[0])
    else:
        am = _load_am(args.nnet, dev)
    n = _forward_to_ark(am, args.rspecifier, args.wspecifier,
                        divide_by_priors=False, apply_exp=args.apply_exp)
    print(f"nnet-compute: {n} utterances", file=sys.stderr)


def cmd_nnet_logprob(args):
    """Write log-posteriors per utterance
    (ref: nnet2bin/nnet-logprob.cc; the -parallel variant is the same
    batched computation)."""
    am = _load_am(args.nnet, resolve_device(args.device))
    n = _forward_to_ark(am, args.rspecifier, args.wspecifier,
                        divide_by_priors=False)
    print(f"nnet-logprob: {n} utterances", file=sys.stderr)


def cmd_nnet_logprob2(args):
    """Write posteriors (not prior-divided) AND prior-divided loglikes
    (ref: nnet2bin/nnet-logprob2.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    am = _load_am(args.nnet, resolve_device(args.device))
    n = 0
    with open_wspecifier(args.probs_wspecifier) as wp, \
            open_wspecifier(args.logprobs_wspecifier) as wl:
        for key, feats in open_rspecifier(args.rspecifier):
            log_post = am.log_posteriors(feats[None])[0].cpu().numpy()
            log_prior = np.log(np.maximum(am.priors, 1e-20))
            wp.write(key, np.exp(log_post).astype(np.float32))
            wl.write(key, (log_post - log_prior).astype(np.float32))
            n += 1
    print(f"nnet-logprob2: {n} utterances", file=sys.stderr)


def cmd_nnet_compute_prob(args):
    """Mean log-prob + frame accuracy on egs
    (ref: nnet2bin/nnet-compute-prob.cc)."""
    am = _load_am(args.nnet, resolve_device(args.device))
    egs = _read_egs(args.egs)
    objf, acc = _egs_objf(am, egs, max_examples=args.max_examples)
    print(f"log-prob-per-frame {objf:.4f} accuracy {acc:.4f}")


def cmd_nnet_compute_from_egs(args):
    """Forward the egs features, write outputs keyed by example id
    (ref: nnet2bin/nnet-compute-from-egs.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    am = _load_am(args.nnet, resolve_device(args.device))
    egs = _read_egs(args.egs)
    n = min(len(egs["feats"]), args.max_examples)
    out = am.log_posteriors(egs["feats"][:n],
                            pad_context=False).cpu().numpy()
    with open_wspecifier(args.wspecifier) as w:
        for i in range(n):
            w.write(f"eg{i:08d}", out[i].astype(np.float32))
    print(f"nnet-compute-from-egs: {n} examples", file=sys.stderr)


def cmd_nnet_gradient(args):
    """Write the cross-entropy gradient on egs as a model-shaped file
    (ref: nnet2bin/nnet-gradient.cc); autograd on the device."""
    from kaldi_tpu_torch.nnet.train import cross_entropy_loss
    dev = resolve_device(args.device)
    am = _load_am(args.nnet, dev)
    egs = _read_egs(args.egs)
    n = min(len(egs["feats"]), args.max_examples)
    leaves = {k: v.requires_grad_(True)
              for k, v in am.model.params().items()}
    with torch.enable_grad():
        loss = cross_entropy_loss(
            am.model, leaves,
            *(torch.as_tensor(egs[k][:n], device=dev)
              for k in ("feats", "targets", "weights")))[0]
        grads = torch.autograd.grad(loss, list(leaves.values()))
    _save_am(args.gradient_out, am.replace_params(dict(zip(leaves, grads))))
    print(f"nnet-gradient: over {n} examples", file=sys.stderr)


# ------------------------------------------------------------- egs tools

def cmd_nnet_select_egs(args):
    """Keep examples where index % n == k
    (ref: nnet2bin/nnet-select-egs.cc)."""
    n = _rewrite(
        args.egs_in, args.egs_out,
        lambda ex, rng: [e for i, e in enumerate(ex)
                         if i % args.n == args.k],
        args.num_archives, 0)
    print(f"nnet-select-egs: kept {n}", file=sys.stderr)


def cmd_nnet_relabel_egs(args):
    """Replace egs targets from a new pdf alignment; example keys carry
    '<utt>:<offset>' (ref: nnet2bin/nnet-relabel-egs.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    ali = {k: np.asarray(v, np.int64).reshape(-1)
           for (k, v) in open_rspecifier(args.ali_rspecifier)}
    missed = [0]

    def relabel(ex, rng):
        out = []
        for (k, x, y, w) in ex:
            utt, _sep, off = k.rpartition(":")
            if utt in ali and off.isdigit():
                lo = int(off)
                chunk = len(np.asarray(y).reshape(-1))
                y = ali[utt][lo: lo + chunk].astype(np.float32)
            else:
                missed[0] += 1
            out.append((k, x, y, w))
        return out

    n = _rewrite(args.egs_in, args.egs_out, relabel, args.num_archives, 0)
    print(f"nnet-relabel-egs: {n} examples, {missed[0]} without "
          f"alignment", file=sys.stderr)


def cmd_nnet_get_weighted_egs(args):
    """Egs with per-frame weights from a posterior+weight pair
    (ref: nnet2bin/nnet-get-weighted-egs.cc — target = best pdf of the
    frame posterior, weight = posterior mass * external frame weight)."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.steps.egs import dump_egs
    feats = {k: v for (k, v) in open_rspecifier(args.rspecifier)}
    wts = ({k: np.asarray(v, np.float32).reshape(-1)
            for (k, v) in open_rspecifier(args.weights_rspecifier)}
           if args.weights_rspecifier else {})
    aligned, utt_names, frame_weights = [], [], []
    for utt, post in read_post_ark(args.post_rspecifier):
        if utt not in feats:
            continue
        T = len(post)
        pdfs = np.zeros(T, np.int64)
        w = np.zeros(T, np.float32)
        for t, frame in enumerate(post):
            if frame:
                best = max(frame, key=lambda pw: pw[1])
                pdfs[t] = int(best[0])
                w[t] = sum(pw[1] for pw in frame)
        if utt in wts:
            w = w * wts[utt][:T]
        aligned.append((feats[utt].astype(np.float32), pdfs))
        utt_names.append(utt)
        frame_weights.append(w)
    n = dump_egs(aligned, args.left_context, args.right_context,
                 args.chunk, args.egs_dir,
                 num_archives=args.num_archives, seed=args.seed,
                 utt_names=utt_names, frame_weights=frame_weights)
    print(f"nnet-get-weighted-egs: {len(aligned)} utts -> {n} archives",
          file=sys.stderr)


def cmd_nnet_perturb_egs(args):
    """Add cholesky-shaped noise to egs features
    (ref: nnet2bin/nnet-perturb-egs.cc: x += noise_factor * L z,
    z ~ N(0, I); the -fmllr variant perturbs in the same way)."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    L = np.asarray(next(iter(read_ark(args.cholesky)))[1], np.float64)
    rng0 = np.random.RandomState(args.seed)

    def perturb(ex, _rng):
        out = []
        for (k, x, y, w) in ex:
            z = rng0.randn(x.shape[0], L.shape[0])
            out.append((k, (np.asarray(x, np.float64)
                            + args.noise_factor * z @ L.T)
                        .astype(np.float32), y, w))
        return out

    n = _rewrite(args.egs_in, args.egs_out, perturb, args.num_archives, 0)
    print(f"nnet-perturb-egs: {n} examples, noise "
          f"{args.noise_factor}", file=sys.stderr)


def cmd_nnet_get_feature_transform(args):
    """Estimate the nnet input feature transform from LDA stats: full-dim
    LDA basis with the within-class variance scaled by
    --within-class-factor (ref: nnet2bin/nnet-get-feature-transform.cc +
    nnet2/get-feature-transform.h FeatureTransformEstimate)."""
    from kaldi_tpu_torch.io.kaldi_io import write_ark
    from kaldi_tpu_torch.transform.lda import LdaStats, estimate_lda
    stats = None
    for path in args.lda_accs:
        z = np.load(path)
        if stats is None:
            stats = LdaStats(z["zero_acc"].shape[0],
                             z["first_acc"].shape[1])
        stats.zero_acc = stats.zero_acc + z["zero_acc"]
        stats.first_acc = stats.first_acc + z["first_acc"]
        stats.total_second = stats.total_second + z["total_second"]
    dim = args.dim if args.dim > 0 else stats.first_acc.shape[1]
    W, _evals = estimate_lda(stats, dim,
                             within_class_factor=args.within_class_factor)
    write_ark(args.matrix_out, {"transform": np.asarray(W, np.float32)})
    print(f"nnet-get-feature-transform: {W.shape[0]}x{W.shape[1]}",
          file=sys.stderr)


# ------------------------------------------------- training variants

def _train_opts(args, momentum: float = 0.0):
    from kaldi_tpu_torch.nnet.train import NnetTrainOpts
    return NnetTrainOpts(initial_lr=args.initial_lr, final_lr=args.final_lr,
                         num_epochs=args.num_epochs,
                         minibatch_size=args.minibatch_size,
                         momentum=momentum)


def cmd_nnet_train_simple_perturbed(args):
    """nnet-train-simple with feature perturbation: the cholesky is
    estimated from the egs' own feature covariance, then noise-factor
    scaled noise is added (numpy, as JAX), and SGD runs on the device
    (ref: nnet2bin/nnet-train-simple-perturbed.cc)."""
    from kaldi_tpu_torch.nnet.train import train_epochs
    dev = resolve_device(args.device)
    am = _load_am(args.nnet_in, dev)
    egs = _read_egs(args.egs_dir)
    flat = egs["feats"].reshape(-1, egs["feats"].shape[-1])
    cov = np.cov(flat[: 100000].T)
    L = np.linalg.cholesky(cov + 1e-6 * np.eye(cov.shape[0]))
    rng = np.random.RandomState(args.seed)
    noisy = dict(egs)
    noisy["feats"] = (egs["feats"] + args.noise_factor
                      * rng.randn(*egs["feats"].shape) @ L.T
                      ).astype(np.float32)
    params, history = train_epochs(am.model, am.model.params(), noisy,
                                   _train_opts(args), device=dev)
    _save_am(args.nnet_out, am.replace_params(params))
    if history:
        print(f"nnet-train-simple-perturbed: final loss "
              f"{history[-1][2]:.3f}", file=sys.stderr)


def cmd_nnet_train_ensemble(args):
    """Train N models on the same egs with distinct shuffles, on the
    device (ref: nnet2bin/nnet-train-ensemble.cc; the reference also
    interpolates each member's target with the ensemble mean posterior —
    here diversity comes from the shuffle, as in JAX)."""
    from kaldi_tpu_torch.nnet.train import train_epochs
    dev = resolve_device(args.device)
    if len(args.models_and_outs) % 2 != 0:
        raise SystemExit("nnet-train-ensemble: need N inputs + N outputs")
    n = len(args.models_and_outs) // 2
    ins, outs = args.models_and_outs[:n], args.models_and_outs[n:]
    egs = _read_egs(args.egs_dir)
    for i, (mdl_in, mdl_out) in enumerate(zip(ins, outs)):
        am = _load_am(mdl_in, dev)
        params, _h = train_epochs(am.model, am.model.params(), egs,
                                  _train_opts(args),
                                  rng=np.random.RandomState(args.seed + i),
                                  device=dev)
        _save_am(mdl_out, am.replace_params(params))
    print(f"nnet-train-ensemble: {n} members", file=sys.stderr)


# ------------------------------------------- discriminative egs + training

def _degs_archives(degs_dir):
    import glob as _glob
    return sorted(_glob.glob(os.path.join(degs_dir, "feats.*.ark")))


def _read_degs(degs_dir):
    """-> [(utt, feats [T+ctx, D], tids [T], lattice)]."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    out = []
    for p in _degs_archives(degs_dir):
        a = p.rsplit("feats.", 1)[1].split(".ark")[0]
        ali = dict(read_ark(os.path.join(degs_dir, f"ali.{a}.ark")))
        lats = dict(read_lattice_ark(
            os.path.join(degs_dir, f"lats.{a}.ark")))
        for utt, feats in read_ark(p):
            out.append((utt, feats,
                        np.asarray(ali[utt], np.int64).reshape(-1),
                        lats[utt]))
    return out


def _write_degs(degs_dir, egs, num_archives):
    from kaldi_tpu_torch.io.kaldi_io import write_ark
    from kaldi_tpu_torch.lat.io import write_lattice_ark
    os.makedirs(degs_dir, exist_ok=True)
    buckets = [[] for _ in range(num_archives)]
    for i, e in enumerate(egs):
        buckets[i % num_archives].append(e)
    for a, items in enumerate(buckets):
        write_ark(os.path.join(degs_dir, f"feats.{a}.ark"),
                  {u: f for (u, f, _t, _l) in items})
        write_ark(os.path.join(degs_dir, f"ali.{a}.ark"),
                  {u: t.astype(np.float32) for (u, _f, t, _l) in items})
        write_lattice_ark(os.path.join(degs_dir, f"lats.{a}.ark"),
                          {u: l for (u, _f, _t, l) in items})
    return num_archives


def cmd_nnet_get_egs_discriminative(args):
    """Pack (context-padded feats, numerator tid alignment, denominator
    lattice) per utterance into degs archives
    (ref: nnet2bin/nnet-get-egs-discriminative.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    cfg = _load_am(args.nnet).model.config
    lc, rc = cfg.left_context, cfg.right_context
    feats = {k: v for (k, v) in open_rspecifier(args.rspecifier)}
    ali = {k: np.asarray(v, np.int64).reshape(-1)
           for (k, v) in open_rspecifier(args.ali_rspecifier)}
    egs = []
    for utt, lat in read_lattice_ark(args.denlat_ark):
        if utt not in feats or utt not in ali:
            continue
        f = np.pad(feats[utt].astype(np.float32),
                   ((lc, rc), (0, 0)), mode="edge")
        egs.append((utt, f, ali[utt], lat))
    n = _write_degs(args.degs_dir, egs, args.num_archives)
    print(f"nnet-get-egs-discriminative: {len(egs)} utts -> {n} "
          f"archives", file=sys.stderr)


def cmd_nnet_copy_egs_discriminative(args):
    """(ref: nnet2bin/nnet-copy-egs-discriminative.cc)"""
    egs = _read_degs(args.degs_in)
    _write_degs(args.degs_out, egs, args.num_archives)
    print(f"nnet-copy-egs-discriminative: {len(egs)} examples",
          file=sys.stderr)


def cmd_nnet_shuffle_egs_discriminative(args):
    """(ref: nnet2bin/nnet-shuffle-egs-discriminative.cc)"""
    egs = _read_degs(args.degs_in)
    order = np.random.RandomState(args.seed).permutation(len(egs))
    _write_degs(args.degs_out, [egs[i] for i in order], args.num_archives)
    print(f"nnet-shuffle-egs-discriminative: {len(egs)} examples",
          file=sys.stderr)


def cmd_nnet_combine_egs_discriminative(args):
    """Merge several degs dirs into one
    (ref: nnet2bin/nnet-combine-egs-discriminative.cc)."""
    egs = []
    for d in args.degs_in:
        egs.extend(_read_degs(d))
    _write_degs(args.degs_out, egs, args.num_archives)
    print(f"nnet-combine-egs-discriminative: {len(egs)} examples from "
          f"{len(args.degs_in)} dirs", file=sys.stderr)


def cmd_nnet_compare_hash_discriminative(args):
    """Content hash equality of two degs dirs
    (ref: nnet2bin/nnet-compare-hash-discriminative.cc; exits nonzero on
    mismatch)."""
    import hashlib

    def digest(d):
        h = hashlib.sha256()
        for (utt, f, t, lat) in sorted(_read_degs(d), key=lambda e: e[0]):
            h.update(utt.encode())
            h.update(np.ascontiguousarray(f).tobytes())
            h.update(np.ascontiguousarray(t).tobytes())
            h.update(str(lat.num_arcs).encode())
            h.update(str(lat.num_states).encode())
        return h.hexdigest()

    a, b = digest(args.degs_a), digest(args.degs_b)
    print(f"{a}\n{b}")
    if a != b:
        raise SystemExit(1)
    print("nnet-compare-hash-discriminative: match", file=sys.stderr)


def cmd_nnet_train_discriminative_simple(args):
    """Sequence-discriminative (MMI/sMBR/MPFE) training over degs on the
    device (ref: nnet2bin/nnet-train-discriminative-simple.cc; the
    -parallel variant is the same batched computation)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.nnet.discriminative import (
        NnetDiscriminativeOpts, train_nnet_discriminative)
    dev = resolve_device(args.device)
    am = _load_am(args.nnet_in, dev)
    tm = load_gmm_system(args.model, device="cpu").trans_model
    sil = {int(p) for p in args.silence_phones.split(":") if p}
    egs = [(f, t, lat) for (_u, f, t, lat) in _read_degs(args.degs_dir)]
    opts = NnetDiscriminativeOpts(
        criterion=args.criterion, acoustic_scale=args.acoustic_scale,
        learning_rate=args.learning_rate, num_epochs=args.num_epochs,
        drop_frames=args.drop_frames)
    params, hist = train_nnet_discriminative(am, tm, egs, opts,
                                             silence_phones=sil)
    _save_am(args.nnet_out, am.replace_params(params))
    print(f"nnet-train-discriminative-simple[{args.criterion}]: objf "
          + " -> ".join(f"{h:.4f}" for h in hist), file=sys.stderr)


def cmd_nnet_align_compiled(args):
    """Forced alignment with nnet acoustic scores, the loglikes and the
    Viterbi on the device (ref: nnet2bin/nnet-align-compiled.cc)."""
    from kaldi_tpu_torch.cli import (_pad_batch, _read_text_file,
                                     _training_graphs)
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = resolve_device(args.device)
    model = load_gmm_system(args.model, device="cpu")
    am = _load_am(args.nnet, dev)
    text = _read_text_file(args.text)
    items = [(k, f) for (k, f) in open_rspecifier(args.rspecifier)
             if k in text]
    if not items:
        raise SystemExit("nnet-align-compiled: no utterances joined")
    batch = _training_graphs(model, [text[k] for (k, _f) in items])
    feats, nf = _pad_batch(items)
    results = viterbi_align(batch, am.loglikes_np(feats), nf,
                            args.acoustic_scale, device=dev)
    n_done = 0
    with open_wspecifier(args.ali_wspecifier) as w:
        for b, (k, _f) in enumerate(items):
            if results[b] is None:
                print(f"nnet-align-compiled: failed {k}", file=sys.stderr)
                continue
            w.write(k, np.asarray(results[b][0], np.int32))
            n_done += 1
    print(f"nnet-align-compiled: {n_done}/{len(items)}", file=sys.stderr)


# ------------------------------------------------------------ registration

def register(sub):
    def add(name, func, *specs):
        q = sub.add_parser(name)
        for spec in specs:
            flags, kw = spec
            q.add_argument(flags, **kw)
        q.set_defaults(func=func)
        return q

    def a(flags, **kw):
        return (flags, kw)

    add("nnet-am-widen", cmd_nnet_am_widen,
        a("nnet_in"), a("nnet_out"),
        a("--hidden-dim", type=int, required=True),
        a("--seed", type=int, default=0))
    for name in ("nnet-am-shrink", "nnet-shrink"):
        add(name, cmd_nnet_am_shrink,
            a("nnet_in"), a("valid_egs"), a("nnet_out"),
            a("--num-steps", type=int, default=50),
            a("--max-examples", type=int, default=4096))
    add("nnet-am-mixup", cmd_nnet_am_mixup,
        a("nnet_in"), a("nnet_out"),
        a("--num-mixtures", type=int, required=True),
        a("--perturb", type=float, default=0.01),
        a("--seed", type=int, default=0))
    add("nnet-am-limit-rank", cmd_nnet_am_limit_rank,
        a("nnet_in"), a("nnet_out"),
        a("--rank", type=int, required=True))
    add("nnet-am-limit-rank-final", cmd_nnet_am_limit_rank_final,
        a("nnet_in"), a("nnet_out"),
        a("--rank", type=int, required=True))
    add("nnet-am-fix", cmd_nnet_am_fix,
        a("nnet_in"), a("egs"), a("nnet_out"),
        a("--min-average", type=float, default=0.1),
        a("--max-average", type=float, default=2.0),
        a("--parameter-factor", type=float, default=2.0),
        a("--max-examples", type=int, default=4096))
    add("nnet-am-reinitialize", cmd_nnet_am_reinitialize,
        a("nnet_in"), a("model"), a("nnet_out"),
        a("--seed", type=int, default=0))
    add("nnet-replace-last-layers", cmd_nnet_replace_last_layers,
        a("nnet_in"), a("raw_nnet"), a("nnet_out"),
        a("--remove-layers", type=int, default=0))
    add("nnet-insert", cmd_nnet_insert,
        a("nnet_in"), a("raw_nnet"), a("nnet_out"),
        a("--insert-at", type=int, default=-1))
    add("nnet-am-rescale", cmd_nnet_am_rescale,
        a("nnet_in"), a("egs"), a("nnet_out"),
        a("--target-avg", type=float, default=0.5),
        a("--num-iters", type=int, default=3),
        a("--max-examples", type=int, default=4096))
    add("nnet-normalize-stddev", cmd_nnet_normalize_stddev,
        a("nnet_in"), a("nnet_out"),
        a("--stddev", type=float, default=1.0),
        a("--stddev-from", default=""))
    add("nnet-am-switch-preconditioning",
        cmd_nnet_am_switch_preconditioning,
        a("nnet_in"), a("nnet_out"),
        a("--rank-in", type=int, default=20),
        a("--rank-out", type=int, default=80),
        a("--update-period", type=int, default=4),
        a("--alpha", type=float, default=4.0),
        a("--num-samples-history", type=float, default=2000.0))
    add("nnet-am-stats", cmd_nnet_am_stats,
        a("nnet"), a("--egs", default=""),
        a("--max-examples", type=int, default=4096))
    add("nnet-modify-learning-rates", cmd_nnet_modify_learning_rates,
        a("prev_model"), a("cur_model"), a("modified_model"),
        a("--max-factor", type=float, default=4.0),
        a("--last-layer-factor", type=float, default=1.0))
    add("nnet-show-progress", cmd_nnet_show_progress,
        a("old_model"), a("new_model"), a("egs", nargs="?", default=""))
    add("nnet-limit-degradation", cmd_nnet_limit_degradation,
        a("old_model"), a("new_model"), a("egs"), a("nnet_out"),
        a("--max-degradation", type=float, default=0.015),
        a("--scale", type=float, default=0.75),
        a("--max-iters", type=int, default=10))
    add("nnet-to-raw-nnet", cmd_nnet_to_raw_nnet,
        a("nnet_in"), a("raw_out"),
        a("--truncate", type=int, default=-1))
    add("raw-nnet-copy", cmd_raw_nnet_copy, a("raw_in"), a("raw_out"))
    add("raw-nnet-info", cmd_raw_nnet_info, a("raw_in"))
    add("raw-nnet-concat", cmd_raw_nnet_concat,
        a("raw_in1"), a("raw_in2"), a("raw_out"))
    add("nnet1-to-raw-nnet", cmd_nnet1_to_raw_nnet,
        a("nnet1_in"), a("raw_out"))
    add("nnet2-boost-silence", cmd_nnet2_boost_silence,
        a("silence_phones"), a("model"), a("nnet_in"), a("nnet_out"),
        a("--boost", type=float, default=1.5))
    add("nnet-am-compute", cmd_nnet_am_compute,
        a("nnet"), a("rspecifier"), a("wspecifier"),
        a("--divide-by-priors", action="store_true"),
        a("--apply-exp", action="store_true"),
        a("--device", default="cuda", help="torch device (default: cuda)"))
    add("nnet-compute", cmd_nnet_compute,
        a("nnet"), a("rspecifier"), a("wspecifier"),
        a("--apply-exp", action="store_true"))
    add("nnet-logprob", cmd_nnet_logprob,
        a("nnet"), a("rspecifier"), a("wspecifier"))
    add("nnet-logprob2", cmd_nnet_logprob2,
        a("nnet"), a("rspecifier"),
        a("probs_wspecifier"), a("logprobs_wspecifier"))
    add("nnet-compute-prob", cmd_nnet_compute_prob,
        a("nnet"), a("egs"),
        a("--max-examples", type=int, default=4096))
    add("nnet-compute-from-egs", cmd_nnet_compute_from_egs,
        a("nnet"), a("egs"), a("wspecifier"),
        a("--max-examples", type=int, default=4096))
    add("nnet-gradient", cmd_nnet_gradient,
        a("nnet"), a("egs"), a("gradient_out"),
        a("--max-examples", type=int, default=4096))
    add("nnet-select-egs", cmd_nnet_select_egs,
        a("egs_in"), a("egs_out"),
        a("--n", type=int, default=1), a("--k", type=int, default=0),
        a("--num-archives", type=int, default=1))
    add("nnet-relabel-egs", cmd_nnet_relabel_egs,
        a("ali_rspecifier"), a("egs_in"), a("egs_out"),
        a("--num-archives", type=int, default=1))
    add("nnet-get-weighted-egs", cmd_nnet_get_weighted_egs,
        a("rspecifier"), a("post_rspecifier"), a("weights_rspecifier"),
        a("egs_dir"),
        a("--left-context", type=int, default=4),
        a("--right-context", type=int, default=4),
        a("--chunk", type=int, default=8),
        a("--num-archives", type=int, default=2),
        a("--seed", type=int, default=0))
    add("nnet-perturb-egs", cmd_nnet_perturb_egs,
        a("cholesky"), a("egs_in"), a("egs_out"),
        a("--noise-factor", type=float, default=0.1),
        a("--seed", type=int, default=0),
        a("--num-archives", type=int, default=1))
    add("nnet-get-feature-transform", cmd_nnet_get_feature_transform,
        a("matrix_out"), a("lda_accs", nargs="+"),
        a("--dim", type=int, default=-1),
        a("--within-class-factor", type=float, default=0.001))
    add("nnet-train-simple-perturbed", cmd_nnet_train_simple_perturbed,
        a("nnet_in"), a("egs_dir"), a("nnet_out"),
        a("--noise-factor", type=float, default=0.1),
        a("--initial-lr", type=float, default=0.02),
        a("--final-lr", type=float, default=0.004),
        a("--num-epochs", type=int, default=10),
        a("--minibatch-size", type=int, default=128),
        a("--seed", type=int, default=0))
    add("nnet-train-ensemble", cmd_nnet_train_ensemble,
        a("egs_dir"), a("models_and_outs", nargs="+"),
        a("--initial-lr", type=float, default=0.02),
        a("--final-lr", type=float, default=0.004),
        a("--num-epochs", type=int, default=10),
        a("--minibatch-size", type=int, default=128),
        a("--seed", type=int, default=0))
    add("nnet-get-egs-discriminative", cmd_nnet_get_egs_discriminative,
        a("nnet"), a("rspecifier"), a("ali_rspecifier"),
        a("denlat_ark"), a("degs_dir"),
        a("--num-archives", type=int, default=1))
    add("nnet-copy-egs-discriminative", cmd_nnet_copy_egs_discriminative,
        a("degs_in"), a("degs_out"),
        a("--num-archives", type=int, default=1))
    add("nnet-shuffle-egs-discriminative",
        cmd_nnet_shuffle_egs_discriminative,
        a("degs_in"), a("degs_out"),
        a("--seed", type=int, default=0),
        a("--num-archives", type=int, default=1))
    add("nnet-combine-egs-discriminative",
        cmd_nnet_combine_egs_discriminative,
        a("degs_out"), a("degs_in", nargs="+"),
        a("--num-archives", type=int, default=1))
    add("nnet-compare-hash-discriminative",
        cmd_nnet_compare_hash_discriminative,
        a("degs_a"), a("degs_b"))
    add("nnet-train-discriminative-simple",
        cmd_nnet_train_discriminative_simple,
        a("nnet_in"), a("model"), a("degs_dir"), a("nnet_out"),
        a("--criterion", default="smbr",
          choices=["smbr", "mmi", "mpfe"]),
        a("--acoustic-scale", type=float, default=0.1),
        a("--learning-rate", type=float, default=3e-4),
        a("--num-epochs", type=int, default=1),
        a("--drop-frames", action="store_true"),
        a("--silence-phones", default=""))
    add("nnet-align-compiled", cmd_nnet_align_compiled,
        a("model"), a("nnet"), a("text"), a("rspecifier"),
        a("ali_wspecifier"),
        a("--acoustic-scale", type=float, default=0.1))
