"""TDNN training: the port's bf16 train step over its SGD chain, steps
dispatched back to back, as a recipe's training job runs them.

Set-up builds the configuration's graph, draws the TDNN's initial
weights from the configuration's seed (`inputs/am.init_weights`) and
synthesizes the traffic's pool of utterances from `--seed`, each sampled
from the graph (`inputs/corpus.py`), with its features (the reference's
fbank + CMVN in f32, made once) and frame targets on the device. It
builds the port's step, `make_train_step(Tdnn, make_optimizer(
NnetTrainOpts(...), steps), compute_dtype=bfloat16)`, and drives it
through its first `check_steps` steps, which the check compares; the
window goes on with the same params and optimizer state.

Each step takes the next `batch_utts` utterances of a seeded order of
the pool (every row of the checked steps differs), gathered on the
device. The loss is read back every `log_every` steps, as a training log
would; the window ends at the first such read after `--seconds`.
`train_frames_per_s` is the output frames of the window's steps over the
window.

The check follows two stretches of `check_steps` steps with the plain
reference in f64 (`reference/train.py`) from the same weights and
batches: the first steps, from the initial weights, and the window's
last steps (`late_*`), from the program's own state where they began (a
step returns new tensors, so the window keeps that state by reference,
at no cost). For each stretch: each step's loss, the stretch's first
update's norm and the norm of its change, each by the worst leaf. The
late stretch has limits of its own: there every layer moves and the
gradients are small, so bf16's rounding reads several times the first
steps'. The traffic's `limits` name the numbers compared; the late
stretch's loss is not among them, since no control or fault reads ten
times its sound readings (PERF.md).
"""

from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from inputs import am as am_inputs
from inputs.corpus import fbank_targets, make_utterances
from inputs.graph import BigGraphConfig, make_big_hclg
from reference import features as ref_features
from reference import train as ref_train


def splice_of(cfg: dict):
    return [tuple(c) for c in cfg["tdnn"]["splice_indexes"]]


def lr_at(cfg: dict, step: int) -> float:
    """The SGD rate of step `step` (from 0): the exponential decay from
    initial_lr to final_lr over the job's steps, in f32, as
    `nnet/optim.exponential_decay` states it."""
    tr = cfg["train"]
    if step <= 0:
        return float(np.float32(tr["initial_lr"]))
    rate = np.float32(tr["final_lr"] / tr["initial_lr"])
    v = np.float32(tr["initial_lr"]) * np.power(
        rate, np.float32(step) / np.float32(tr["steps"]))
    return float(max(v, np.float32(tr["final_lr"])))


def make_inputs(ctx, shared: dict | None = None) -> dict:
    """Everything the benchmark makes for a run, without the program: the
    initial weights, the pool's features, targets and weights on the
    device, and the order of the batches."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    shared = {} if shared is None else shared
    if "graph" not in shared:
        shared["graph"] = make_big_hclg(BigGraphConfig(**cfg["graph"]))[0]
    t = cfg["tdnn"]
    splice = splice_of(cfg)
    params = am_inputs.init_weights(t["feat_dim"], t["hidden_dim"],
                                    t["num_pdfs"], splice,
                                    cfg["weights_seed"], dev)
    rng = np.random.default_rng(abs(int(ctx.seed)))
    waves, segs, _ = make_utterances(
        shared["graph"], [mix["frames"]] * mix["pool_utts"], rng,
        noise=cfg["noise"])
    f = cfg["features"]
    feats = torch.stack([ref_features.cmvn(ref_features.fbank(
        torch.as_tensor(w, device=dev), precision="f32",
        samp_freq=f["samp_freq"], num_bins=f["num_bins"],
        low_freq=f["low_freq"], high_freq=f["high_freq"],
        frame_length_ms=f["frame_length_ms"],
        frame_shift_ms=f["frame_shift_ms"])) for w in waves])
    F = feats.shape[1]
    lc = -sum(min(c) for c in splice if min(c) < 0)
    rc = sum(max(c) for c in splice if max(c) > 0)
    tgt = torch.as_tensor(np.stack([fbank_targets(s, F) for s in segs])
                          [:, lc: F - rc], dtype=torch.int32, device=dev)
    n, b = mix["pool_utts"], mix["batch_utts"]
    order = np.concatenate([rng.permutation(n) for _ in range(
        mix["max_steps"] * b // n + 1)])[: mix["max_steps"] * b]
    return dict(params=params, feats=feats, targets=tgt,
                weights=torch.ones(tgt.shape, device=dev),
                order=torch.as_tensor(order.reshape(-1, b), device=dev),
                frames_per_step=b * tgt.shape[1])


def batch(state: dict, step: int):
    idx = state["order"][step]
    return (state["feats"].index_select(0, idx),
            state["targets"].index_select(0, idx),
            state["weights"].index_select(0, idx))


def setup(ctx) -> dict:
    """`make_inputs`, then the program's step and optimizer over the
    port's Tdnn; the first `check_steps` steps run here."""
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                            make_train_step)

    cfg, mix = ctx.config, ctx.mix
    state = make_inputs(ctx)
    t, tr = cfg["tdnn"], cfg["train"]
    model = Tdnn(TdnnConfig(feat_dim=t["feat_dim"], num_pdfs=t["num_pdfs"],
                            splice_indexes=tuple(splice_of(cfg)),
                            hidden_dim=t["hidden_dim"], nonlinearity="relu"),
                 device=ctx.device)
    opt = make_optimizer(NnetTrainOpts(
        initial_lr=tr["initial_lr"], final_lr=tr["final_lr"],
        max_grad_norm=tr["max_grad_norm"]), tr["steps"])
    step_fn = make_train_step(model, opt,
                              compute_dtype=getattr(torch, t["compute_dtype"]))
    p0 = {k: v.clone() for k, v in state["params"].items()}
    params, opt_state = p0, opt.init(p0)
    losses, snaps = [], []
    for s in range(mix["check_steps"]):
        params, opt_state, loss, _acc = step_fn(params, opt_state,
                                                *batch(state, s))
        losses.append(loss)
        snaps.append({k: v.clone() for k, v in params.items()})
    state.update(step_fn=step_fn, live=(params, opt_state),
                 done=mix["check_steps"], p0=p0,
                 program=dict(losses=[float(x) for x in losses],
                              after=snaps))
    return state


def run_window(state: dict, ctx) -> dict:
    spans, mix = ctx.spans, ctx.mix
    step_fn = state["step_fn"]
    params, opt_state = state["live"]
    s0 = s = state["done"]
    logs = []
    # the last check_steps steps: the state before each and its loss
    kept = collections.deque([(s, params)], maxlen=mix["check_steps"] + 1)
    losses = collections.deque(maxlen=mix["check_steps"])
    t0 = time.perf_counter()
    while True:
        if s >= len(state["order"]):
            raise RuntimeError("the window outran the traffic's max_steps")
        with spans.span("step", sync=False):
            params, opt_state, loss, _acc = step_fn(params, opt_state,
                                                    *batch(state, s))
        s += 1
        kept.append((s, params))
        losses.append(loss)
        if (s - s0) % mix["log_every"] == 0:
            logs.append(float(loss))
            now = time.perf_counter()
            if now >= t0 + ctx.seconds:
                break
    window_s = now - t0
    n = s - s0
    state["live"] = (params, opt_state)
    state["done"] = s
    state["window_end"] = dict(first=kept[0][0], start=kept[0][1],
                               losses=[float(x) for x in losses],
                               after=[p for _s, p in list(kept)[1:]])
    frames = n * state["frames_per_step"]
    return dict(e2e={"train_frames_per_s": frames / window_s},
                attempted=n, failed=sum(not np.isfinite(x) for x in logs),
                window_s=window_s,
                counters=dict(steps=n, frames=frames, window_start=t0,
                              window_end=now,
                              gemm_weights=sum(
                                  v.numel() for k, v in
                                  state["params"].items()
                                  if k.endswith(".w"))))


def trace_segment(state: dict, ctx) -> dict:
    """After the window: `trace_steps` more steps under the profiler."""
    params, opt_state = state["live"]
    s = state["done"]
    ctx.dtrace.start()
    try:
        for s in range(s, s + ctx.mix["trace_steps"]):
            with ctx.spans.span("step", sync=False):
                params, opt_state, _loss, _acc = state["step_fn"](
                    params, opt_state, *batch(state, s))
    finally:
        ctx.dtrace.stop()
    return {}


def leaf_gaps(p0: dict, side: dict, ref: dict) -> float:
    """The worst leaf's gap between the side's and the reference's norm of
    the change from p0, over the larger of the reference's norm of that
    leaf's change and the median leaf's. Leaves the reference moves by
    under a thousandth of the median moving leaf are left out (at the
    first step that is every layer under the all-zero final affine: their
    gradient is exactly zero)."""
    rn = {k: float((ref[k] - p0[k].double()).norm()) for k in p0}
    moving = [v for v in rn.values() if v > 0]
    if not moving:
        return 0.0
    med = float(np.median(moving))
    gap = 0.0
    for k in p0:
        if rn[k] < 1e-3 * med:
            continue
        sn = float((side[k].double() - p0[k].double()).norm())
        gap = max(gap, abs(sn - rn[k]) / max(rn[k], med))
    return gap


def compare(state: dict, cfg: dict, p0: dict, first: int,
            side: dict) -> dict:
    """The check's numbers for side = dict(losses, after) of the steps
    from `first` on, started from params p0, against the f64 reference
    from the same params and batches."""
    steps = range(first, first + len(side["losses"]))
    losses, after = ref_train.steps(
        p0, [batch(state, s) for s in steps], splice_of(cfg),
        [lr_at(cfg, s) for s in steps], cfg["train"]["max_grad_norm"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(side["losses"],
                                                       losses))
    return dict(loss_gap=loss_gap,
                update_gap=leaf_gaps(p0, side["after"][0], after[0]),
                change_gap=leaf_gaps(p0, side["after"][-1], after[-1]))


def both(first: dict, late: dict) -> dict:
    """The two stretches' numbers under one set of names."""
    return dict(first, **{"late_" + n: v for n, v in late.items()})


def free_program(state: dict):
    for k in ("step_fn", "live"):
        state.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(state: dict, ctx) -> list:
    free_program(state)
    limits = ctx.mix["limits"]
    end = state["window_end"]
    nums = both(compare(state, ctx.config, state["p0"], 0,
                        state["program"]),
                compare(state, ctx.config, end["start"], end["first"], end))
    return [dict(name=n, value=nums[n], limit=limits[n]) for n in limits]


def late_step(mix: dict) -> int:
    """Where the control's and the faults' second stretch begins: late in
    the traffic's order, past the rate's decay."""
    return mix["max_steps"] - mix["check_steps"]


def control_numbers(ctx, shared: dict) -> dict:
    """The check's numbers with the reference's fp8 steps in the
    program's place: its first steps, and a late stretch from the state
    those steps reached."""
    state = make_inputs(ctx, shared)
    p0 = state["p0"] = {k: v.clone() for k, v in state["params"].items()}
    cfg, n = ctx.config, ctx.mix["check_steps"]

    def fp8(p, first):
        steps = range(first, first + n)
        losses, after = ref_train.steps(
            p, [batch(state, s) for s in steps], splice_of(cfg),
            [lr_at(cfg, s) for s in steps], cfg["train"]["max_grad_norm"],
            precision="fp8")
        return dict(losses=losses, after=after)

    start = fp8(p0, 0)
    p1, late = start["after"][-1], late_step(ctx.mix)
    return both(compare(state, cfg, p0, 0, start),
                compare(state, cfg, p1, late, fp8(p1, late)))


FAULTS = ("unchanged", "half_batch", "double_update")


def fault_side(state: dict, cfg: dict, p: dict, first: int, n: int,
               fault: str) -> dict:
    """The f64 reference's steps from params p over the steps from
    `first` on, with `fault` planted: "unchanged" returns the state it
    was given; "half_batch" steps on the first half of each batch, the
    mean taken over it; "double_update" moves the final affine's weights
    by twice their update."""
    steps = range(first, first + n)
    batches = [batch(state, s) for s in steps]
    lrs = [lr_at(cfg, s) for s in steps]
    splice, clip = splice_of(cfg), cfg["train"]["max_grad_norm"]
    if fault == "unchanged":
        losses, _ = ref_train.steps(p, batches, splice, lrs, clip)
        return dict(losses=losses,
                    after=[{k: v.double() for k, v in p.items()}] * n)
    if fault == "half_batch":
        half = [tuple(x[: len(x) // 2] for x in b) for b in batches]
        losses, after = ref_train.steps(p, half, splice, lrs, clip)
        return dict(losses=losses, after=after)
    if fault == "double_update":
        losses, after = [], []
        for b, lr in zip(batches, lrs):
            ls, (q,) = ref_train.steps(p, [b], splice, [lr], clip)
            q = dict(q)
            k = "final.w"
            q[k] = q[k] + (q[k] - p[k].double())
            losses += ls
            after.append(q)
            p = q
        return dict(losses=losses, after=after)
    raise ValueError(f"unknown fault {fault!r}")


def fault_numbers(ctx, shared: dict, fault: str) -> dict:
    """The check's numbers with the f64 reference in the program's place
    and `fault` planted in it (`fault_side`): its first steps, and a late
    stretch from the state those steps reached."""
    state = make_inputs(ctx, shared)
    p0 = state["p0"] = {k: v.clone() for k, v in state["params"].items()}
    cfg, n = ctx.config, ctx.mix["check_steps"]
    start = fault_side(state, cfg, p0, 0, n, fault)
    p1, late = start["after"][-1], late_step(ctx.mix)
    return both(compare(state, cfg, p0, 0, start),
                compare(state, cfg, p1, late,
                        fault_side(state, cfg, p1, late, n, fault)))
