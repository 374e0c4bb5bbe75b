"""Offline decode: waveforms in, words out, through the port's offline
entry, in a closed loop.

Set-up builds the configuration's graph (`inputs/graph.py`), makes and
trains the AM's weights (`inputs/am.py`), loads them into the port's
`Tdnn`, tier-packs the graph into the port's `CsrBeamDecoder` and
synthesizes the traffic's pool of utterances: a fixed set of log-normal
lengths (`inputs/corpus.lognormal_frames`), each sampled from the graph
with the traffic's `content_seed`, in an order drawn from `--seed`. Then
it warms up: the port's fbank + CMVN on every pool utterance, the AM on
one batch of each bucket, one short decode.

A request is the pool, decoded by one call of the port's
`decode_batched` (length buckets, batches of `batch_size`) after the
port's fbank + CMVN per utterance; requests run back to back. The window
ends at the first request that completes after `--seconds`, so it holds
whole requests, each the same work. `audio_s_per_s` is the audio of the
completed requests over the time from the window's start to the last
completion.

The check, after the window, takes a sample drawn from `--seed` of the
pool's utterances with the longest among them, as the first request
decoded them, and holds the port's features, log-posteriors and best
paths of those utterances against the plain reference (`reference/`):
its features and AM in f64 (the AM's input zero-padded to the
utterance's bucket, as the entry pads it), the reference's cost of the
port's path (words and transition ids), and how far that cost lies above
the best path of the reference's own beam search at the configuration's
beam and max_active.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from inputs import am as am_inputs
from inputs.batching import bucket_boundaries, padded_length
from inputs.corpus import fbank_targets, lognormal_frames, make_utterances
from inputs.graph import BigGraphConfig, make_big_hclg
from reference import features as ref_features
from reference import search as ref_search
from reference import tdnn as ref_tdnn


def splice_context(splice_indexes) -> tuple[int, int]:
    lc = -sum(min(c) for c in splice_indexes if min(c) < 0)
    rc = sum(max(c) for c in splice_indexes if max(c) > 0)
    return lc, rc


def rng_of(seed: int) -> np.random.Generator:
    return np.random.default_rng(abs(int(seed)))


def fbank_kwargs(cfg: dict) -> dict:
    f = cfg["features"]
    return dict(samp_freq=f["samp_freq"], num_bins=f["num_bins"],
                low_freq=f["low_freq"], high_freq=f["high_freq"],
                frame_length_ms=f["frame_length_ms"],
                frame_shift_ms=f["frame_shift_ms"])


def make_weights(cfg: dict, graph: dict, device) -> dict:
    """The AM's weights: drawn from the configuration's seed and trained
    on its synthetic batch (`inputs/am.py`), features by the reference
    fbank + CMVN in f32."""
    t, tr = cfg["tdnn"], cfg["train"]
    splice = [tuple(c) for c in t["splice_indexes"]]
    params = am_inputs.init_weights(t["feat_dim"], t["hidden_dim"],
                                    t["num_pdfs"], splice,
                                    cfg["weights_seed"], device)
    waves, segs, _ = make_utterances(graph, [tr["frames"]] * tr["utts"],
                                     np.random.default_rng(tr["seed"]),
                                     noise=cfg["noise"])
    feats = torch.stack([ref_features.cmvn(ref_features.fbank(
        torch.as_tensor(w, device=device), precision="f32",
        **fbank_kwargs(cfg))) for w in waves])
    F = feats.shape[1]
    lc, rc = splice_context(splice)
    tgt = np.stack([fbank_targets(s, F) for s in segs])[:, lc: F - rc]
    return am_inputs.train(params, feats, torch.as_tensor(
        tgt, dtype=torch.long, device=device), splice, tr["steps"],
        tr["initial_lr"], tr["final_lr"], tr["max_grad_norm"])


def make_pool(cfg: dict, mix: dict, graph: dict, seed: int):
    """-> (keys, waves (numpy), the sample to check): the traffic's pool,
    its fixed lengths each an utterance sampled from the graph with the
    traffic's own `content_seed`, in an order drawn from `seed`; the
    sample is `check_utts` keys drawn from `seed` plus the longest. Every
    seed gets the same utterances, so the same search work, in another
    order and with another sample checked."""
    frames = lognormal_frames(mix["pool_utts"], mix["median_s"],
                              mix["sigma"], mix["min_s"], mix["max_s"])
    waves, _segs, _words = make_utterances(
        graph, list(frames), np.random.default_rng(mix["content_seed"]),
        noise=cfg["noise"])
    rng = rng_of(seed)
    order = rng.permutation(len(frames))
    waves, frames = [waves[i] for i in order], frames[order]
    keys = [f"u{i:03d}" for i in range(len(waves))]
    longest = keys[int(np.argmax(frames))]
    drawn = [keys[i] for i in rng.choice(len(keys), mix["check_utts"],
                                         replace=False)]
    sample = list(dict.fromkeys(drawn + [longest]))
    return keys, waves, sample


def make_inputs(ctx, shared: dict | None = None) -> dict:
    """Everything the benchmark makes for a run, without the program: the
    graph and the AM's weights (kept in `shared` across calls), the pool
    from `--seed` on the device, its sample, frames and audio seconds."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    shared = {} if shared is None else shared
    if "graph" not in shared:
        shared["graph"] = make_big_hclg(BigGraphConfig(**cfg["graph"]))[0]
        shared["weights"] = make_weights(cfg, shared["graph"], dev)
    graph = shared["graph"]
    keys, waves, sample = make_pool(cfg, mix, graph, ctx.seed)
    f = cfg["features"]
    length = int(f["samp_freq"] * 0.001 * f["frame_length_ms"])
    shift = int(f["samp_freq"] * 0.001 * f["frame_shift_ms"])
    return dict(graph=graph, weights=shared["weights"], keys=keys,
                waves_dev={k: torch.as_tensor(w, device=dev)
                           for k, w in zip(keys, waves)},
                sample=sample,
                frames={k: 1 + (len(w) - length) // shift
                        for k, w in zip(keys, waves)},
                audio_s={k: len(w) / f["samp_freq"]
                         for k, w in zip(keys, waves)})


def setup(ctx) -> dict:
    """`make_inputs`, then the program: the port's Tdnn holding the
    weights, its CsrBeamDecoder over the graph, its fbank options; then
    the warm-up."""
    from kaldi_tpu_torch import cuda_build
    from kaldi_tpu_torch.decoder.batching import bucket_batches
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.ops.features import FbankOpts, cmvn, fbank
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    if torch.device(dev).type == "cuda":
        cuda_build.build(["table_gather"])
    state = make_inputs(ctx)
    t = cfg["tdnn"]
    splice = tuple(tuple(c) for c in t["splice_indexes"])
    tdnn = Tdnn(TdnnConfig(feat_dim=t["feat_dim"], num_pdfs=t["num_pdfs"],
                           splice_indexes=splice, hidden_dim=t["hidden_dim"],
                           nonlinearity="relu"), device=dev)
    tdnn.load_state_dict(state["weights"])
    tdnn.eval()
    decoder = CsrBeamDecoder(PackedGraph(**state["graph"]),
                             CsrBeamOpts(**cfg["search"]), device=dev)
    f = cfg["features"]
    fb = FbankOpts(frame_opts=FrameOpts(
        samp_freq=f["samp_freq"], frame_length_ms=f["frame_length_ms"],
        frame_shift_ms=f["frame_shift_ms"], dither=0.0),
        mel_opts=MelOpts(num_bins=f["num_bins"], low_freq=f["low_freq"],
                         high_freq=f["high_freq"]))
    waves_dev = state["waves_dev"]

    def features(k):
        return cmvn(fbank(waves_dev[k], fb)).cpu().numpy()

    def score(x):
        return tdnn(x, pad_context=True, compute_dtype=getattr(
            torch, t["compute_dtype"]))

    with torch.inference_mode():
        utts = [(k, features(k)) for k in state["keys"]]
        batches = bucket_batches(utts, mix["batch_size"])
        for bound, _chunk in batches:
            score(torch.zeros((mix["batch_size"], bound, t["feat_dim"]),
                              device=dev))
        first = batches[0][1]
        n = min(mix["warmup_frames"], min(len(x) for _k, x in first))
        x = np.zeros((mix["batch_size"], n, t["feat_dim"]), np.float32)
        nf = np.ones(mix["batch_size"], np.int32)
        for b, (_k, fx) in enumerate(first):
            x[b], nf[b] = fx[:n], n
        decoder.decode(score(torch.as_tensor(x, device=dev)), nf)
    state.update(tdnn=tdnn, decoder=decoder, features=features, score=score,
                 batch_keys=[[k for k, _x in chunk] for _b, chunk in batches],
                 batch_bounds=[b for b, _chunk in batches])
    return state


class TimedSearch:
    """The decoder as `decode_batched` sees it: each call is one batch of
    a request, run by the port's decoder inside a "search" span; it
    records the batch, the decoder's counters and the sampled utterances'
    outputs."""

    def __init__(self, state: dict, spans):
        self.s = state
        self.spans = spans
        self.batch = 0
        self.batches = 0
        self.failed = 0
        self.counters = dict(real_frames=0, dispatched_frames=0,
                             loop_frames=0, active_sum=0)
        self.captured: dict = {}

    def decode(self, ll, nf):
        s = self.s
        keys = s["batch_keys"][self.batch]
        self.batch = (self.batch + 1) % len(s["batch_keys"])
        dec = s["decoder"]
        with self.spans.span("search"):
            res = dec.decode(ll, nf)
        n = len(keys)
        c = self.counters
        c["real_frames"] += int(np.sum(nf[:n]))
        c["dispatched_frames"] += int(ll.shape[0] * ll.shape[1])
        c["loop_frames"] += int(ll.shape[1])
        c["active_sum"] += int(np.sum(dec.last_active_sum[:n]))
        for b, k in enumerate(keys):
            if k in s["sample"] and k not in self.captured:
                self.captured[k] = (ll[b, : int(nf[b])].clone(), res[b])
        self.failed += sum(r is None for r in res[:n])
        self.batches += 1
        return res


def trace_segment(state: dict, ctx) -> dict:
    """After the window: the batch of a request that carries the most
    frames (features of its utterances, the AM, the search) under the
    profiler, with the shape of each gather launch recorded at the call.
    -> counters for the readers."""
    from kaldi_tpu_torch.ops import table_gather

    keys = max(state["batch_keys"],
               key=lambda ks: sum(state["frames"][k] for k in ks))
    bound = state["batch_bounds"][state["batch_keys"].index(keys)]
    shapes = []
    real = table_gather.gather_cuda

    def recording(tab, idx):
        shapes.append((tab.shape[0], tab.shape[1], idx.shape[1]))
        return real(tab, idx)

    b, t = ctx.mix["batch_size"], ctx.config["tdnn"]
    with torch.inference_mode():
        ctx.dtrace.start()
        table_gather.gather_cuda = recording
        try:
            with ctx.spans.span("features"):
                feats = [state["features"](k) for k in keys]
            x = np.zeros((b, bound, t["feat_dim"]), np.float32)
            nf = np.ones(b, np.int32)
            for i, f in enumerate(feats):
                x[i, : len(f)], nf[i] = f, len(f)
            with ctx.spans.span("am"):
                ll = state["score"](torch.as_tensor(x, device=ctx.device))
            with ctx.spans.span("search"):
                state["decoder"].decode(ll, nf)
        finally:
            table_gather.gather_cuda = real
            ctx.dtrace.stop()
    return dict(gather_shapes=shapes)


def run_window(state: dict, ctx) -> dict:
    from kaldi_tpu_torch.decoder.batching import decode_batched

    spans, mix = ctx.spans, ctx.mix

    def score_fn(x):
        with spans.span("am"):
            return state["score"](x)

    t0 = time.perf_counter()
    search = TimedSearch(state, spans)
    captured_feats = {}
    completions = []
    with torch.inference_mode():
        while not completions or completions[-1] < t0 + ctx.seconds:
            with spans.span("features"):
                utts = [(k, state["features"](k)) for k in state["keys"]]
            for k, x in utts:
                if k in state["sample"] and k not in captured_feats:
                    captured_feats[k] = x
            decode_batched(search, utts, score_fn,
                           batch_size=mix["batch_size"], device=ctx.device)
            completions.append(time.perf_counter())
    window_s = completions[-1] - t0
    audio = len(completions) * sum(state["audio_s"].values())
    counters = dict(search.counters, audio_s=audio,
                    batches=search.batches, requests=len(completions),
                    window_start=t0, window_end=completions[-1],
                    gemm_weights=sum(v.numel() for k, v in
                                     state["weights"].items()
                                     if k.endswith(".w")))
    state["captured"] = {k: (captured_feats[k],) + v
                         for k, v in search.captured.items()}
    return dict(e2e={"audio_s_per_s": audio / window_s},
                attempted=len(completions) * len(state["keys"]),
                failed=search.failed, counters=counters, window_s=window_s,
                completions=[c - t0 for c in completions])


def reference_am(state: dict, cfg: dict, k: str, device,
                 precision=("f64", "f64")):
    """The reference's features [F, D] and log-posteriors [F, P] of
    utterance k, features and AM at `precision`; the AM's input
    zero-padded to the utterance's bucket, as the offline entry pads it."""
    t = cfg["tdnn"]
    splice = [tuple(c) for c in t["splice_indexes"]]
    bounds = bucket_boundaries(list(state["frames"].values()))
    rf = ref_features.cmvn(ref_features.fbank(
        state["waves_dev"][k], precision=precision[0], **fbank_kwargs(cfg)))
    x = torch.zeros((padded_length(len(rf), bounds), rf.shape[1]),
                    dtype=rf.dtype, device=device)
    x[: len(rf)] = rf
    lp = ref_tdnn.log_posteriors(x, state["weights"], splice,
                                 precision=precision[1])[: len(rf)]
    return rf, lp


def control_outputs(state: dict, cfg: dict, sample: list, device) -> dict:
    """The control in the program's place: the reference at one precision
    below the configuration's (features on TF32, the AM's products in
    fp8), its own beam search over its log-posteriors. -> outputs as
    `reference_numbers` takes them."""
    sc = cfg["search"]
    out = {k: reference_am(state, cfg, k, device, ("tf32", "fp8"))
           for k in sample}
    res = ref_search.beam_search(
        ref_search.DeviceGraph(state["graph"], device),
        [out[k][1] for k in sample], sc["beam"], sc["max_active"],
        sc["acoustic_scale"])
    return {k: (out[k][0].cpu().numpy(), out[k][1], r)
            for k, r in zip(sample, res)}


def reference_numbers(state: dict, cfg: dict, sample: list, outputs: dict,
                      device) -> dict:
    """The numbers the check compares, for the utterances of `sample`:
    outputs[k] = (features [F, D] numpy, log-posteriors [F, P] tensor,
    (words, tids, cost) or None) of the side under test, against the f64
    reference: the largest feature difference, the largest log-posterior
    difference where the reference's is at least -10, the gap per frame
    between the side's cost of its path and the reference's cost of that
    path (inf where the reference finds no such path in the graph), and
    the most by which the reference's cost of the side's path exceeds the
    reference search's best cost (inf where the side's path ends in no
    final state and the reference's best does: a cut-off transcript)."""
    sc = cfg["search"]
    memo = state.setdefault("memo", {})
    feat_err = am_err = 0.0
    ref_ll = []
    for k in sample:
        feats, ll, _res = outputs[k]
        if k not in memo:
            memo[k] = reference_am(state, cfg, k, device)
        rf, lp = memo[k]
        feat_err = max(feat_err, float(
            (torch.as_tensor(feats, device=device).double() - rf).abs().max()))
        m = lp >= -10.0
        am_err = max(am_err, float((ll.to(device).double() - lp)[m].abs()
                                   .max()))
        ref_ll.append(lp)
    key = ("best",) + tuple(sample)
    if key not in memo:
        memo[key] = ref_search.beam_search(
            ref_search.DeviceGraph(state["graph"], device), ref_ll,
            sc["beam"], sc["max_active"], sc["acoustic_scale"])
    gap = cost_err = 0.0
    for k, lp, ref in zip(sample, ref_ll, memo[key]):
        res = outputs[k][2]
        if res is None:
            gap = cost_err = math.inf
            break
        lp = lp.cpu().numpy()

        def scored(words, tids, need_final=False):
            return ref_search.path_cost(state["graph"], lp, tids, words,
                                        sc["acoustic_scale"], need_final)
        cost = scored(res[0], res[1])
        cost_err = max(cost_err, abs(res[2] - cost) / len(lp))
        if math.isfinite(scored(ref[0], ref[1], True)) and \
                not math.isfinite(scored(res[0], res[1], True)):
            cost = math.inf
        gap = max(gap, cost - ref[2])
    return dict(feat_err=feat_err, am_err=am_err, cost_err=cost_err,
                path_gap=gap)


def free_program(state: dict):
    for k in ("tdnn", "decoder", "score", "features"):
        state.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(state: dict, ctx) -> list:
    free_program(state)
    cap = state.get("captured", {})
    sample = [k for k in state["sample"] if k in cap]
    limits = ctx.mix["limits"]
    if not sample:
        return [dict(name=n, value=math.inf, limit=limits[n])
                for n in limits]
    nums = reference_numbers(state, ctx.config, sample, cap, ctx.device)
    return [dict(name=n, value=nums[n], limit=limits[n]) for n in limits]


def control_numbers(ctx, shared: dict) -> dict:
    """The check's numbers with the control in the program's place, on the
    inputs of `ctx.seed`."""
    state = make_inputs(ctx, shared)
    outs = control_outputs(state, ctx.config, state["sample"], ctx.device)
    return reference_numbers(state, ctx.config, state["sample"], outs,
                             ctx.device)


FAULTS = {"beam_8": dict(beam=8.0), "beam_5": dict(beam=5.0),
          "active_700": dict(max_active=700),
          "active_100": dict(max_active=100)}


def fault_numbers(ctx, shared: dict, fault: str) -> dict:
    """The check's numbers with the f64 reference in the program's place
    and `fault` planted in its search: a pruning that can lose the best
    path ("beam_<b>": the beam cut to b; "active_<n>": max_active cut to
    n), so an utterance gets a valid path that is worse, or one cut off
    before a final state."""
    state = make_inputs(ctx, shared)
    memo = state["memo"] = shared.setdefault(("memo", ctx.seed), {})
    cfg, sample = ctx.config, state["sample"]
    sc = dict(cfg["search"], **FAULTS[fault])
    for k in sample:
        if k not in memo:
            memo[k] = reference_am(state, cfg, k, ctx.device)
    out = {k: memo[k] for k in sample}
    res = ref_search.beam_search(
        ref_search.DeviceGraph(state["graph"], ctx.device),
        [out[k][1] for k in sample], sc["beam"], sc["max_active"],
        sc["acoustic_scale"])
    outs = {k: (out[k][0].cpu().numpy(), out[k][1], r)
            for k, r in zip(sample, res)}
    return reference_numbers(state, cfg, sample, outs, ctx.device)
