"""Speaker i-vector extraction: waveforms in, i-vectors out, through the
port's speaker entry (`steps/sre.SreSystem`), in a closed loop.

Set-up synthesizes the configuration's calibration speech and the
traffic's pool of conversation sides (`inputs/speech.py`, on the device,
from the traffic's `content_seed`; `--seed` orders them), makes the UBM
and the extractor's factor loadings from the configuration's seed
(`make_weights`), and builds the port's `IvectorExtractor` and
`SreSystem` over them; it warms up with one request.

A request is the pool: `sides` conversation sides of `min_s`-`max_s` at
8 kHz (the same sides for every seed, in a seeded order). Each
request runs the port's MFCC + deltas per side on the device, copies the
features to the host, and calls `SreSystem.stats` (energy VAD on the
host, `IvectorExtractor.batch_stats`: gselect and the f64 statistics on
the device) and `IvectorExtractor.extract_batch` (batches of 64):
`SreSystem.ivectors` in two calls. `audio_s_per_s` is the audio of the
completed requests over the time from the window's start to the last
completion, which is the first one after `--seconds`.

The check, after the window, takes a sample drawn from `--seed` of the
first request's sides, with the longest, and holds the port's features,
statistics and i-vectors against the plain reference (`reference/`), in
f64.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from inputs.speech import SpeakerPool
from reference import features as ref_features
from reference import ivector as ref_ivector


def seed32(seed: int) -> int:
    """A 32-bit RandomState seed drawn from any whole number."""
    return int(np.random.SeedSequence(abs(int(seed))).generate_state(1)[0])


def mfcc_kwargs(cfg: dict) -> dict:
    m = cfg["mfcc"]
    return {k: m[k] for k in ("samp_freq", "num_bins", "low_freq",
                              "high_freq", "num_ceps", "cepstral_lifter",
                              "frame_length_ms", "frame_shift_ms")}


def ref_feats(cfg: dict, wave: torch.Tensor, precision: str = "f64"):
    """The reference's MFCC + deltas of one wave."""
    m = cfg["mfcc"]
    return ref_features.add_deltas(
        ref_features.mfcc(wave, precision=precision, **mfcc_kwargs(cfg)),
        order=m["delta_order"], window=m["delta_window"])


def make_weights(cfg: dict, device) -> dict:
    """The UBM and the factor loadings, from the configuration's seed:
    the calibration speech's features (reference MFCC + deltas in f64)
    give a global mean m and covariance C; gaussian i has mean m + c z_i
    (z_i ~ N(0, C)), covariance s_i C (s_i = spread * exp(u_i), u_i
    uniform in [-0.5, 0.5]) and weight softmax(0.5 n_i); the loadings are
    M_i = C^(1/2) Z_i * m_scale with Z_i ~ N(0, 1) [D, K] and column 0
    zero. f64 tensors on `device`, the inverse covariances among them."""
    u, e = cfg["ubm"], cfg["extractor"]
    cal = cfg["calibration"]
    pool = SpeakerPool(cfg["weights_seed"], cal["speakers"])
    x = torch.cat([ref_feats(cfg, pool.side(s, cal["seconds"], device=device))
                   for s in pool.speakers])
    m = x.mean(0)
    C = torch.cov(x.T)
    Lc = torch.linalg.cholesky(C)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg["weights_seed"])
    I, D, K = u["num_gauss"], x.shape[1], e["ivector_dim"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=device)

    means = m + u["mean_spread"] * randn(I, D) @ Lc.T
    scale = u["cov_spread"] * torch.exp(torch.rand(
        (I,), generator=gen, dtype=torch.float64, device=device) - 0.5)
    covars = scale[:, None, None] * C
    weights = torch.softmax(0.5 * randn(I), 0)
    M = e["m_scale"] * (Lc @ randn(I, D, K))
    M[:, :, 0] = 0.0
    return dict(means=means, covars=covars, weights=weights, M=M,
                inv_covars=torch.linalg.inv(covars))


def make_inputs(ctx, shared: dict | None = None) -> dict:
    """Everything the benchmark makes for a run, without the program: the
    weights (kept in `shared` across calls) and the pool on the device:
    its sides synthesized with the traffic's own `content_seed`, in an
    order drawn from `--seed`, with the sample drawn from `--seed`. Every
    seed gets the same sides, so the same work, in another order."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    shared = {} if shared is None else shared
    if "weights" not in shared:
        shared["weights"] = make_weights(cfg, dev)
    if "pool" not in shared:
        pool = SpeakerPool(mix["content_seed"], mix["speakers"])
        n = mix["sides"]
        secs = np.linspace(mix["min_s"], mix["max_s"], n)
        secs = secs[pool.rng.permutation(n)]
        shared["pool"] = (secs, [
            pool.side(pool.speakers[i % len(pool.speakers)], float(s),
                      device=dev) for i, s in enumerate(secs)])
    secs, waves = shared["pool"]
    rng = np.random.default_rng(seed32(ctx.seed))
    order = rng.permutation(len(waves))
    waves, secs = [waves[i] for i in order], secs[order]
    drawn = rng.choice(len(waves), mix["check_utts"], replace=False).tolist()
    sample = list(dict.fromkeys(drawn + [int(np.argmax(secs))]))
    return dict(weights=shared["weights"], waves=waves, sample=sample,
                audio_s=sum(len(w) for w in waves) / cfg["mfcc"]["samp_freq"])


def setup(ctx) -> dict:
    """`make_inputs`, then the program: the port's extractor holding the
    weights and its SreSystem; one request to warm up."""
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    from kaldi_tpu_torch.ivector.vad import VadOpts
    from kaldi_tpu_torch.ops.delta import add_deltas
    from kaldi_tpu_torch.ops.features import MfccOpts, mfcc
    from kaldi_tpu_torch.ops.mel import MelOpts
    from kaldi_tpu_torch.ops.window import FrameOpts
    from kaldi_tpu_torch.steps.sre import SrePipelineOpts, SreSystem

    cfg, dev = ctx.config, ctx.device
    state = make_inputs(ctx)
    w = {k: v.cpu().numpy() for k, v in state["weights"].items()}
    e, m, v = cfg["extractor"], cfg["mfcc"], cfg["vad"]
    ext = IvectorExtractor.from_arrays(w["means"], w["inv_covars"],
                                       w["weights"], w["M"],
                                       e["prior_offset"])
    system = SreSystem(
        ubm=FullGmm(w["weights"], w["means"], w["covars"]), extractor=ext,
        plda=None, device=dev,
        opts=SrePipelineOpts(
            num_gauss=cfg["ubm"]["num_gauss"], ivector_dim=e["ivector_dim"],
            num_gselect=e["num_gselect"], use_vad=True,
            vad=VadOpts(vad_energy_threshold=v["energy_threshold"],
                        vad_energy_mean_scale=v["energy_mean_scale"])))
    opts = MfccOpts(frame_opts=FrameOpts(
        samp_freq=m["samp_freq"], frame_length_ms=m["frame_length_ms"],
        frame_shift_ms=m["frame_shift_ms"], dither=0.0),
        mel_opts=MelOpts(num_bins=m["num_bins"], low_freq=m["low_freq"],
                         high_freq=m["high_freq"]),
        num_ceps=m["num_ceps"], cepstral_lifter=m["cepstral_lifter"])

    def features(wave):
        return add_deltas(mfcc(wave, opts), order=m["delta_order"],
                          window=m["delta_window"]).cpu().numpy()

    state.update(system=system, features=features)
    request(state, ctx.spans, {})
    return state


def request(state: dict, spans, capture: dict | None):
    """One request through the port: features per side, then
    SreSystem.stats and extract_batch. With `capture` (a dict), the
    sampled sides' features, statistics and i-vectors go into it."""
    system = state["system"]
    with torch.inference_mode():
        with spans.span("features"):
            feats = [state["features"](w) for w in state["waves"]]
        with spans.span("stats"):
            gamma, X = system.stats(feats)
        with spans.span("ivector"):
            ivs = system.extractor.extract_batch((gamma, X), system.device)
    if capture is not None and not capture:
        for i in state["sample"]:
            capture[i] = (feats[i], gamma[i].clone(), X[i].clone(), ivs[i])
    return float(gamma.sum()), len(feats)


def run_window(state: dict, ctx) -> dict:
    spans = ctx.spans
    capture: dict = {}
    completions = []
    frames = 0.0
    t0 = time.perf_counter()
    while True:
        f, n = request(state, spans, capture)
        now = time.perf_counter()
        frames += f
        completions.append(now)
        if now >= t0 + ctx.seconds:
            break
    state["captured"] = capture
    window_s = completions[-1] - t0
    n_req = len(completions)
    cfg = ctx.config
    return dict(
        e2e={"audio_s_per_s": n_req * state["audio_s"] / window_s},
        attempted=n_req * n, failed=0, window_s=window_s,
        completions=[c - t0 for c in completions],
        counters=dict(requests=n_req, utts=n_req * n,
                      audio_s=n_req * state["audio_s"], voiced_frames=frames,
                      window_start=t0, window_end=completions[-1],
                      num_gauss=cfg["ubm"]["num_gauss"],
                      feat_dim=3 * cfg["mfcc"]["num_ceps"],
                      ivector_dim=cfg["extractor"]["ivector_dim"]))


def trace_segment(state: dict, ctx) -> dict:
    """After the window: one more request under the profiler."""
    ctx.dtrace.start()
    try:
        request(state, ctx.spans, None)
    finally:
        ctx.dtrace.stop()
    return {}


def reference_numbers(state: dict, cfg: dict, outputs: dict,
                      device) -> dict:
    """The numbers the check compares for the sampled sides: outputs[i] =
    (features [T, 60] numpy, gamma [I], X [I, D], i-vector [K]) of the side
    under test, against the f64 reference: the largest feature
    difference; the largest statistics difference, each of gamma and X
    relative to its largest reference value; the i-vector's difference
    relative to its norm, from the waves and (`solve_err`) from the side's
    own statistics, the last stage by itself."""
    w, e = state["weights"], cfg["extractor"]
    feat_err = stats_err = iv_err = solve_err = 0.0
    for i, (feats, gamma, X, iv) in outputs.items():
        rf = ref_feats(cfg, state["waves"][i])
        feat_err = max(feat_err, float((torch.as_tensor(
            feats, device=device).double() - rf).abs().max()))
        v = cfg["vad"]
        x = rf[ref_features.energy_vad(rf, v["energy_threshold"],
                                       v["energy_mean_scale"])]
        post = ref_ivector.gselect_posteriors(
            x, w["means"], w["inv_covars"], w["weights"], e["num_gselect"],
            e["min_post"])
        g, Xr = ref_ivector.stats(post, x)
        del post
        stats_err = max(
            stats_err,
            float((torch.as_tensor(gamma, device=device).double() - g)
                  .abs().max() / g.abs().max()),
            float((torch.as_tensor(X, device=device).double() - Xr)
                  .abs().max() / Xr.abs().max()))
        r = ref_ivector.ivector(g, Xr, w["means"], w["inv_covars"], w["M"],
                                e["prior_offset"])
        iv = torch.as_tensor(iv, device=device).double()
        iv_err = max(iv_err, float((iv - r).norm() / r.norm()))
        rs = ref_ivector.ivector(
            torch.as_tensor(gamma, device=device).double(),
            torch.as_tensor(X, device=device).double(), w["means"],
            w["inv_covars"], w["M"], e["prior_offset"])
        solve_err = max(solve_err, float((iv - rs).norm() / rs.norm()))
    return dict(feat_err=feat_err, stats_err=stats_err, ivector_err=iv_err,
                solve_err=solve_err)


def control_outputs(state: dict, cfg: dict, device) -> dict:
    """The control in the program's place: the reference one precision
    below the configuration's: the features in bf16 (their products would
    be TF32, but at MFCC's shapes the card runs those in f32, so bf16, the
    step below f32 for the FFT, energies and logs, is the one that
    shows), gselect in f32 (as stated), the statistics and the i-vector in
    f32 instead of f64."""
    w, e, v = state["weights"], cfg["extractor"], cfg["vad"]
    out = {}
    for i in state["sample"]:
        rf = ref_feats(cfg, state["waves"][i], precision="bf16")
        x = rf[ref_features.energy_vad(rf, v["energy_threshold"],
                                       v["energy_mean_scale"])]
        with ref_features.matmul_precision("f32"):
            post = ref_ivector.gselect_posteriors(
                x, w["means"], w["inv_covars"], w["weights"],
                e["num_gselect"], e["min_post"], dtype=torch.float32)
            g, X = ref_ivector.stats(post, x)
            iv = ref_ivector.ivector(g, X, w["means"], w["inv_covars"],
                                     w["M"], e["prior_offset"])
        out[i] = (rf.cpu().numpy(), g, X, iv.cpu().numpy())
    return out


def free_program(state: dict):
    for k in ("system", "features"):
        state.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(state: dict, ctx) -> list:
    free_program(state)
    limits = ctx.mix["limits"]
    cap = state.get("captured") or {}
    if not cap:
        return [dict(name=n, value=float("inf"), limit=limits[n])
                for n in limits]
    nums = reference_numbers(state, ctx.config, cap, ctx.device)
    return [dict(name=n, value=nums[n], limit=limits[n]) for n in limits]


def control_numbers(ctx, shared: dict) -> dict:
    state = make_inputs(ctx, shared)
    return reference_numbers(state, ctx.config,
                             control_outputs(state, ctx.config, ctx.device),
                             ctx.device)
