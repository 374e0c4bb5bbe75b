#!/usr/bin/env python3
"""One-off readings on one CUDA card that tell apart results of
chip_smoke.py's phases; they check nothing and chip_smoke.py does not run
them. Each builds what it needs, reruns the phase it reads and logs:

    python3 chip_probes.py [ladder-decoders] [library-dbn] [sre-depth]

  ladder-decoders  phase 20, then its mono and tri test loglikes decoded
                   again by CsrBeamDecoder at beam PROBE_BEAM and by the
                   dense decoder (`make_decoder`) at LADDER_DECODE's beam
                   and max_active, beside phase 20's beam-14 WERs and
                   their overflow counts;
  library-dbn      phase 20, then the library DBN (`Rbm.cd1_step`,
                   `train_frmshuff`) at phase 39's input and depth on
                   phase 20's corpus, decoded on tri's HCLG;
  sre-depth        phase 40 at SRE_DEPTHS' depths (its checks' outcome
                   logged, not raised).

With no argument it runs all three, phase 20 once.
"""
from __future__ import annotations

import sys
import time

import numpy as np

import chip_smoke as cs
from chip_smoke import LADDER_DECODE, log, log_phase, wer

PROBE_BEAM = 30.0
# phase 39's DBN: 2 gaussian-bernoulli RBMs at DBN's rate over the 13-dim
# MFCC spliced +-5 with global CMVN, fine-tuned 4 epochs
PROBE_DBN = dict(rbms=2, epochs=4)
# phase 40's depth (SrePipelineOpts' defaults) and a cut one: 2 UBM
# iterations per size, 3 extractor EM iterations, 4 PLDA iterations
SRE_DEPTHS = (dict(ubm_iters=3, ivector_iters=4, plda_iters=8),
              dict(ubm_iters=2, ivector_iters=3, plda_iters=4))
PROBES = ("ladder-decoders", "library-dbn", "sre-depth")


def ladder_with_batches(card: str) -> tuple[dict, dict]:
    """Phase 20, recording the batches CsrBeamDecoder decodes: its first
    two are mono's and tri's test sets. -> (phase 20's result, {name:
    {packed, ll, nf, wer, overflow}})."""
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder
    seen: list = []
    decode = CsrBeamDecoder.decode

    def recording(self, loglikes, num_frames):
        res = decode(self, loglikes, num_frames)
        if len(seen) < 2:
            seen.append((self.graph, loglikes, num_frames, res,
                         int(np.sum(self.last_overflow))))
        return res
    CsrBeamDecoder.decode = recording
    try:
        ld = cs.phase_ladder_full(card)
    finally:
        CsrBeamDecoder.decode = decode
    L = ld["models"]
    batches = {}
    for name, (packed, ll, nf, res, overflow) in zip(("mono", "tri"), seen):
        w = wer(L["refs"], [[L["lang"].words.sym(x) for x in r[0]] if r
                            else [] for r in res])
        assert w == ld[name]["wer"], (name, w, ld[name]["wer"])
        batches[name] = dict(packed=packed, ll=ll, nf=nf, wer=w,
                             overflow=overflow)
    return ld, batches


def ladder_decode_variants(ld: dict, batches: dict, card: str) -> dict:
    """Phase 20's mono and tri test loglikes decoded by CsrBeamDecoder at
    LADDER_DECODE (phase 20's), at beam PROBE_BEAM, and by the dense
    decoder at LADDER_DECODE's beam and max_active (`make_decoder`, as
    phase 37's decode-faster): -> {name: {decoder: (WER, overflow or
    None, seconds)}}."""
    import torch
    from kaldi_tpu_torch.decoder.beam_search import BeamSearchOpts
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.decoder.dense import make_decoder
    L = ld["models"]
    lang, refs = L["lang"], L["refs"]

    def wer_of(res):
        return wer(refs, [[lang.words.sym(x) for x in r[0]] if r else []
                          for r in res])
    out = {}
    for name, d in batches.items():
        r = {f"csr beam {LADDER_DECODE['beam']:g}": (d["wer"], d["overflow"],
                                                    None)}
        t = time.perf_counter()
        wide = CsrBeamDecoder(d["packed"], CsrBeamOpts(
            **dict(LADDER_DECODE, beam=PROBE_BEAM)), device="cuda")
        res = wide.decode(d["ll"], d["nf"])
        torch.cuda.synchronize()
        r[f"csr beam {PROBE_BEAM:g}"] = (wer_of(res), int(np.sum(
            wide.last_overflow)), time.perf_counter() - t)
        t = time.perf_counter()
        dense = make_decoder(d["packed"], BeamSearchOpts(
            beam=LADDER_DECODE["beam"], max_active=LADDER_DECODE["max_active"],
            acoustic_scale=LADDER_DECODE["acoustic_scale"]), device="cuda")
        res = dense.decode(d["ll"], d["nf"])
        r[f"{type(dense).__name__}"] = (wer_of(res), None,
                                        time.perf_counter() - t)
        out[name] = r
        log(f"  {name}: the same test loglikes, WER by decoder: "
            + "; ".join(f"{k} {w:.2f} (overflow {o}, seconds {sec})"
                        for k, (w, o, sec) in r.items()) + f" | card: {card}")
    return out


def library_dbn(ld: dict, packed, card: str) -> dict:
    """The library DBN (`Rbm.cd1_step`, `train_frmshuff`) at phase 39's
    input and depth on phase 20's corpus: tri's alignments (phase 39 aligns
    with phase 37's tri), the 13-dim MFCC spliced +-5 to 143 dims with
    global CMVN, PROBE_DBN's RBMs (gaussian-bernoulli at DBN's rate, as
    the CLI's), fine-tuning at DBN's rate and minibatch for PROBE_DBN's
    epochs; decoded on tri's HCLG (`packed`) by CsrBeamDecoder at
    LADDER_DECODE and at beam PROBE_BEAM. -> {"frame_acc", "wer": {beam:
    WER}, "recon"}."""
    import torch
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.nnet1.nnet import Component, Nnet1, train_frmshuff
    from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
    from kaldi_tpu_torch.nnet1.train import FrameShuffler
    from kaldi_tpu_torch.steps.tdnn import align_with_gmm
    DBN = cs.DBN
    L = ld["models"]
    tri, lang, refs = L["tri"], L["lang"], L["refs"]
    t0 = time.perf_counter()
    aligned = align_with_gmm(tri, L["train"])
    raw = [f for _u, f, _w in L["train_raw"]]
    if len(aligned) != len(raw) or any(
            len(p) != len(f) for (_x, p), f in zip(aligned, raw)):
        raise AssertionError("the alignments and the raw MFCC differ")
    xs, stats = cs._dbn_inputs(raw, "cuda")
    x_all = torch.cat(xs)
    y_all = torch.as_tensor(np.concatenate([p for _x, p in aligned]),
                            device="cuda").long()
    P = tri.am.num_pdfs
    data, rbms, recon = x_all, [], []
    for li in range(PROBE_DBN["rbms"]):
        rbm = Rbm(RbmConfig(data.shape[1], DBN["hidden"],
                            learning_rate=DBN["gb_lr"]), seed=li,
                  device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(100 + li)
        mse = [rbm.cd1_step(v, gen) for v, _t in FrameShuffler(
            data, y_all, DBN["rbm_mb"], seed=li)]
        k = max(len(mse) // 10, 1)
        recon.append((float(np.mean(mse[:k])), float(np.mean(mse[-k:]))))
        with torch.no_grad():
            data = rbm.propagate(data)
        rbms.append(rbm)
    del data
    comps, params = [], {}
    for li, rbm in enumerate(rbms):
        params[f"{2 * li}.w"], params[f"{2 * li}.b"] = rbm.W, rbm.hid_bias
        comps += [Component("AffineTransform", rbm.cfg.visible_dim,
                            rbm.cfg.hidden_dim),
                  Component("Sigmoid", rbm.cfg.hidden_dim,
                            rbm.cfg.hidden_dim)]
    top = 2 * len(rbms)
    comps += [Component("AffineTransform", DBN["hidden"], P),
              Component("Softmax", P, P)]
    params[f"{top}.w"] = 0.1 * torch.randn(
        P, DBN["hidden"], generator=torch.Generator().manual_seed(7)) \
        .to("cuda")
    params[f"{top}.b"] = torch.zeros(P, device="cuda")
    dbn = Nnet1(comps, device="cuda")
    params, _hist = train_frmshuff(dbn, params, x_all, y_all,
                                   learn_rate=DBN["ft_lr"],
                                   minibatch=DBN["ft_mb"],
                                   num_epochs=PROBE_DBN["epochs"])
    with torch.no_grad():
        hit = sum(int((dbn.apply(params, x_all[i:i + 8192]).argmax(-1)
                       == y_all[i:i + 8192]).sum())
                  for i in range(0, len(y_all), 8192))
    acc = hit / len(y_all)
    counts = np.bincount(y_all.cpu().numpy(), minlength=P) + 0.5
    log_prior = torch.log(torch.as_tensor(counts / counts.sum(),
                                          dtype=torch.float32, device="cuda"))
    xt, _s = cs._dbn_inputs([f for _u, f, _w in L["test_raw"]], "cuda",
                            stats)
    nf = np.array([len(x) for x in xt])
    ll = torch.zeros(len(xt), int(nf.max()), P, device="cuda")
    with torch.no_grad():
        for b, x in enumerate(xt):
            ll[b, : len(x)] = dbn.apply(params, x) - log_prior
    out = dict(frame_acc=acc, recon=recon, wer={})
    for beam in (LADDER_DECODE["beam"], PROBE_BEAM):
        dec = CsrBeamDecoder(packed, CsrBeamOpts(
            **dict(LADDER_DECODE, beam=beam)), device="cuda")
        res = dec.decode(ll, nf)
        out["wer"][beam] = wer(refs, [[lang.words.sym(x) for x in r[0]]
                                      if r else [] for r in res])
    log(f"  the library DBN at phase 39's input and depth "
        f"({PROBE_DBN['rbms']} gaussian-bernoulli RBMs of {DBN['hidden']} at "
        f"lr {DBN['gb_lr']} over the 13-dim MFCC spliced +-5 (143 dims), "
        f"global CMVN, {PROBE_DBN['epochs']} fine-tuning epochs at "
        f"{DBN['ft_lr']} x minibatch {DBN['ft_mb']}, tri's {P} pdfs): RBM "
        f"reconstruction errors " + ", ".join(
            f"{a:.4f} -> {b:.4f}" for a, b in recon)
        + f"; training frame accuracy {acc:.4f}; WER on tri's HCLG "
        + ", ".join(f"beam {k:g} {w:.2f}" for k, w in out["wer"].items())
        + f"; {time.perf_counter() - t0:.3f} s | card: {card}")
    return out


def sre_depths(card: str) -> dict:
    """Phase 40 at each of SRE_DEPTHS. -> {depth: its EERs, or the
    checks' failure}."""
    out = {}
    keep = cs.SRE_DEPTH
    try:
        for depth in SRE_DEPTHS:
            cs.SRE_DEPTH = depth
            log(f"  phase 40 at {depth}")
            try:
                out[str(depth)] = cs.phase_sre_cli(card)["eer"]
            except AssertionError as e:
                out[str(depth)] = str(e)
    finally:
        cs.SRE_DEPTH = keep
    log("  phase 40 by depth: " + "; ".join(f"{k}: {v}"
                                            for k, v in out.items())
        + f" | card: {card}")
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probes: CUDA is not available; this script runs only on "
              "a card", file=sys.stderr)
        return 2
    probes = [a for a in argv if a in PROBES] or list(PROBES)
    if len(probes) != len(argv) and argv:
        print(f"chip_probes: probes are {', '.join(PROBES)}",
              file=sys.stderr)
        return 2
    from kaldi_tpu_torch import cuda_build
    from kaldi_tpu_torch.device import card_info, resolve_device
    resolve_device("cuda")
    card = card_info()
    cuda_build.build()
    if "ladder-decoders" in probes or "library-dbn" in probes:
        log_phase("[20/40] triphone ladder, full width")
        ld, batches = ladder_with_batches(card)
        if "ladder-decoders" in probes:
            log_phase("[probe] phase 20's loglikes by three decoders")
            ladder_decode_variants(ld, batches, card)
        if "library-dbn" in probes:
            log_phase("[probe] the library DBN at phase 39's configuration")
            library_dbn(ld, batches["tri"]["packed"], card)
        del ld, batches
    if "sre-depth" in probes:
        log_phase("[probe] phase 40 by depth")
        sre_depths(card)
    log(f"probes in {time.perf_counter() - cs.T_START:.1f} s | "
        f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
