"""Command-line entry points of the port (counterpart of kaldi_tpu/cli.py).

    python -m kaldi_tpu_torch.cli compute-fbank-feats wav.scp ark,scp:f.ark,f.scp
    python -m kaldi_tpu_torch.cli recipe-yesno-files work [--device cpu]
    python -m kaldi_tpu_torch.cli online-audio-server-decode-faster \
        final.mdl HCLG.npz --port-file port --num-connections 2
    python -m kaldi_tpu_torch.cli online-audio-client 127.0.0.1 PORT wav.scp

Ported so far: `recipe-yesno`, the online / onlinebin subcommands of
kaldi_tpu/cli_online_extra.py (`cli_online_extra.py`) and the first CLI
slice: feature extraction, CMVN, feature tables, matrices, vectors and
transforms, waves and data-dir utilities, the card probes, monophone /
TDNN / nnet3 training, alignment, graph building and decoding, and the
file-driven yesno recipe (`cli_misc.py` and `cli_nnet.py` hold the
slice's commands that JAX keeps there). Commands read and write the JAX
package's files: arks through `io/kaldi_io.py`, models through
`io/model_io.py`. Every command that builds a device object takes
`--device` (default: cuda) and raises without a card; host commands
(copies, selections, statistics, numpy arithmetic) write JAX's bytes.
`--config=FILE` expands as util/parse-options.h:44 does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from kaldi_tpu_torch import cli_misc, cli_nnet, cli_online_extra


def _expand_config_args(argv):
    """ParseOptions --config=FILE: read 'key value' or '--key=value' lines."""
    out = []
    for a in argv:
        if a.startswith("--config="):
            with open(a.split("=", 1)[1]) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        out.append(line if line.startswith("--")
                                   else "--" + line.replace(" ", "="))
        else:
            out.append(a)
    return out


def _read_wav_scp(path):
    """wav.scp lines -> (utt, path) pairs."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                yield parts


def _read_text_file(path):
    """Kaldi text file -> dict utt -> word list."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def _load_train_utts(text_path, rspecifier):
    """-> [(utt, feats, words)] joining a text file with a feature ark."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    text = _read_text_file(text_path)
    utts = []
    for utt, feats in open_rspecifier(rspecifier):
        if utt in text:
            utts.append((utt, feats.astype(np.float32), text[utt]))
    if not utts:
        raise SystemExit("no utterances joined between text and features")
    return utts


def _read_utt2spk(path: str) -> dict:
    """utt2spk lines -> {utt: spk}; {} for an empty path."""
    m = {}
    if path:
        with open(path) as f:
            for line in f:
                toks = line.split()
                if len(toks) >= 2:
                    m[toks[0]] = toks[1]
    return m


def _sum_archives(paths, average=False):
    """Per-key elementwise sum across archives (ref: bin/matrix-sum.cc,
    bin/vector-sum.cc — the sharded-job stats-merging convention)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    acc: dict = {}
    counts: dict = {}
    for p in paths:
        for k, v in open_rspecifier(p):
            v = np.asarray(v, np.float64)
            if k in acc:
                acc[k] = acc[k] + v
                counts[k] += 1
            else:
                acc[k] = v
                counts[k] = 1
    if average:
        for k in acc:
            acc[k] = acc[k] / counts[k]
    return acc


def _pad_batch(mats, fill: float = 0.0):
    """[(key, [T_b, D])] -> ([B, T, D] f32 padded with `fill`, [B] int32)."""
    B = len(mats)
    T = max(m.shape[0] for (_k, m) in mats)
    x = np.full((B, T, mats[0][1].shape[1]), fill, np.float32)
    nf = np.zeros(B, np.int32)
    for b, (_k, m) in enumerate(mats):
        x[b, : m.shape[0]] = m
        nf[b] = m.shape[0]
    return x, nf


def _device(args) -> torch.device:
    """The command's `--device`, resolved (raises without a card)."""
    from kaldi_tpu_torch.device import resolve_device
    return resolve_device(args.device)


def _to_host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


# ------------------------------------------------------------- features

def _feature_cmd(kind):
    def run(args):
        from kaldi_tpu_torch import ops
        from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
        from kaldi_tpu_torch.io.wave import read_wave

        dev = _device(args)
        fo = ops.FrameOpts(samp_freq=args.sample_frequency,
                           dither=args.dither,
                           frame_length_ms=args.frame_length,
                           frame_shift_ms=args.frame_shift)
        def on_device(fn, opts):
            return lambda w: _to_host(fn(torch.as_tensor(w, device=dev),
                                         opts))

        if kind == "mfcc":
            compute = on_device(ops.mfcc, ops.MfccOpts(
                frame_opts=fo, num_ceps=args.num_ceps,
                mel_opts=ops.MelOpts(num_bins=args.num_mel_bins)))
        elif kind == "fbank":
            compute = on_device(ops.fbank, ops.FbankOpts(
                frame_opts=fo,
                mel_opts=ops.MelOpts(num_bins=args.num_mel_bins)))
        elif kind == "spectrogram":
            compute = on_device(ops.spectrogram,
                                ops.SpectrogramOpts(frame_opts=fo))
        elif kind == "plp":
            compute = on_device(ops.plp, ops.PlpOpts(
                frame_opts=fo,
                mel_opts=ops.MelOpts(num_bins=args.num_mel_bins)))
        elif kind == "pitch":
            from kaldi_tpu_torch.ops.pitch import (PitchOpts,
                                                   compute_kaldi_pitch,
                                                   process_pitch)
            popts = PitchOpts(samp_freq=args.sample_frequency,
                              frame_shift_ms=args.frame_shift,
                              frame_length_ms=args.frame_length)
            compute = lambda w: process_pitch(  # noqa: E731
                compute_kaldi_pitch(w, popts, device=dev))
        n = 0
        with open_wspecifier(args.wspecifier, compress=args.compress) as out:
            for utt, path in _read_wav_scp(args.wav_scp):
                wave, sr = read_wave(path)
                feats = np.asarray(compute(wave[args.channel]))
                out.write(utt, feats)
                n += 1
        print(f"{kind}: processed {n} utterances", file=sys.stderr)

    return run


def cmd_copy_feats(args):
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier, compress=args.compress) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, v)
            n += 1
    print(f"copied {n} features", file=sys.stderr)


def _map_on_device(args, fn):
    """Each matrix of args.rspecifier through fn on the device ->
    args.wspecifier."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    dev = _device(args)
    with open_wspecifier(args.wspecifier,
                         compress=getattr(args, "compress", False)) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, _to_host(fn(torch.as_tensor(v, device=dev))))


def cmd_add_deltas(args):
    from kaldi_tpu_torch.ops import add_deltas
    _map_on_device(args, lambda x: add_deltas(x, order=args.delta_order,
                                              window=args.delta_window))


def cmd_splice_feats(args):
    from kaldi_tpu_torch.ops import splice_frames
    _map_on_device(args, lambda x: splice_frames(x, args.left_context,
                                                 args.right_context))


def cmd_compute_cmvn_stats(args):
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.transform.cmvn import CmvnStats
    spk2utt = None
    if args.spk2utt:
        spk2utt = {}
        with open(args.spk2utt) as f:
            for line in f:
                parts = line.split()
                for u in parts[1:]:
                    spk2utt[u] = parts[0]
    stats: dict = {}
    dim = None
    for k, v in open_rspecifier(args.rspecifier):
        key = spk2utt.get(k, k) if spk2utt else k
        if key not in stats:
            stats[key] = CmvnStats(v.shape[1])
        stats[key].accumulate(v)
        dim = v.shape[1]
    with open_wspecifier(args.wspecifier) as out:
        for key, st in stats.items():
            out.write(key, st.stats)
    print(f"computed CMVN stats for {len(stats)} keys (dim {dim})",
          file=sys.stderr)


def cmd_apply_cmvn(args):
    """(ref: featbin/apply-cmvn.cc) The statistics stay f64 on the host,
    the features are normalized on the device."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.transform.cmvn import CmvnStats, apply_cmvn
    dev = _device(args)
    cmvn = {}
    for k, v in open_rspecifier(args.cmvn_rspecifier):
        st = CmvnStats(v.shape[1] - 1)
        st.stats = v
        cmvn[k] = st
    utt2spk = {}
    if args.utt2spk:
        with open(args.utt2spk) as f:
            for line in f:
                u, s = line.split()[:2]
                utt2spk[u] = s
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            key = utt2spk.get(k, k)
            out.write(k, _to_host(apply_cmvn(
                torch.as_tensor(v, device=dev), cmvn[key],
                norm_vars=args.norm_vars)))


def cmd_compute_wer(args):
    from kaldi_tpu_torch.utils.wer import compute_wer
    refs, hyps = _read_text_file(args.ref), _read_text_file(args.hyp)
    stats = compute_wer(refs, hyps)
    print(stats)
    if getattr(args, "max_wer", None) is not None \
            and stats.wer > args.max_wer:
        sys.exit(1)


def cmd_wav_reverberate(args):
    """(ref: featbin/wav-reverberate.cc) The convolution runs on the
    device."""
    from kaldi_tpu_torch.io.wave import read_wave, write_wave
    from kaldi_tpu_torch.ops.signal import reverberate
    dev = _device(args)
    wave, sr = read_wave(args.input_wav)
    rir, _sr2 = read_wave(args.rir_wav)
    out = reverberate(wave[0], rir[0], device=dev)
    write_wave(args.output_wav, np.asarray(out), sr)


def cmd_compute_vad(args):
    """(ref: ivectorbin/compute-vad.cc — energy VAD over features)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.ivector.vad import VadOpts, compute_vad
    opts = VadOpts(vad_energy_threshold=args.vad_energy_threshold,
                   vad_energy_mean_scale=args.vad_energy_mean_scale)
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, compute_vad(v, opts).astype(np.float32))


def cmd_select_voiced_frames(args):
    """(ref: ivectorbin/select-voiced-frames.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.ivector.vad import select_voiced_frames
    vad = dict(open_rspecifier(args.vad_rspecifier))
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, select_voiced_frames(v, vad[k]))


def cmd_subsample_feats(args):
    """(ref: featbin/subsample-feats.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, v[args.offset:: args.n])


def cmd_select_feats(args):
    """(ref: featbin/select-feats.cc — column ranges like '0-12,26-38')."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    cols = []
    for piece in args.columns.split(","):
        if "-" in piece:
            a, b = piece.split("-")
            cols.extend(range(int(a), int(b) + 1))
        else:
            cols.append(int(piece))
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, v[:, cols])


def cmd_extract_segments(args):
    """(ref: featbin/extract-segments.cc — cut waves per segments file)."""
    from kaldi_tpu_torch.io.wave import read_wave, write_wave
    recs = dict(_read_wav_scp(args.wav_scp))
    os.makedirs(args.out_dir, exist_ok=True)
    lines = []
    with open(args.segments) as f:
        for line in f:
            utt, rec, t0, t1 = line.split()[:4]
            wave, sr = read_wave(recs[rec])
            lo, hi = int(float(t0) * sr), int(float(t1) * sr)
            out_path = os.path.join(args.out_dir, f"{utt}.wav")
            write_wave(out_path, wave[0, lo:hi], sr)
            lines.append(f"{utt} {out_path}")
    print("\n".join(lines))


# ---------------------------------------------------- graphs and decoding

def cmd_mkgraph(args):
    """Build the decode graph from a saved model + ARPA LM
    (ref: utils/mkgraph.sh — HCLG = asl(det(H∘det(C∘det(L∘G))))). Host
    work: only the model's lexicon, transition model and tree are read
    (its gaussians are loaded on the CPU and not used)."""
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    from kaldi_tpu_torch.fst.graph import make_hclg
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_hclg
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    model = load_gmm_system(args.model, device="cpu")
    with open(args.arpa) as f:
        g = arpa_to_g(ArpaLm.parse(f.read()), model.lang.words)
    if args.flat:
        # native/columnar pipeline: vocabulary-scale builds in minutes
        # (compose/det*/min in C++, AddSelfLoops vectorized)
        from kaldi_tpu_torch.fst.mkgraph_flat import (make_hclg_flat,
                                                      pack_graph_flat)
        hclg, _stats = make_hclg_flat(
            model.lang, g, model.trans_model, model.ctx_dep,
            self_loop_scale=args.self_loop_scale, verbose=args.verbose)
        packed = pack_graph_flat(hclg, model.trans_model.id2pdf_array)
    else:
        graph = make_hclg(model.lang, g, model.trans_model, model.ctx_dep,
                          self_loop_scale=args.self_loop_scale)
        packed = pack_graph(graph.fst, model.trans_model.id2pdf_array)
    save_hclg(args.graph_out, packed)
    print(f"HCLG: {packed.num_states} states", file=sys.stderr)


def _write_transcripts(args, keys, results, sym):
    out = open(args.transcription_out, "w") if args.transcription_out \
        else sys.stdout
    for b, k in enumerate(keys):
        words = "" if results[b] is None else " ".join(
            sym(w) for w in results[b][0])
        out.write(f"{k} {words}\n")
    if args.transcription_out:
        out.close()


def _beam_opts(args):
    from kaldi_tpu_torch.decoder.beam_search import BeamSearchOpts
    return BeamSearchOpts(beam=args.beam, max_active=args.max_active,
                          acoustic_scale=args.acoustic_scale)


def cmd_decode_faster(args):
    """Batched best-path decoding from a feature rspecifier
    (ref: gmmbin/gmm-decode-faster.cc / gmm-latgen-faster best path), by
    the decoder `make_decoder` picks for the graph, on the device."""
    from kaldi_tpu_torch.decoder.dense import make_decoder
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    packed = load_hclg(args.graph)
    dec = make_decoder(packed, _beam_opts(args), device=dev)
    items = list(open_rspecifier(args.rspecifier))
    feats, nf = _pad_batch(items)
    results = dec.decode(model.am.loglikes_np(feats), nf)
    _write_transcripts(args, [k for (k, _f) in items], results,
                       model.lang.words.sym)


def cmd_decode_faster_mapped(args):
    """Best-path decode from precomputed loglike matrices
    (ref: bin/decode-faster-mapped.cc), by the decoder `make_decoder`
    picks for the graph (the CSR beam decoder on a large graph, whose
    emitting rounds launch the table-gather kernel), on the device."""
    from kaldi_tpu_torch.decoder.dense import make_decoder
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_hclg
    dev = _device(args)
    packed = load_hclg(args.graph)
    items = list(open_rspecifier(args.loglikes_rspecifier))
    dec = make_decoder(packed, _beam_opts(args), device=dev)
    ll, nf = _pad_batch(items, fill=-1e10)
    results = dec.decode(ll, nf)
    _write_transcripts(args, [k for (k, _m) in items], results, str)


# --------------------------------------------------------- feature tables

def cmd_transform_feats(args):
    """Apply a linear/affine transform matrix to features
    (ref: featbin/transform-feats.cc — [D_out, D] linear or [D_out, D+1]
    affine, auto-detected by width; a multi-matrix archive is looked up
    per utterance, or per speaker with --utt2spk, the fMLLR decode
    convention). The product runs on the device in f64, as JAX's numpy
    product does on the host."""
    from kaldi_tpu_torch.io.kaldi_io import (open_rspecifier, open_wspecifier,
                                             read_ark)
    dev = _device(args)
    mats = {k: np.asarray(v, np.float64)
            for (k, v) in read_ark(args.transform)}
    utt2spk = _read_utt2spk(args.utt2spk)
    single = next(iter(mats.values())) if len(mats) == 1 else None

    def lookup(utt):
        if single is not None and not utt2spk:
            return single
        key = utt2spk.get(utt, utt)
        return mats.get(key)

    n_skip = 0
    with open_wspecifier(args.wspecifier, compress=args.compress) as out:
        for utt, feats in open_rspecifier(args.rspecifier):
            W = lookup(utt)
            if W is None:
                print(f"transform-feats: no transform for {utt}",
                      file=sys.stderr)
                n_skip += 1
                continue
            D = feats.shape[1]
            x = torch.as_tensor(feats, dtype=torch.float64, device=dev)
            w = torch.as_tensor(W, device=dev)
            if W.shape[1] == D:
                y = x @ w.T
            elif W.shape[1] == D + 1:
                y = x @ w[:, :D].T + w[:, D]
            else:
                raise SystemExit(
                    f"transform cols {W.shape[1]} vs feat dim {D}")
            out.write(utt, _to_host(y).astype(np.float32))
    if n_skip:
        print(f"transform-feats: skipped {n_skip} utts", file=sys.stderr)


def cmd_paste_feats(args):
    """Concatenate feature streams frame-by-frame
    (ref: featbin/paste-feats.cc; length mismatches within
    --length-tolerance are truncated to the shortest)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    streams = [dict(open_rspecifier(r)) for r in args.rspecifiers]
    with open_wspecifier(args.wspecifier, compress=args.compress) as out:
        for utt in streams[0]:
            if not all(utt in s for s in streams):
                continue
            mats = [s[utt] for s in streams]
            lens = [m.shape[0] for m in mats]
            if max(lens) - min(lens) > args.length_tolerance:
                print(f"paste-feats: skipping {utt}: lengths {lens}",
                      file=sys.stderr)
                continue
            L = min(lens)
            out.write(utt, np.concatenate([m[:L] for m in mats], axis=1))


def cmd_subset_feats(args):
    """First N (or --last) utterances (ref: featbin/subset-feats.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    items = list(open_rspecifier(args.rspecifier))
    keep = items[-args.n:] if args.last else items[: args.n]
    with open_wspecifier(args.wspecifier, compress=args.compress) as out:
        for utt, feats in keep:
            out.write(utt, feats)


def cmd_apply_cmvn_sliding(args):
    """Sliding-window CMVN (ref: featbin/apply-cmvn-sliding.cc), on the
    device."""
    from kaldi_tpu_torch.ops.delta import SlidingCmvnOpts, sliding_cmvn
    opts = SlidingCmvnOpts(cmn_window=args.cmn_window,
                           min_window=args.min_window,
                           normalize_variance=args.norm_vars,
                           center=args.center)
    _map_on_device(args, lambda x: sliding_cmvn(x, opts))


def cmd_copy_matrix(args):
    """Copy a matrix/vector ark (optionally scaling)
    (ref: bin/copy-matrix.cc / copy-vector.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    with open_wspecifier(args.wspecifier, compress=args.compress) as out:
        for key, m in open_rspecifier(args.rspecifier):
            out.write(key, np.asarray(m) * args.scale)


# ------------------------------------------------------------ probes

def cmd_info(args):
    """JAX's `info` keys, with torch's version and devices in place of
    JAX's."""
    import kaldi_tpu_torch
    from kaldi_tpu_torch.io import native
    devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
               if torch.cuda.is_available() else ["cpu"])
    print(json.dumps({
        "version": getattr(kaldi_tpu_torch, "__version__", "0.1"),
        "torch": torch.__version__,
        "devices": devices,
        "native_ark_io": native.available(),
    }, indent=2))


def cmd_apply_cmvn_online(args):
    """Causal (online) cepstral mean/variance normalization per utterance
    (ref: online2bin/apply-cmvn-online.cc); host f64, as in JAX."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.online.features import OnlineCmvn, OnlineCmvnOpts
    opts = OnlineCmvnOpts(cmn_window=args.cmn_window,
                          normalize_variance=args.norm_vars)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            cmvn = OnlineCmvn(opts)
            out.write(k, np.asarray(cmvn.apply(v), np.float32))
            n += 1
    print(f"apply-cmvn-online: {n} utterances", file=sys.stderr)


def cmd_split_scp(args):
    """Deterministic round-robin split of an scp/text file into N parts
    (ref: utils/split_scp.pl — the job-array sharding primitive)."""
    with open(args.scp) as f:
        lines = [ln for ln in f if ln.strip()]
    n = args.num_jobs
    outs = [args.out_pattern.replace("JOB", str(j + 1))
            for j in range(n)]
    keys = sorted(range(len(lines)), key=lambda i: lines[i].split()[0])
    for j, path in enumerate(outs):
        with open(path, "w") as f:
            for i in keys[j::n]:
                f.write(lines[i])
    print(f"split-scp: {len(lines)} lines -> {n} parts", file=sys.stderr)


def cmd_utt2spk_to_spk2utt(args):
    """(ref: utils/utt2spk_to_spk2utt.pl)"""
    spk2utt: dict = {}
    with open(args.utt2spk) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                spk2utt.setdefault(parts[1], []).append(parts[0])
    for spk in sorted(spk2utt):
        print(f"{spk} " + " ".join(sorted(spk2utt[spk])))


# ------------------------------------------------------------ training

def cmd_train_mono(args):
    """Flat-start monophone training from a data dir's text + features
    (ref: steps/train_mono.sh driving gmm-init-mono / gmm-align-compiled /
    gmm-acc-stats-ali / gmm-est — fused into one file-driven command), on
    the device."""
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.io.model_io import save_gmm_system
    from kaldi_tpu_torch.steps.mono import MonoTrainOpts, train_mono
    dev = _device(args)
    with open(args.lexicon) as f:
        lex = Lexicon.parse(f.read())
    lang = prepare_lang(lex, [args.sil_phone], args.sil_phone,
                        num_sil_states=args.num_sil_states)
    utts = _load_train_utts(args.text, args.rspecifier)
    model = train_mono(lang, utts, MonoTrainOpts(
        num_iters=args.num_iters, totgauss=args.totgauss,
        max_iter_inc=args.max_iter_inc,
        realign_iters=tuple(range(1, args.num_iters))), device=dev)
    save_gmm_system(args.model_out, model)
    print(f"train-mono: {len(utts)} utts -> {model.am.num_pdfs} pdfs",
          file=sys.stderr)


def cmd_gmm_align(args):
    """Forced alignment: transition-id ark from a model + text + feats
    (ref: gmmbin/gmm-align-compiled.cc); loglikes and Viterbi on the
    device."""
    from kaldi_tpu_torch.decoder.graph_pack import pack_graphs
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.fst.graph import TrainingGraphCompiler
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    utts = _load_train_utts(args.text, args.rspecifier)
    compiler = TrainingGraphCompiler(
        model.lang, model.trans_model, model.ctx_dep,
        transition_scale=args.transition_scale,
        self_loop_scale=args.self_loop_scale)
    cache: dict = {}
    graphs = []
    for (_u, _f, words) in utts:
        key = tuple(words)
        if key not in cache:
            cache[key] = compiler.compile_transcript(list(words))
        graphs.append(cache[key])
    feats, nf = _pad_batch([(u, f) for (u, f, _w) in utts])
    batch = pack_graphs(graphs, model.trans_model.id2pdf_array)
    results = viterbi_align(batch, model.am.loglikes_np(feats), nf,
                            args.acoustic_scale, device=dev)
    n_ok = 0
    with open_wspecifier(args.wspecifier) as out:
        for b, res in enumerate(results):
            if res is None:
                print(f"gmm-align: failed for {utts[b][0]}",
                      file=sys.stderr)
                continue
            out.write(utts[b][0], np.asarray(res[0], np.int32))
            n_ok += 1
    print(f"gmm-align: aligned {n_ok}/{len(utts)}", file=sys.stderr)


# ------------------------------------------------ matrices and vectors

def cmd_matrix_dim(args):
    """(ref: bin/matrix-dim.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    for k, m in open_rspecifier(args.rspecifier):
        print(f"{k} {m.shape[0]} {m.shape[1]}")


def cmd_matrix_sum_rows(args):
    """(ref: bin/matrix-sum-rows.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, m in open_rspecifier(args.rspecifier):
            out.write(k, np.asarray(m, np.float64).sum(0)
                      .astype(np.float32))
            n += 1
    print(f"matrix-sum-rows: {n}", file=sys.stderr)


def cmd_vector_scale(args):
    """(ref: bin/vector-scale.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, (np.asarray(v, np.float64) * args.scale)
                      .astype(np.float32))
            n += 1
    print(f"vector-scale: {n}", file=sys.stderr)


def cmd_transform_vec(args):
    """Apply a linear/affine transform to every vector
    (ref: bin/transform-vec.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import (open_rspecifier, open_wspecifier,
                                             read_ark)
    mats = dict(read_ark(args.transform))
    (M,) = mats.values()
    M = np.asarray(M, np.float64)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            v = np.asarray(v, np.float64)
            if M.shape[1] == v.size + 1:
                y = M[:, :-1] @ v + M[:, -1]
            else:
                y = M @ v
            out.write(k, y.astype(np.float32))
            n += 1
    print(f"transform-vec: {n}", file=sys.stderr)


def cmd_extend_wav_with_silence(args):
    """Append silence to each wav (ref:
    online2bin/extend-wav-with-silence.cc; zeros, the degenerate case)."""
    from kaldi_tpu_torch.io.wave import read_wave, write_wave
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    with open(os.path.join(args.out_dir, "wav.scp"), "w") as scp:
        for utt, path in _read_wav_scp(args.wav_scp):
            wave, sr = read_wave(path)
            pad = np.zeros((wave.shape[0], int(args.extend_secs * sr)),
                           wave.dtype)
            out_path = os.path.join(args.out_dir, f"{utt}.wav")
            write_wave(out_path, np.concatenate([wave, pad], axis=1), sr)
            scp.write(f"{utt} {out_path}\n")
            n += 1
    print(f"extend-wav-with-silence: {n} utts", file=sys.stderr)


def cmd_interpolate_pitch(args):
    """Linearly interpolate pitch through unvoiced regions
    (ref: featbin/interpolate-pitch.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, f in open_rspecifier(args.rspecifier):
            f = np.array(f, np.float64)
            nccf, pitch = f[:, 0], f[:, 1].copy()
            voiced = nccf > args.pov_threshold
            if voiced.any():
                idx = np.flatnonzero(voiced)
                pitch = np.interp(np.arange(len(pitch)), idx,
                                  pitch[idx])
            f[:, 1] = pitch
            out.write(k, f.astype(np.float32))
            n += 1
    print(f"interpolate-pitch: {n}", file=sys.stderr)


def cmd_extract_rows(args):
    """Row ranges from matrices, driven by a ranges file
    ('out_key in_key start end'; ref: featbin/extract-rows.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    feats = dict(open_rspecifier(args.rspecifier))
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        with open(args.ranges) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                ok, ik, lo, hi = (parts[0], parts[1], int(parts[2]),
                                  int(parts[3]))
                if ik not in feats:
                    continue
                out.write(ok, feats[ik][lo:hi])
                n += 1
    print(f"extract-rows: {n} segments", file=sys.stderr)


def cmd_extend_transform_dim(args):
    """Pad a transform to a larger dim with identity rows/cols
    (ref: featbin/extend-transform-dim.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark
    (M,) = [v for _, v in read_ark(args.transform)]
    M = np.asarray(M, np.float64)
    out_d, in_c = M.shape
    affine = in_c == out_d + 1
    in_d = in_c - 1 if affine else in_c
    new_d = args.new_dimension
    out = np.zeros((new_d, new_d + 1 if affine else new_d))
    out[:out_d, :in_d] = M[:, :in_d]
    for d in range(out_d, new_d):
        out[d, d] = 1.0
    if affine:
        out[:out_d, -1] = M[:, -1]
    write_ark(args.transform_out, {"t": out.astype(np.float32)})
    print(f"extend-transform-dim: {out_d} -> {new_d}", file=sys.stderr)


def cmd_copy_feats_to_sphinx(args):
    """Per-utterance Sphinx .mfc feature files: int32 count header +
    float32 data, big-endian (ref: featbin/copy-feats-to-sphinx.cc)."""
    import struct
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for k, f in open_rspecifier(args.rspecifier):
        data = np.asarray(f, ">f4")
        with open(os.path.join(args.out_dir, k + ".mfc"), "wb") as out:
            out.write(struct.pack(">i", data.size))
            out.write(data.tobytes())
        n += 1
    print(f"copy-feats-to-sphinx: {n} files", file=sys.stderr)


def cmd_compute_and_process_pitch(args):
    """Fused pitch extraction + post-processing: wav -> [T, 3]
    (pov_feature, norm_log_pitch, delta_pitch) in one pass
    (ref: featbin/compute-and-process-kaldi-pitch-feats.cc); the NCCF on
    the device, the post-processing on the host as in JAX."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.io.wave import read_wave
    from kaldi_tpu_torch.ops.pitch import (PitchOpts, compute_kaldi_pitch,
                                           process_pitch)
    dev = _device(args)
    popts = PitchOpts(samp_freq=args.sample_frequency,
                      frame_length_ms=args.frame_length,
                      frame_shift_ms=args.frame_shift)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, path in _read_wav_scp(args.wav_scp):
            wave, _sr = read_wave(path)
            raw = compute_kaldi_pitch(np.asarray(wave[0]), popts, device=dev)
            out.write(utt, np.asarray(process_pitch(raw), np.float32))
            n += 1
    print(f"compute-and-process-kaldi-pitch-feats: {n}", file=sys.stderr)


def cmd_compose_transforms(args):
    """out = A ∘ B (apply B first) for linear [Do, Di] / affine
    [Do, Di+1] matrices (ref: featbin/compose-transforms.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark

    def read_one(path):
        mats = dict(read_ark(path))
        if len(mats) != 1:
            raise SystemExit(f"{path}: expected a single-matrix ark")
        return np.asarray(next(iter(mats.values())), np.float64)

    A, B = read_one(args.a), read_one(args.b)
    db = B.shape[0]                     # A consumes B's output dim
    # affine iff cols == rows+1 (the square-transform convention);
    # --b-is-affine forces it for rectangular B (ref: the reference's
    # identical flag on compose-transforms)
    b_affine = args.b_is_affine or B.shape[1] == B.shape[0] + 1
    a_affine = A.shape[1] == db + 1
    if not a_affine and A.shape[1] != db:
        raise SystemExit(f"incompatible shapes {A.shape} {B.shape}")
    if a_affine:
        # homogeneous pad of B: [[B, b or 0], [0, 1]]
        if b_affine:
            Bh = np.vstack([B, np.zeros(B.shape[1])])
        else:
            Bh = np.vstack([np.hstack([B, np.zeros((db, 1))]),
                            np.zeros(B.shape[1] + 1)])
        Bh[-1, -1] = 1.0
        C = A @ Bh
    else:
        C = A @ B          # linear A: affine-ness of B carries through
    write_ark(args.out, {"composed": np.asarray(C, np.float32)})
    print(f"compose-transforms: {C.shape[0]}x{C.shape[1]}",
          file=sys.stderr)


def cmd_est_pca(args):
    """PCA transform from pooled features
    (ref: bin/est-pca.cc / matrix-functions.h ComputePca); host f64."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
    from kaldi_tpu_torch.utils.optimization import est_pca
    pooled = np.concatenate([v for (_k, v) in
                             open_rspecifier(args.rspecifier)])
    W = est_pca(pooled.astype(np.float64), args.dim,
                normalize_variance=args.normalize_variance,
                normalize_mean=not args.no_normalize_mean)
    write_ark(args.matrix_out, {"pca": np.asarray(W, np.float32)})
    print(f"est-pca: {W.shape[0]}x{W.shape[1]} from {len(pooled)} frames",
          file=sys.stderr)


def cmd_copy_vector(args):
    """(ref: bin/copy-vector.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, np.asarray(v, np.float32))
            n += 1
    print(f"copy-vector: {n}", file=sys.stderr)


def cmd_copy_int_vector(args):
    """(ref: bin/copy-int-vector.cc — alignments etc.)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, np.asarray(v, np.int32))
            n += 1
    print(f"copy-int-vector: {n}", file=sys.stderr)


def _sum_cmd(name):
    def run(args):
        from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
        acc = _sum_archives(args.rspecifiers, args.average)
        with open_wspecifier(args.wspecifier) as out:
            for k in sorted(acc):
                out.write(k, acc[k].astype(np.float32))
        print(f"{name}: {len(acc)} keys", file=sys.stderr)
    return run


def cmd_train_tdnn(args):
    """nnet2-style multisplice TDNN training from GMM alignments
    (ref: steps/nnet2/train_multisplice_accel2.sh + nnet2bin/nnet-train*),
    on the device. The weights start from a torch.Generator, not JAX's
    key: the trained file matches JAX's by outcome, not bit for bit."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_am_nnet
    from kaldi_tpu_torch.nnet.train import NnetTrainOpts
    from kaldi_tpu_torch.steps.tdnn import train_tdnn
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    utts = _load_train_utts(args.text, args.rspecifier)
    res = train_tdnn(model, utts, train_opts=NnetTrainOpts(
        initial_lr=args.initial_lr, final_lr=args.final_lr,
        num_epochs=args.num_epochs, minibatch_size=args.minibatch_size,
        momentum=args.momentum))
    save_am_nnet(args.nnet_out, res.am)
    hist = res.history[-1] if res.history else (0, 0, 0.0, 0.0)
    print(f"train-tdnn: final loss {hist[2]:.3f} acc {hist[3]:.3f}",
          file=sys.stderr)


def cmd_append_feats(args):
    """Concatenate two archives' features in TIME per key
    (ref: featbin/append-feats.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    a = dict(open_rspecifier(args.rspecifier_a))
    b = dict(open_rspecifier(args.rspecifier_b))
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k in sorted(set(a) & set(b)):
            out.write(k, np.concatenate([a[k], b[k]], axis=0))
            n += 1
    print(f"append-feats: {n} utts", file=sys.stderr)


def cmd_append_vector_to_feats(args):
    """Paste a per-utterance vector onto every frame
    (ref: featbin/append-vector-to-feats.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    vecs = dict(open_rspecifier(args.vec_rspecifier))
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, f in open_rspecifier(args.rspecifier):
            if k not in vecs:
                continue
            v = np.broadcast_to(vecs[k][None, :],
                                (f.shape[0], vecs[k].size))
            out.write(k, np.concatenate([f, v], axis=1))
            n += 1
    print(f"append-vector-to-feats: {n} utts", file=sys.stderr)


def cmd_compare_feats(args):
    """Per-key normalized cross-correlation of two archives; exits
    nonzero when the mean similarity is under the threshold
    (ref: featbin/compare-feats.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    a = dict(open_rspecifier(args.rspecifier_a))
    b = dict(open_rspecifier(args.rspecifier_b))
    sims = []
    for k in sorted(set(a) & set(b)):
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        if x.shape != y.shape:
            sims.append(0.0)
            continue
        num = float((x * y).sum())
        den = float(np.linalg.norm(x) * np.linalg.norm(y)) or 1.0
        sims.append(num / den)
    mean_sim = float(np.mean(sims)) if sims else 0.0
    print(f"compare-feats: mean similarity {mean_sim:.6f} over "
          f"{len(sims)} pairs", file=sys.stderr)
    if mean_sim < args.threshold:
        sys.exit(1)


def cmd_reverse_feats(args):
    """(ref: featbin/reverse-feats.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, f in open_rspecifier(args.rspecifier):
            out.write(k, np.ascontiguousarray(f[::-1]))
            n += 1
    print(f"reverse-feats: {n}", file=sys.stderr)


def cmd_remove_mean(args):
    """(ref: featbin/remove-mean.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, f in open_rspecifier(args.rspecifier):
            out.write(k, (f - f.mean(axis=0, keepdims=True))
                      .astype(np.float32))
            n += 1
    print(f"remove-mean: {n}", file=sys.stderr)


def cmd_extract_feature_segments(args):
    """Cut feature archives by a segments file (utt base tstart tend)
    (ref: featbin/extract-feature-segments.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    feats = dict(open_rspecifier(args.rspecifier))
    shift = args.frame_shift
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        with open(args.segments) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                utt, base, t0, t1 = (parts[0], parts[1],
                                     float(parts[2]), float(parts[3]))
                if base not in feats:
                    continue
                lo = int(round(t0 / shift))
                hi = int(round(t1 / shift))
                seg = feats[base][lo:hi]
                if len(seg) == 0:
                    continue
                out.write(utt, seg)
                n += 1
    print(f"extract-feature-segments: {n} segments", file=sys.stderr)


def cmd_copy_feats_to_htk(args):
    """Write each utterance as an HTK feature file in a directory
    (ref: featbin/copy-feats-to-htk.cc)."""
    from kaldi_tpu_torch.io.htk import write_htk
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for k, f in open_rspecifier(args.rspecifier):
        write_htk(os.path.join(args.out_dir, k + args.ext),
                  np.asarray(f, np.float32),
                  samp_period=int(args.sample_period))
        n += 1
    print(f"copy-feats-to-htk: {n} files", file=sys.stderr)


def cmd_process_pitch_feats(args):
    """(nccf, pitch) -> (pov, norm-log-pitch, delta-pitch)
    (ref: featbin/process-kaldi-pitch-feats.cc); host, as in JAX."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.ops.pitch import process_pitch
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, f in open_rspecifier(args.rspecifier):
            out.write(k, np.asarray(process_pitch(np.asarray(f)),
                                    np.float32))
            n += 1
    print(f"process-pitch-feats: {n}", file=sys.stderr)


def cmd_detect_sinusoids(args):
    """Report dominant sinusoids per utterance
    (ref: featbin/detect-sinusoids.cc, feat/sinusoid-detection.h)."""
    from collections import Counter
    from kaldi_tpu_torch.io.wave import read_wave
    from kaldi_tpu_torch.ops.sinusoid import detect_tones
    for utt, path in _read_wav_scp(args.wav_scp):
        wave, sr = read_wave(path)
        frames = detect_tones(wave[0], sr)
        hist: Counter = Counter()
        for (_t, sins) in frames:
            for s in sins:
                hist[round(s.freq / 10.0) * 10] += 1
        top = ", ".join(f"{f}Hz x{c}"
                        for f, c in hist.most_common(args.max_out))
        print(f"{utt} {top}")


def cmd_add_deltas_sdc(args):
    """Shifted-delta-cepstra features (the LID front end)
    (ref: featbin/add-deltas-sdc.cc, feature-functions.h:229), on the
    device."""
    from kaldi_tpu_torch.ops.delta import shifted_delta
    _map_on_device(args, lambda x: shifted_delta(
        x, window=args.d, block_shift=args.p, num_blocks=args.k))


def cmd_feat_to_dim(args):
    """(ref: featbin/feat-to-dim.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    for _k, f in open_rspecifier(args.rspecifier):
        print(f.shape[1])
        return
    raise SystemExit("feat-to-dim: empty archive")


def cmd_feat_to_len(args):
    """(ref: featbin/feat-to-len.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    for k, f in open_rspecifier(args.rspecifier):
        print(f"{k} {f.shape[0]}")


def cmd_shift_feats(args):
    """Shift features in time, replicating edges
    (ref: featbin/shift-feats.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    s = args.shift
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, f in open_rspecifier(args.rspecifier):
            g = np.roll(f, s, axis=0)
            if s > 0:
                g[:s] = f[0]
            elif s < 0:
                g[s:] = f[-1]
            out.write(k, g.astype(np.float32))
            n += 1
    print(f"shift-feats: {n} utts shifted by {s}", file=sys.stderr)


def cmd_wav_to_duration(args):
    """(ref: featbin/wav-to-duration.cc)"""
    from kaldi_tpu_torch.io.wave import read_wave
    for utt, path in _read_wav_scp(args.wav_scp):
        wave, sr = read_wave(path)
        print(f"{utt} {wave.shape[1] / sr:.3f}")


def cmd_wav_copy(args):
    """(ref: featbin/wav-copy.cc)"""
    from kaldi_tpu_torch.io.wave import read_wave, write_wave
    wave, sr = read_wave(args.wav_in)
    write_wave(args.wav_out, wave, sr)
    print(f"wav-copy: {wave.shape[1]} samples @ {sr:.0f} Hz",
          file=sys.stderr)


def cmd_modify_cmvn_stats(args):
    """Fake the variance stats to disable variance normalization
    downstream (ref: featbin/modify-cmvn-stats.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, st in open_rspecifier(args.rspecifier):
            st = np.array(st, np.float64)
            cnt = st[0, -1]
            mean = st[0, :-1] / max(cnt, 1.0)
            # x2 stats become (var=1): E[x^2] = 1 + mean^2
            st[1, :-1] = (1.0 + mean ** 2) * cnt
            out.write(k, st.astype(np.float32))
            n += 1
    print(f"modify-cmvn-stats: {n} entries", file=sys.stderr)


def cmd_train_nnet3(args):
    """nnet3 training from GMM alignments: config-built TDNN or LSTM
    (ref: steps/nnet3/train_{tdnn,lstm}.sh + nnet3bin/nnet3-train), on the
    device."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_am_nnet3
    from kaldi_tpu_torch.nnet3.training import Nnet3TrainOpts
    from kaldi_tpu_torch.steps.nnet3_train import train_lstm3, train_tdnn3
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    utts = _load_train_utts(args.text, args.rspecifier)
    opts = Nnet3TrainOpts(
        initial_lr=args.initial_lr, final_lr=args.final_lr,
        num_epochs=args.num_epochs, minibatch_size=args.minibatch_size,
        momentum=args.momentum)
    if args.net_type == "lstm":
        res = train_lstm3(model, utts, cell_dim=args.cell_dim,
                          proj_dim=args.proj_dim, train_opts=opts)
    else:
        res = train_tdnn3(model, utts, hidden_dim=args.hidden_dim,
                          train_opts=opts)
    save_am_nnet3(args.nnet_out, res.am)
    hist = res.history[-1] if res.history else (0, 0, 0.0, 0.0)
    print(f"train-nnet3 ({args.net_type}): final loss {hist[2]:.3f} "
          f"acc {hist[3]:.3f}", file=sys.stderr)


def cmd_online2_wav_nnet2_latgen_faster(args):
    """Streaming hybrid decoding of a wav.scp through the online nnet2
    pipeline, one utterance at a time in chunked audio
    (ref: online2bin/online2-wav-nnet2-latgen-faster.cc); features, AM
    and search on the device."""
    from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder
    from kaldi_tpu_torch.io.model_io import (load_am_nnet, load_gmm_system,
                                             load_hclg)
    from kaldi_tpu_torch.io.wave import read_wave
    from kaldi_tpu_torch.online.features import (OnlineFeaturePipeline,
                                                 OnlineProcessedFeature)
    from kaldi_tpu_torch.online.nnet2_decoding import (
        OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
    from kaldi_tpu_torch.ops import FrameOpts, MfccOpts

    dev = _device(args)
    gmm = load_gmm_system(args.model, device=dev)
    am = load_am_nnet(args.nnet, device=dev)
    packed = load_hclg(args.graph)
    base_dec = BeamSearchDecoder(packed, _beam_opts(args), device=dev)
    fo = MfccOpts(frame_opts=FrameOpts(samp_freq=args.sample_frequency,
                                       dither=0.0),
                  num_ceps=args.num_ceps)
    try:
        sil = {gmm.lang.phones[args.sil_phone]}
    except Exception:
        sil = set()
    out = open(args.transcription_out, "w") if args.transcription_out \
        else sys.stdout
    chunk = int(args.chunk_secs * args.sample_frequency)
    fused = None
    if args.fused:
        if args.delta_order != 0:
            raise SystemExit("--fused requires --delta-order=0 (the "
                             "fused program scores raw base features)")
        from kaldi_tpu_torch.online.fused import FusedOnlineDecoder
        from kaldi_tpu_torch.ops.features import mfcc
        shift = fo.frame_opts.window_shift
        fused = FusedOnlineDecoder(
            am, base_dec, fo, computer=mfcc,
            chunk_samples=max(shift, chunk // shift * shift))
    n = 0
    for utt, path in _read_wav_scp(args.wav_scp):
        wave, sr = read_wave(path)
        w = wave[0]
        if fused is not None:
            fused.reset()
            for lo in range(0, len(w), chunk):
                fused.accept_waveform(w[lo: lo + chunk])
            fused.input_finished()
            res = fused.best_path()
        else:
            base = OnlineProcessedFeature(OnlineFeaturePipeline(
                fo, delta_order=args.delta_order, device=dev))
            pipe = OnlineNnet2FeaturePipeline(base)
            sud = SingleUtteranceNnet2Decoder(
                am, gmm.trans_model, base_dec, pipe,
                chunk_frames=args.chunk_frames, silence_phones=sil)
            for lo in range(0, len(w), chunk):
                pipe.accept_waveform(w[lo: lo + chunk])
                sud.advance_decoding()
            sud.finalize_decoding()
            res = sud.best_path()
        words = "" if res is None else " ".join(
            gmm.lang.words.sym(x) for x in res[0])
        out.write(f"{utt} {words}\n")
        n += 1
    if args.transcription_out:
        out.close()
    print(f"online2-wav-nnet2-latgen-faster: decoded {n} utts",
          file=sys.stderr)


# ------------------------------------------------------------ recipes

def _yesno_synth(rng, sr: float):
    tones = {"YES": 440.0, "NO": 1320.0}

    def synth(words):
        chunks = [np.zeros(int(sr * rng.uniform(0.08, 0.15)))]
        for w in words:
            t = np.arange(int(sr * rng.uniform(0.25, 0.4))) / sr
            env = np.minimum(1.0, np.minimum(
                np.arange(len(t)), len(t) - np.arange(len(t))) / (0.02 * sr))
            freq = tones[w] * rng.uniform(0.98, 1.02)
            chunks.append(np.sin(2 * np.pi * freq * t) * 3000
                          * rng.uniform(0.7, 1.0) * env)
            chunks.append(np.zeros(int(sr * rng.uniform(0.1, 0.2))))
        w = np.concatenate(chunks) + rng.randn(
            sum(len(c) for c in chunks)) * 20
        return w.astype(np.float32)
    return synth


def cmd_recipe_yesno_files(args):
    """The yesno recipe driven ENTIRELY through the port's CLI subcommands
    on a data directory of wav files — the egs/yesno/s5/run.sh shape:
    synthesize corpus -> compute-mfcc-feats -> add-deltas -> train-mono ->
    mkgraph -> decode-faster (offline GMM) -> gmm-align -> train-tdnn ->
    online2-wav-nnet2-latgen-faster (streaming TDNN) -> compute-wer.
    `--device` goes to every subcommand that builds a device object; each
    stage's seconds go to stderr. Exits 1 unless both WERs are 0."""
    from kaldi_tpu_torch.io.wave import write_wave

    _device(args)
    work = args.workdir
    os.makedirs(work, exist_ok=True)
    rng = np.random.RandomState(42)
    sr = 8000.0
    synth = _yesno_synth(rng, sr)
    dev = ["--device", args.device]
    stages = {}

    def run(stage, argv):
        t = time.perf_counter()
        main(argv)
        stages[stage] = stages.get(stage, 0.0) + time.perf_counter() - t

    # --- data prep: wavs on disk + wav.scp/text + lexicon + LM
    t = time.perf_counter()
    sets = {"train": 24, "test": 8}
    for name, n in sets.items():
        ddir = os.path.join(work, name)
        os.makedirs(ddir, exist_ok=True)
        with open(os.path.join(ddir, "wav.scp"), "w") as scp, \
                open(os.path.join(ddir, "text"), "w") as txt:
            for i in range(n):
                ws = [rng.choice(["YES", "NO"])
                      for _ in range(rng.randint(2, 6))]
                utt = f"{name}_{i}"
                path = os.path.join(ddir, f"{utt}.wav")
                write_wave(path, synth(ws)[None, :], sr)
                scp.write(f"{utt} {path}\n")
                txt.write(f"{utt} {' '.join(ws)}\n")
    with open(os.path.join(work, "lexicon.txt"), "w") as f:
        f.write("YES Y1 Y2\nNO N1 N2\n")
    with open(os.path.join(work, "lm.arpa"), "w") as f:
        f.write("\\data\\\nngram 1=4\n\n\\1-grams:\n-1\tNO\n-1\tYES\n"
                "-99\t<s>\n-1\t</s>\n\n\\end\\\n")
    stages["data"] = time.perf_counter() - t

    def P(*parts):
        return os.path.join(work, *parts)

    # --- features via the CLI
    for name in sets:
        run("compute-mfcc-feats", [
            "compute-mfcc-feats", P(name, "wav.scp"),
            f"ark:{P(name, 'mfcc.ark')}",
            "--sample-frequency", str(sr), "--dither", "0"] + dev)
        run("add-deltas", ["add-deltas", f"ark:{P(name, 'mfcc.ark')}",
                           f"ark:{P(name, 'feats.ark')}"] + dev)

    # --- GMM train + graph + offline decode
    run("train-mono", [
        "train-mono", P("lexicon.txt"), P("train", "text"),
        f"ark:{P('train', 'feats.ark')}", P("mono.npz"),
        "--num-iters", "12", "--totgauss", "60", "--max-iter-inc", "8"]
        + dev)
    run("mkgraph", ["mkgraph", P("mono.npz"), P("lm.arpa"), P("hclg.npz")])
    run("decode-faster", [
        "decode-faster", P("mono.npz"), P("hclg.npz"),
        f"ark:{P('test', 'feats.ark')}",
        "--transcription-out", P("hyp_gmm.txt")] + dev)
    # --- alignments + TDNN + streaming decode
    run("gmm-align", ["gmm-align", P("mono.npz"), P("train", "text"),
                      f"ark:{P('train', 'feats.ark')}",
                      f"ark:{P('ali.ark')}"] + dev)
    run("train-tdnn", [
        "train-tdnn", P("mono.npz"), P("train", "text"),
        f"ark:{P('train', 'feats.ark')}", P("tdnn.npz"),
        "--num-epochs", "30", "--initial-lr", "0.1",
        "--final-lr", "0.01", "--momentum", "0.9"] + dev)
    run("online2-wav-nnet2-latgen-faster", [
        "online2-wav-nnet2-latgen-faster", P("mono.npz"), P("tdnn.npz"),
        P("hclg.npz"), P("test", "wav.scp"),
        "--sample-frequency", str(sr),
        "--transcription-out", P("hyp_tdnn.txt")] + dev)
    print("recipe-yesno-files: seconds by stage " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()), file=sys.stderr)
    # --- score both
    failed = False
    for hyp in ("hyp_gmm.txt", "hyp_tdnn.txt"):
        try:
            main(["compute-wer", P("test", "text"), P(hyp),
                  "--max-wer", "0"])
        except SystemExit as e:
            failed = failed or (e.code not in (0, None))
    if failed:
        sys.exit(1)


def cmd_recipe_yesno(args) -> int:
    """The e2e sanity recipe (ref: egs/yesno/s5/run.sh; kaldi_tpu/cli.py
    `cmd_recipe_yesno`): a synthesized tone corpus, MFCC + deltas, flat-start
    monophone training, HCLG build, padded beam-search decode, WER. Exits
    non-zero unless WER == 0."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.fst.graph import make_hclg
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu_torch.ops.delta import add_deltas
    from kaldi_tpu_torch.ops.features import MfccOpts, mfcc
    from kaldi_tpu_torch.ops.window import FrameOpts
    from kaldi_tpu_torch.steps.mono import MonoTrainOpts, train_mono
    from kaldi_tpu_torch.utils.wer import compute_wer

    dev = resolve_device(args.device)
    rng = np.random.RandomState(42)
    sr = 8000.0
    synth = _yesno_synth(rng, sr)
    lex = Lexicon.parse("YES Y1 Y2\nNO N1 N2")
    lang = prepare_lang(lex, ["SIL"], "SIL", num_sil_states=3)
    fo = MfccOpts(frame_opts=FrameOpts(samp_freq=sr, dither=0.0))

    def featize(w):
        x = torch.as_tensor(w, device=dev)
        return add_deltas(mfcc(x, fo), order=2, window=2).cpu().numpy()

    utts, tests = [], []
    for i in range(24):
        ws = [rng.choice(["YES", "NO"]) for _ in range(rng.randint(2, 6))]
        utts.append((f"tr{i}", featize(synth(ws)), ws))
    for i in range(8):
        ws = [rng.choice(["YES", "NO"]) for _ in range(rng.randint(2, 6))]
        tests.append((f"te{i}", featize(synth(ws)), ws))

    model = train_mono(lang, utts, MonoTrainOpts(
        num_iters=12, totgauss=60, max_iter_inc=8,
        realign_iters=tuple(range(1, 12))), device=dev)
    arpa = ("\\data\\\nngram 1=4\n\n\\1-grams:\n-1\tNO\n-1\tYES\n"
            "-99\t<s>\n-1\t</s>\n\n\\end\\\n")
    g = arpa_to_g(ArpaLm.parse(arpa), lang.words)
    graph = make_hclg(lang, g, model.trans_model, model.ctx_dep,
                      self_loop_scale=0.1)
    dec = BeamSearchDecoder(pack_graph(graph.fst,
                                       model.trans_model.id2pdf_array),
                            BeamSearchOpts(beam=16.0, max_active=256,
                                           acoustic_scale=0.1), device=dev)
    feats, nf = _pad_batch([(u, f) for (u, f, _w) in tests])
    results = dec.decode(model.am.loglikes(feats), nf)
    refs, hyps = {}, {}
    for b, (u, _f, ws) in enumerate(tests):
        refs[u] = ws
        hyps[u] = ([lang.words.sym(w) for w in results[b][0]]
                   if results[b] else [])
    stats = compute_wer(refs, hyps)
    print(stats)
    return 1 if stats.wer > 0 else 0


# Reference binary names that resolve to a canonical subcommand: the
# ported ones of kaldi_tpu/cli.py's `_ALIASES`. Options after the alias
# pass straight through to the canonical command.
_ALIASES: dict = {
    "compute-kaldi-pitch-feats": ["compute-pitch-feats"],
    "gmm-align-compiled": ["gmm-align"],
    "gmm-decode-faster": ["decode-faster"],
    "gmm-decode-simple": ["gmm-decode-faster"],
    "sum-matrices": ["matrix-sum"],
}

# the subcommands of this module that build a device object (`--device`)
DEVICE_COMMANDS = (
    "compute-mfcc-feats", "compute-fbank-feats", "compute-spectrogram-feats",
    "compute-plp-feats", "compute-pitch-feats",
    "compute-and-process-kaldi-pitch-feats", "add-deltas", "add-deltas-sdc",
    "splice-feats", "apply-cmvn", "apply-cmvn-sliding", "transform-feats",
    "wav-reverberate", "train-mono", "train-tdnn", "train-nnet3",
    "gmm-align", "decode-faster", "decode-faster-mapped",
    "online2-wav-nnet2-latgen-faster", "recipe-yesno-files",
    "recipe-yesno")


def _register(sub):
    """This module's subcommands, with JAX's argument names and defaults
    (kaldi_tpu/cli.py main)."""
    for kind in ("mfcc", "fbank", "spectrogram", "plp", "pitch"):
        q = sub.add_parser(f"compute-{kind}-feats")
        q.add_argument("wav_scp")
        q.add_argument("wspecifier")
        q.add_argument("--sample-frequency", type=float, default=16000.0)
        q.add_argument("--frame-length", type=float, default=25.0)
        q.add_argument("--frame-shift", type=float, default=10.0)
        q.add_argument("--dither", type=float, default=1.0)
        q.add_argument("--num-ceps", type=int, default=13)
        q.add_argument("--num-mel-bins", type=int, default=23)
        q.add_argument("--channel", type=int, default=0)
        q.add_argument("--compress", action="store_true")
        q.set_defaults(func=_feature_cmd(kind))

    q = sub.add_parser("copy-feats")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--compress", action="store_true")
    q.set_defaults(func=cmd_copy_feats)

    q = sub.add_parser("add-deltas")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--delta-order", type=int, default=2)
    q.add_argument("--delta-window", type=int, default=2)
    q.set_defaults(func=cmd_add_deltas)

    q = sub.add_parser("splice-feats")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--left-context", type=int, default=4)
    q.add_argument("--right-context", type=int, default=4)
    q.set_defaults(func=cmd_splice_feats)

    q = sub.add_parser("compute-cmvn-stats")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--spk2utt", default="")
    q.set_defaults(func=cmd_compute_cmvn_stats)

    q = sub.add_parser("apply-cmvn")
    q.add_argument("cmvn_rspecifier")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--utt2spk", default="")
    q.add_argument("--norm-vars", action="store_true")
    q.set_defaults(func=cmd_apply_cmvn)

    q = sub.add_parser("transform-feats")
    q.add_argument("transform")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--compress", action="store_true")
    q.add_argument("--utt2spk", default="",
                   help="utt->spk map; transforms looked up per speaker")
    q.set_defaults(func=cmd_transform_feats)

    q = sub.add_parser("paste-feats")
    q.add_argument("rspecifiers", nargs="+")
    q.add_argument("wspecifier")
    q.add_argument("--length-tolerance", type=int, default=0)
    q.add_argument("--compress", action="store_true")
    q.set_defaults(func=cmd_paste_feats)

    q = sub.add_parser("subset-feats")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--n", type=int, default=10)
    q.add_argument("--last", action="store_true")
    q.add_argument("--compress", action="store_true")
    q.set_defaults(func=cmd_subset_feats)

    q = sub.add_parser("apply-cmvn-sliding")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--cmn-window", type=int, default=600)
    q.add_argument("--min-window", type=int, default=100)
    q.add_argument("--norm-vars", action="store_true")
    q.add_argument("--center", action="store_true")
    q.add_argument("--compress", action="store_true")
    q.set_defaults(func=cmd_apply_cmvn_sliding)

    q = sub.add_parser("copy-matrix")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--scale", type=float, default=1.0)
    q.add_argument("--compress", action="store_true")
    q.set_defaults(func=cmd_copy_matrix)

    q = sub.add_parser("mkgraph")
    q.add_argument("model")
    q.add_argument("arpa")
    q.add_argument("graph_out")
    q.add_argument("--self-loop-scale", type=float, default=0.1)
    q.add_argument("--flat", action="store_true",
                   help="native columnar pipeline (vocabulary scale)")
    q.add_argument("--verbose", action="store_true")
    q.set_defaults(func=cmd_mkgraph)

    q = sub.add_parser("decode-faster")
    q.add_argument("model")
    q.add_argument("graph")
    q.add_argument("rspecifier")
    q.add_argument("--transcription-out", default="")
    q.add_argument("--beam", type=float, default=16.0)
    q.add_argument("--max-active", type=int, default=512)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_decode_faster)

    q = sub.add_parser("wav-reverberate")
    q.add_argument("input_wav")
    q.add_argument("rir_wav")
    q.add_argument("output_wav")
    q.set_defaults(func=cmd_wav_reverberate)

    q = sub.add_parser("compute-vad")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--vad-energy-threshold", type=float, default=5.5)
    q.add_argument("--vad-energy-mean-scale", type=float, default=0.5)
    q.set_defaults(func=cmd_compute_vad)

    q = sub.add_parser("select-voiced-frames")
    q.add_argument("rspecifier")
    q.add_argument("vad_rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_select_voiced_frames)

    q = sub.add_parser("subsample-feats")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--n", type=int, default=10)
    q.add_argument("--offset", type=int, default=0)
    q.set_defaults(func=cmd_subsample_feats)

    q = sub.add_parser("select-feats")
    q.add_argument("columns")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_select_feats)

    q = sub.add_parser("extract-segments")
    q.add_argument("wav_scp")
    q.add_argument("segments")
    q.add_argument("out_dir")
    q.set_defaults(func=cmd_extract_segments)

    q = sub.add_parser("compute-wer")
    q.add_argument("ref")
    q.add_argument("hyp")
    q.add_argument("--max-wer", type=float, default=None,
                   help="exit 1 if WER exceeds this")
    q.set_defaults(func=cmd_compute_wer)

    q = sub.add_parser("info")
    q.set_defaults(func=cmd_info)

    q = sub.add_parser("train-mono")
    q.add_argument("lexicon")
    q.add_argument("text")
    q.add_argument("rspecifier")
    q.add_argument("model_out")
    q.add_argument("--sil-phone", default="SIL")
    q.add_argument("--num-sil-states", type=int, default=3)
    q.add_argument("--num-iters", type=int, default=12)
    q.add_argument("--totgauss", type=int, default=60)
    q.add_argument("--max-iter-inc", type=int, default=8)
    q.set_defaults(func=cmd_train_mono)

    q = sub.add_parser("gmm-align")
    q.add_argument("model")
    q.add_argument("text")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.add_argument("--transition-scale", type=float, default=1.0)
    q.add_argument("--self-loop-scale", type=float, default=0.1,
                   help="steps/train_*.sh pass 0.1 to "
                        "compile-train-graphs")
    q.set_defaults(func=cmd_gmm_align)

    q = sub.add_parser("matrix-dim")
    q.add_argument("rspecifier")
    q.set_defaults(func=cmd_matrix_dim)

    q = sub.add_parser("matrix-sum-rows")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_matrix_sum_rows)

    q = sub.add_parser("vector-scale")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--scale", type=float, default=1.0)
    q.set_defaults(func=cmd_vector_scale)

    q = sub.add_parser("transform-vec")
    q.add_argument("transform")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_transform_vec)

    q = sub.add_parser("decode-faster-mapped")
    q.add_argument("graph")
    q.add_argument("loglikes_rspecifier")
    q.add_argument("--transcription-out", default="")
    q.add_argument("--beam", type=float, default=16.0)
    q.add_argument("--max-active", type=int, default=512)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_decode_faster_mapped)

    q = sub.add_parser("compose-transforms")
    q.add_argument("a")
    q.add_argument("b")
    q.add_argument("out")
    q.add_argument("--b-is-affine", action="store_true")
    q.set_defaults(func=cmd_compose_transforms)

    q = sub.add_parser("train-tdnn")
    q.add_argument("model")
    q.add_argument("text")
    q.add_argument("rspecifier")
    q.add_argument("nnet_out")
    q.add_argument("--initial-lr", type=float, default=0.1)
    q.add_argument("--final-lr", type=float, default=0.01)
    q.add_argument("--num-epochs", type=int, default=30)
    q.add_argument("--minibatch-size", type=int, default=64)
    q.add_argument("--momentum", type=float, default=0.9)
    q.set_defaults(func=cmd_train_tdnn)

    q = sub.add_parser("online2-wav-nnet2-latgen-faster")
    q.add_argument("model")           # GMM system npz (trans_model+lang)
    q.add_argument("nnet")            # AmNnet npz
    q.add_argument("graph")           # HCLG npz
    q.add_argument("wav_scp")
    q.add_argument("--transcription-out", default="")
    q.add_argument("--sample-frequency", type=float, default=16000.0)
    q.add_argument("--num-ceps", type=int, default=13)
    q.add_argument("--delta-order", type=int, default=2)
    q.add_argument("--beam", type=float, default=16.0)
    q.add_argument("--max-active", type=int, default=256)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.add_argument("--sil-phone", default="SIL")
    q.add_argument("--chunk-secs", type=float, default=0.4)
    q.add_argument("--chunk-frames", type=int, default=16)
    q.add_argument("--fused", action="store_true",
                   help="single-dispatch fused streaming decoder (requires "
                        "--delta-order=0: the fused program scores raw "
                        "base features)")
    q.set_defaults(func=cmd_online2_wav_nnet2_latgen_faster)

    q = sub.add_parser("recipe-yesno-files")
    q.add_argument("workdir")
    q.set_defaults(func=cmd_recipe_yesno_files)

    q = sub.add_parser("feat-to-dim")
    q.add_argument("rspecifier")
    q.set_defaults(func=cmd_feat_to_dim)

    q = sub.add_parser("feat-to-len")
    q.add_argument("rspecifier")
    q.set_defaults(func=cmd_feat_to_len)

    q = sub.add_parser("shift-feats")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--shift", type=int, default=0)
    q.set_defaults(func=cmd_shift_feats)

    q = sub.add_parser("wav-to-duration")
    q.add_argument("wav_scp")
    q.set_defaults(func=cmd_wav_to_duration)

    q = sub.add_parser("wav-copy")
    q.add_argument("wav_in")
    q.add_argument("wav_out")
    q.set_defaults(func=cmd_wav_copy)

    q = sub.add_parser("modify-cmvn-stats")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_modify_cmvn_stats)

    q = sub.add_parser("append-feats")
    q.add_argument("rspecifier_a")
    q.add_argument("rspecifier_b")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_append_feats)

    q = sub.add_parser("append-vector-to-feats")
    q.add_argument("rspecifier")
    q.add_argument("vec_rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_append_vector_to_feats)

    q = sub.add_parser("compare-feats")
    q.add_argument("rspecifier_a")
    q.add_argument("rspecifier_b")
    q.add_argument("--threshold", type=float, default=0.99)
    q.set_defaults(func=cmd_compare_feats)

    q = sub.add_parser("reverse-feats")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_reverse_feats)

    q = sub.add_parser("remove-mean")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_remove_mean)

    q = sub.add_parser("extract-feature-segments")
    q.add_argument("rspecifier")
    q.add_argument("segments")
    q.add_argument("wspecifier")
    q.add_argument("--frame-shift", type=float, default=0.01)
    q.set_defaults(func=cmd_extract_feature_segments)

    q = sub.add_parser("copy-feats-to-htk")
    q.add_argument("rspecifier")
    q.add_argument("out_dir")
    q.add_argument("--ext", default=".fea")
    q.add_argument("--sample-period", type=int, default=100000)
    q.set_defaults(func=cmd_copy_feats_to_htk)

    for name in ("process-pitch-feats", "process-kaldi-pitch-feats"):
        q = sub.add_parser(name)
        q.add_argument("rspecifier")
        q.add_argument("wspecifier")
        q.set_defaults(func=cmd_process_pitch_feats)

    q = sub.add_parser("detect-sinusoids")
    q.add_argument("wav_scp")
    q.add_argument("--max-out", type=int, default=2)
    q.set_defaults(func=cmd_detect_sinusoids)

    q = sub.add_parser("add-deltas-sdc")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--d", type=int, default=1)
    q.add_argument("--p", type=int, default=3)
    q.add_argument("--k", type=int, default=7)
    q.set_defaults(func=cmd_add_deltas_sdc)

    q = sub.add_parser("extend-wav-with-silence")
    q.add_argument("wav_scp")
    q.add_argument("out_dir")
    q.add_argument("--extend-secs", type=float, default=0.5)
    q.set_defaults(func=cmd_extend_wav_with_silence)

    q = sub.add_parser("interpolate-pitch")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--pov-threshold", type=float, default=0.2)
    q.set_defaults(func=cmd_interpolate_pitch)

    q = sub.add_parser("extract-rows")
    q.add_argument("ranges")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_extract_rows)

    q = sub.add_parser("extend-transform-dim")
    q.add_argument("transform")
    q.add_argument("transform_out")
    q.add_argument("--new-dimension", type=int, required=True)
    q.set_defaults(func=cmd_extend_transform_dim)

    q = sub.add_parser("copy-feats-to-sphinx")
    q.add_argument("rspecifier")
    q.add_argument("out_dir")
    q.set_defaults(func=cmd_copy_feats_to_sphinx)

    q = sub.add_parser("compute-and-process-kaldi-pitch-feats")
    q.add_argument("wav_scp")
    q.add_argument("wspecifier")
    q.add_argument("--sample-frequency", type=float, default=16000.0)
    q.add_argument("--frame-length", type=float, default=25.0)
    q.add_argument("--frame-shift", type=float, default=10.0)
    q.set_defaults(func=cmd_compute_and_process_pitch)

    q = sub.add_parser("apply-cmvn-online")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--cmn-window", type=int, default=600)
    q.add_argument("--norm-vars", action="store_true")
    q.set_defaults(func=cmd_apply_cmvn_online)

    q = sub.add_parser("split-scp")
    q.add_argument("scp")
    q.add_argument("num_jobs", type=int)
    q.add_argument("out_pattern", help="path containing JOB, e.g. f.JOB.scp")
    q.set_defaults(func=cmd_split_scp)

    q = sub.add_parser("utt2spk-to-spk2utt")
    q.add_argument("utt2spk")
    q.set_defaults(func=cmd_utt2spk_to_spk2utt)

    q = sub.add_parser("est-pca")
    q.add_argument("rspecifier")
    q.add_argument("matrix_out")
    q.add_argument("--dim", type=int, default=40)
    q.add_argument("--normalize-variance", action="store_true")
    q.add_argument("--no-normalize-mean", action="store_true")
    q.set_defaults(func=cmd_est_pca)

    q = sub.add_parser("copy-vector")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_copy_vector)

    q = sub.add_parser("copy-int-vector")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_copy_int_vector)

    for name in ("matrix-sum", "vector-sum"):
        q = sub.add_parser(name)
        q.add_argument("wspecifier")
        q.add_argument("rspecifiers", nargs="+")
        q.add_argument("--average", action="store_true")
        q.set_defaults(func=_sum_cmd(name))

    q = sub.add_parser("train-nnet3")
    q.add_argument("model")
    q.add_argument("text")
    q.add_argument("rspecifier")
    q.add_argument("nnet_out")
    q.add_argument("--net-type", default="tdnn", choices=["tdnn", "lstm"])
    q.add_argument("--hidden-dim", type=int, default=256)
    q.add_argument("--cell-dim", type=int, default=64)
    q.add_argument("--proj-dim", type=int, default=32)
    q.add_argument("--initial-lr", type=float, default=0.1)
    q.add_argument("--final-lr", type=float, default=0.01)
    q.add_argument("--num-epochs", type=int, default=30)
    q.add_argument("--minibatch-size", type=int, default=64)
    q.add_argument("--momentum", type=float, default=0.9)
    q.set_defaults(func=cmd_train_nnet3)

    q = sub.add_parser("recipe-yesno", help="synthetic yesno: features -> "
                       "mono training -> HCLG -> decode -> WER (exits 1 "
                       "unless WER == 0)")
    q.add_argument("--workdir", default="/tmp/kaldi_tpu_yesno",
                   help="JAX's option, unused there too: this recipe "
                        "writes no files")
    q.set_defaults(func=cmd_recipe_yesno)

    for name in DEVICE_COMMANDS:
        sub.choices[name].add_argument("--device", default="cuda",
                                       help="torch device (default: cuda)")


def main(argv=None) -> int:
    argv = _expand_config_args(argv if argv is not None else sys.argv[1:])
    for _hop in range(4):   # aliases may chain (e.g. *-simple -> *-faster)
        if not (argv and argv[0] in _ALIASES):
            break
        argv = _ALIASES[argv[0]] + argv[1:]
    p = argparse.ArgumentParser(prog="kaldi_tpu_torch.cli",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    _register(sub)
    cli_nnet.register(sub)
    cli_misc.register(sub)
    cli_online_extra.register(sub)
    args = p.parse_args(argv)
    rc = args.func(args)
    if rc:
        sys.exit(rc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
