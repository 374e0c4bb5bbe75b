"""Command-line entry points of the port (counterpart of kaldi_tpu/cli.py).

    python -m kaldi_tpu_torch.cli compute-fbank-feats wav.scp ark,scp:f.ark,f.scp
    python -m kaldi_tpu_torch.cli recipe-yesno-files work [--device cpu]
    python -m kaldi_tpu_torch.cli online-audio-server-decode-faster \
        final.mdl HCLG.npz --port-file port --num-connections 2
    python -m kaldi_tpu_torch.cli online-audio-client 127.0.0.1 PORT wav.scp

Ported so far: `recipe-yesno`, the online / onlinebin subcommands of
kaldi_tpu/cli_online_extra.py (`cli_online_extra.py`); the first CLI
slice: feature extraction, CMVN, feature tables, matrices, vectors and
transforms, waves and data-dir utilities, the card probes, monophone /
TDNN / nnet3 training, alignment, graph building and decoding, and the
file-driven yesno recipe; the second: the FST and graph primitives
that utils/mkgraph.sh drives, HMM and alignment tools, trees, and the
GMM and global-GMM primitives of steps/train_mono.sh and
train_deltas.sh; and the third: lattice generation and rescoring
(steps/decode.sh, decode_fmllr.sh, lmrescore_const_arpa.sh), the lattice
tools and n-best lists of local/score.sh and the confidence tools,
posteriors, keyword search and pronunciations; the fourth: nnet2, nnet3
and nnet1; and the fifth (5a): speaker recognition (egs/sre10's UBMs,
i-vector extractor, PLDA and scoring), logistic regression, LDA / MLLT
statistics and the online GMM decoder (`cli_misc.py`, `cli_nnet.py`,
`cli_fst.py`, `cli_gmm_extra.py`, `cli_tail.py` and `cli_adapt.py` hold
the commands that JAX keeps there). Commands
read and write the JAX package's files: arks through `io/kaldi_io.py`,
models through `io/model_io.py`. Every command that builds a device
object takes `--device` (default: cuda) and raises without a card; host
commands (copies, selections, statistics, numpy arithmetic, FSTs, trees,
the GMM updates and the global GMMs, which JAX scores on the host, and
lattices, posteriors and KWS indexes) write JAX's bytes.
`--config=FILE` expands as util/parse-options.h:44 does.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from kaldi_tpu_torch import (cli_adapt, cli_fst, cli_gmm_extra, cli_misc,
                             cli_nnet, cli_online_extra, cli_sgmm, cli_tail)


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
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    utts = _load_train_utts(args.text, args.rspecifier)
    batch = _training_graphs(model, [w for (_u, _f, w) in utts],
                             args.transition_scale, args.self_loop_scale)
    feats, nf = _pad_batch([(u, f) for (u, f, _w) in utts])
    results = viterbi_align(batch, model.am.loglikes_np(feats), nf,
                            args.acoustic_scale, device=dev)
    n_ok = _write_alignments("gmm-align", args.wspecifier,
                             [u for (u, _f, _w) in utts], results)
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


# ------------------------------------------------ FSTs and graphs (host)

def _fst_unary(transform):
    """An Fst -> Fst transform as a text-in, text-out subcommand."""
    def run(args):
        from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
        fst = load_fst(args.fst_in,
                       getattr(args, "isymbols", "") or "",
                       getattr(args, "osymbols", "") or "")
        out = transform(fst, args)
        save_fst(args.fst_out, out)
        print(f"{out.num_states} states, {out.num_arcs} arcs",
              file=sys.stderr)
    return run


def _fst_determinize(fst, a):
    from kaldi_tpu_torch.fst.determinize import determinize_star
    return determinize_star(fst, use_log=a.use_log)


def _fst_rmepsilon(fst, a):
    from kaldi_tpu_torch.fst.epsilon import rm_epsilon
    return rm_epsilon(fst, use_log=a.use_log)


def _fst_minimize(fst, a):
    from kaldi_tpu_torch.fst.minimize import minimize_encoded
    return minimize_encoded(fst)


def _fst_push(fst, a):
    from kaldi_tpu_torch.fst.special import push_special
    return push_special(fst)


def _fst_rmepslocal(fst, a):
    from kaldi_tpu_torch.fst.epsilon import remove_eps_local
    remove_eps_local(fst)
    return fst


def _read_int_list(path: str) -> list:
    with open(path) as f:
        return [int(t) for t in f.read().split()]


def cmd_fst_compose(args):
    """(ref: fstcompose / fsttablecompose)"""
    from kaldi_tpu_torch.fst.compose import compose, table_compose
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    a = load_fst(args.a)
    b = load_fst(args.b)
    a.arcsort(by="olabel")
    b.arcsort(by="ilabel")
    out = table_compose(a, b) if args.table else compose(a, b)
    save_fst(args.fst_out, out)
    print(f"{out.num_states} states, {out.num_arcs} arcs", file=sys.stderr)


def cmd_fst_shortest_path(args):
    """(ref: fstshortestpath + fstprint of the best path); exits 1 when
    no path exists."""
    from kaldi_tpu_torch.fst.text_io import load_fst
    res = load_fst(args.fst_in).shortest_path()
    if res is None:
        print("no path", file=sys.stderr)
        sys.exit(1)
    il, ol, cost = res
    print(" ".join(map(str, il)))
    print(" ".join(map(str, ol)))
    print(f"{cost:.6g}")


def cmd_fst_info(args):
    """(ref: fstinfo)"""
    from kaldi_tpu_torch.fst.text_io import load_fst
    fst = load_fst(args.fst_in)
    n_eps = sum(1 for arcs in fst.arcs for (i, _o, _w, _d) in arcs
                if i == 0)
    print(json.dumps({
        "num_states": fst.num_states,
        "num_arcs": fst.num_arcs,
        "num_eps_input_arcs": n_eps,
        "start": fst.start,
        "num_final_states": len(fst.finals),
        "input_deterministic": fst.is_deterministic(),
    }, indent=2))


def cmd_arpa2fst(args):
    """ARPA LM -> G acceptor with #0 backoff inputs, OpenFst text out
    (ref: bin/arpa2fst.cc + egs utils/format_lm.sh)."""
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.fst.text_io import save_fst
    from kaldi_tpu_torch.lm.arpa import ArpaLm, arpa_to_g
    words = SymbolTable.read(args.words)
    with open(args.arpa) as f:
        lm = ArpaLm.parse(f.read())
    g = arpa_to_g(lm, words, backoff_symbol=args.backoff_symbol)
    save_fst(args.fst_out, g)
    print(f"arpa2fst: order {lm.order}, {g.num_states} states, "
          f"{g.num_arcs} arcs", file=sys.stderr)


def cmd_fst_compose_context(args):
    """LG -> CLG + ilabel_info file (ref: fstbin/fstcomposecontext.cc;
    ilabel_info convention fstext/context-fst.h)."""
    from kaldi_tpu_torch.fst.context import compose_context
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    lg = load_fst(args.fst_in)
    disambig = set()
    if args.read_disambig_syms:
        disambig = set(_read_int_list(args.read_disambig_syms))
    clg, ilabel_info = compose_context(
        lg, disambig, N=args.context_size, P=args.central_position)
    with open(args.ilabels_out, "w") as f:
        json.dump([list(map(int, w)) for w in ilabel_info], f)
    save_fst(args.fst_out, clg)
    print(f"fst-compose-context: {clg.num_states} states, "
          f"{clg.num_arcs} arcs, {len(ilabel_info)} ilabels",
          file=sys.stderr)


def cmd_make_h_transducer(args):
    """ilabel_info + model (tree, transitions) -> Ha transducer
    (ref: bin/make-h-transducer.cc)."""
    from kaldi_tpu_torch.fst.hmm_graph import make_h_transducer
    from kaldi_tpu_torch.fst.text_io import save_fst
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    with open(args.ilabels) as f:
        ilabel_info = json.load(f)
    ha, disambig_tids = make_h_transducer(
        ilabel_info, model.ctx_dep, model.trans_model,
        transition_scale=args.transition_scale)
    save_fst(args.fst_out, ha)
    if args.disambig_syms_out:
        with open(args.disambig_syms_out, "w") as f:
            for t in disambig_tids:
                f.write(f"{t}\n")
    print(f"make-h-transducer: {ha.num_states} states, {ha.num_arcs} "
          f"arcs, {len(disambig_tids)} disambig tids", file=sys.stderr)


def cmd_add_self_loops(args):
    """Insert self-loop transition-ids with probability-mass rescaling
    (ref: bin/add-self-loops.cc, hmm/hmm-utils.cc AddSelfLoops)."""
    from kaldi_tpu_torch.fst.hmm_graph import add_self_loops
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    fst = load_fst(args.fst_in)
    disambig = ()
    if args.disambig_syms:
        disambig = tuple(_read_int_list(args.disambig_syms))
    out = add_self_loops(fst, model.trans_model, disambig,
                         self_loop_scale=args.self_loop_scale,
                         reorder=True)
    save_fst(args.fst_out, out)
    print(f"add-self-loops: {out.num_states} states, {out.num_arcs} arcs",
          file=sys.stderr)


def cmd_fst_rmsymbols(args):
    """Replace listed input symbols with epsilon
    (ref: fstbin/fstrmsymbols.cc)."""
    from kaldi_tpu_torch.fst.epsilon import remove_symbols
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    fst = load_fst(args.fst_in)
    syms = _read_int_list(args.syms)
    remove_symbols(fst, syms)
    save_fst(args.fst_out, fst)
    print(f"fst-rmsymbols: removed {len(syms)} symbols", file=sys.stderr)


def cmd_fst_pack_graph(args):
    """Pack an HCLG text FST into the decoders' graph file (CSR arc
    tables + tid->pdf map; ref: the decode path of
    gmmbin/gmm-latgen-faster.cc reading fst::ReadFstKaldi)."""
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    from kaldi_tpu_torch.fst.text_io import load_fst
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_hclg
    model = load_gmm_system(args.model, device="cpu")
    fst = load_fst(args.fst_in)
    fst.connect()
    fst.arcsort("ilabel")
    packed = pack_graph(fst, model.trans_model.id2pdf_array)
    save_hclg(args.graph_out, packed)
    print(f"fst-pack-graph: {packed.num_states} states", file=sys.stderr)


def cmd_fst_copy(args):
    """(ref: fstbin/fstcopy.cc)"""
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    f = load_fst(args.fst_in)
    save_fst(args.fst_out, f)
    print(f"fstcopy: {f.num_states} states", file=sys.stderr)


def cmd_fst_is_stochastic(args):
    """Per-state outgoing weight sums in the log semiring
    (ref: fstbin/fstisstochastic.cc): prints the min and max residual,
    exits 1 when either is outside --delta."""
    import math
    from kaldi_tpu_torch.fst.text_io import load_fst
    f = load_fst(args.fst_in)
    INF = float("inf")

    def log_add(acc, v):
        return v if acc is None else \
            max(acc, v) + math.log1p(math.exp(-abs(acc - v)))
    lo, hi = INF, -INF
    for s in range(f.num_states):
        acc = None
        for (_i, _o, w, _d) in f.arcs[s]:
            acc = log_add(acc, -w)
        fw = f.final(s)
        if fw < INF:
            acc = log_add(acc, -fw)
        if acc is None:
            continue
        lo, hi = min(lo, acc), max(hi, acc)
    print(f"{lo:.6f} {hi:.6f}")
    if not (abs(lo) <= args.delta and abs(hi) <= args.delta):
        sys.exit(1)


def cmd_fst_phi_compose(args):
    """Compose with phi (failure) transitions on the right FST
    (ref: fstbin/fstphicompose.cc)."""
    from kaldi_tpu_torch.fst.special import phi_compose
    from kaldi_tpu_torch.fst.text_io import load_fst, save_fst
    out = phi_compose(load_fst(args.a), load_fst(args.b), args.phi_label)
    save_fst(args.fst_out, out)
    print(f"fst-phi-compose: {out.num_states} states, "
          f"{out.num_arcs} arcs", file=sys.stderr)


def cmd_make_pdf_to_tid_transducer(args):
    """One-state transducer mapping pdf-id+1 -> transition-ids
    (ref: bin/make-pdf-to-tid-transducer.cc)."""
    from kaldi_tpu_torch.fst.fst import Fst
    from kaldi_tpu_torch.fst.text_io import save_fst
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    tm = load_gmm_system(args.model, device="cpu").trans_model
    f = Fst()
    s = f.add_state()
    f.start = s
    f.set_final(s, 0.0)
    for tid in range(1, tm.num_transition_ids + 1):
        f.add_arc(s, tm.transition_id_to_pdf(tid) + 1, tid, 0.0, s)
    save_fst(args.fst_out, f)
    print(f"make-pdf-to-tid-transducer: {f.num_arcs} arcs",
          file=sys.stderr)


def cmd_transcripts_to_fsts(args):
    """Transcripts -> linear acceptor FSTs, text-archive format
    (ref: kwsbin/transcripts-to-fsts.cc)."""
    from kaldi_tpu_torch.fst.fst import Fst
    from kaldi_tpu_torch.fst.text_io import read_symbols, write_fst_text
    sym = read_symbols(args.word_symbols) if args.word_symbols else None
    out = open(args.fsts_out, "w") if args.fsts_out != "-" else sys.stdout
    n = 0
    with open(args.transcripts) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ids = [sym[w] if sym else int(w) for w in parts[1:]]
            out.write(parts[0] + "\n")
            write_fst_text(out, Fst.linear_acceptor(ids))
            out.write("\n")
            n += 1
    if args.fsts_out != "-":
        out.close()
    print(f"transcripts-to-fsts: {n} fsts", file=sys.stderr)


def cmd_fsts_to_transcripts(args):
    """Keyed text FSTs (the compile-train-graphs-fsts format) ->
    shortest-path output-label transcripts
    (ref: fstbin/fsts-to-transcripts.cc)."""
    from kaldi_tpu_torch.cli_fst import _read_fst_ark
    for key, fst in _read_fst_ark(args.fsts_in):
        res = fst.shortest_path()
        words = " ".join(str(w) for w in res[1]) if res else ""
        print(f"{key} {words}")


def cmd_compile_train_graphs(args):
    """Per-utterance training graphs from transcripts
    (ref: bin/compile-train-graphs.cc); prints states and arcs per
    utterance."""
    from kaldi_tpu_torch.fst.graph import TrainingGraphCompiler
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    compiler = TrainingGraphCompiler(model.lang, model.trans_model,
                                     model.ctx_dep)
    with open(args.text) as f:
        for line in f:
            parts = line.split()
            g = compiler.compile_transcript(parts[1:])
            n_arcs = sum(len(a) for a in g.arcs)
            print(f"{parts[0]} states={g.num_states} arcs={n_arcs}")


# ------------------------------------------------- HMMs and alignments

def cmd_hmm_info(args):
    """(ref: bin/hmm-info.cc)"""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    tm = load_gmm_system(args.model, device="cpu").trans_model
    print(f"number of phones {len(tm.topo.phones)}")
    print(f"number of pdfs {tm.num_pdfs}")
    print(f"number of transition-ids {tm.num_transition_ids}")
    print(f"number of transition-states {len(tm.tuples)}")


def cmd_am_info(args):
    """(ref: bin/am-info.cc; gmmbin/gmm-info.cc prints the same)"""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    tm, am = model.trans_model, model.am
    print(f"number of phones {len(model.lang.topo.phones)}")
    print(f"number of pdfs {am.num_pdfs}")
    print(f"number of transition-ids {tm.num_transition_ids}")
    print(f"number of transition-states {len(tm.tuples)}")
    print(f"feature dimension {am.dim}")
    print(f"number of gaussians {am.total_gauss}")


def cmd_show_transitions(args):
    """The transition model: each transition-state's tuple and its
    transition-ids' probabilities (ref: bin/show-transitions.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    tm = model.trans_model
    for ts in range(1, len(tm.tuples) + 1):
        phone, hmm_state, pdf = tm.tuples[ts - 1]
        print(f"Transition-state {ts}: phone = "
              f"{model.lang.phones.sym(phone)} hmm-state = {hmm_state} "
              f"pdf = {pdf}")
        for tid in tm.transition_ids_of_state(ts):
            p = float(np.exp(tm.log_probs[tid]))
            kind = ("self-loop" if tm.is_self_loop(tid)
                    else f"idx {tm.transition_id_to_transition_index(tid)}")
            print(f" Transition-id = {tid} p = {p:.4f} [{kind}]")


def cmd_show_alignments(args):
    """Phone segmentation of alignments, one line per utterance
    (ref: bin/show-alignments.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.align import ali_to_phones
    model = load_gmm_system(args.model, device="cpu")
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        segs = ali_to_phones(model.trans_model, np.asarray(ali, np.int64))
        pretty = " ".join(
            f"{model.lang.phones.sym(ph)}[{int(round(dur / 0.01))}]"
            for (ph, _start, dur) in segs)
        print(f"{utt} {pretty}")


def cmd_gmm_copy(args):
    """(ref: gmmbin/gmm-copy.cc, bin/copy-transition-model.cc)"""
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_gmm_system
    save_gmm_system(args.model_out, load_gmm_system(args.model, device="cpu"))
    print("gmm-copy: done", file=sys.stderr)


def cmd_train_transitions(args):
    """Transition probabilities re-estimated from alignments
    (ref: nnetbin/train-transitions.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    tm = model.trans_model
    counts = np.zeros(tm.num_transition_ids + 1, np.float64)
    for _utt, ali in open_rspecifier(args.ali_rspecifier):
        np.add.at(counts, np.asarray(ali, np.int64), 1.0)
    tm.mle_update(counts)
    save_gmm_system(args.model_out, model)
    print(f"train-transitions: {int(counts.sum())} frames",
          file=sys.stderr)


def cmd_ali_to_pdf(args):
    """(ref: bin/ali-to-pdf.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    tid2pdf = load_gmm_system(args.model, device="cpu") \
        .trans_model.id2pdf_array
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, ali in open_rspecifier(args.ali_rspecifier):
            out.write(utt, tid2pdf[np.asarray(ali, np.int64)]
                      .astype(np.int32))
            n += 1
    print(f"ali-to-pdf: {n} utts", file=sys.stderr)


def cmd_ali_to_phones(args):
    """Alignment tids -> phone sequences, lengths or CTM lines
    (ref: bin/ali-to-phones.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.align import ali_to_phones
    tm = load_gmm_system(args.model, device="cpu").trans_model
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        segs = ali_to_phones(tm, np.asarray(ali, np.int64))
        if args.write_lengths:
            body = " ; ".join(f"{ph} {dur}" for (ph, _s, dur) in segs)
        elif args.ctm_output:
            print("\n".join(
                f"{utt} 1 {s * args.frame_shift:.2f} "
                f"{dur * args.frame_shift:.2f} {ph}"
                for (ph, s, dur) in segs))
            continue
        else:
            body = " ".join(str(ph) for (ph, _s, _d) in segs)
        print(f"{utt} {body}")


def cmd_ali_to_post(args):
    """Alignments -> unit-weight posteriors (ref: bin/ali-to-post.cc)."""
    from kaldi_tpu_torch.hmm.posterior import ali_to_post, write_post_line
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    out = open(args.post_out, "w") if args.post_out != "-" else sys.stdout
    n = 0
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        write_post_line(out, utt, ali_to_post(np.asarray(ali, np.int64)))
        n += 1
    if args.post_out != "-":
        out.close()
    print(f"ali-to-post: {n} utts", file=sys.stderr)


def cmd_convert_ali(args):
    """Alignments of one system mapped onto another's tree
    (ref: bin/convert-ali.cc, hmm/hmm-utils.cc ConvertAlignment)."""
    from kaldi_tpu_torch.hmm.hmm_utils import convert_alignment
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    old = load_gmm_system(args.old_model, device="cpu")
    new = load_gmm_system(args.new_model, device="cpu")
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, ali in open_rspecifier(args.ali_rspecifier):
            out.write(utt, convert_alignment(
                np.asarray(ali, np.int64), old.trans_model,
                new.trans_model, new.ctx_dep))
            n += 1
    print(f"convert-ali: {n} utts", file=sys.stderr)


def cmd_analyze_counts(args):
    """Symbol counts over int-vector archives (alignment pdf or phone
    counts; ref: bin/analyze-counts.cc, bin/pdf-to-counts.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
    counts: dict = {}
    for _utt, v in open_rspecifier(args.rspecifier):
        for x in np.asarray(v).ravel():
            counts[int(x)] = counts.get(int(x), 0) + 1
    n = max(counts) + 1 if counts else 0
    vec = np.zeros(n, np.float32)
    for k, c in counts.items():
        if k >= 0:
            vec[k] = c
    write_ark(args.counts_out, {"counts": vec})
    print(f"analyze-counts: {int(vec.sum())} symbols, {n} bins",
          file=sys.stderr)


def _training_graphs(model, transcripts, transition_scale=1.0,
                     self_loop_scale=1.0):
    """One training graph per transcript (word lists; one compile per
    distinct transcript) packed into a batch."""
    from kaldi_tpu_torch.decoder.graph_pack import pack_graphs
    from kaldi_tpu_torch.fst.graph import TrainingGraphCompiler
    compiler = TrainingGraphCompiler(
        model.lang, model.trans_model, model.ctx_dep,
        transition_scale=transition_scale, self_loop_scale=self_loop_scale)
    cache: dict = {}
    graphs = []
    for words in transcripts:
        key = tuple(words)
        if key not in cache:
            cache[key] = compiler.compile_transcript(list(words))
        graphs.append(cache[key])
    return pack_graphs(graphs, model.trans_model.id2pdf_array)


def _write_alignments(name, wspecifier, keys, results):
    """Each utterance's transition-ids to the ark (a failed one to
    stderr) -> the count written."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    n_ok = 0
    with open_wspecifier(wspecifier) as out:
        for k, res in zip(keys, results):
            if res is None:
                print(f"{name}: failed for {k}", file=sys.stderr)
                continue
            out.write(k, np.asarray(res[0], np.int32))
            n_ok += 1
    return n_ok


def cmd_align_equal(args):
    """Equal (acoustics-free) alignment for EM iteration 0
    (ref: bin/align-equal-compiled.cc); the DP on the device."""
    from kaldi_tpu_torch.decoder.viterbi import equal_align
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = _device(args)
    model = load_gmm_system(args.model, device="cpu")
    utts = _load_train_utts(args.text, args.rspecifier)
    batch = _training_graphs(model, [w for (_u, _f, w) in utts],
                             args.transition_scale, args.self_loop_scale)
    nf = np.array([f.shape[0] for (_u, f, _w) in utts], np.int32)
    n_ok = _write_alignments("align-equal", args.wspecifier,
                             [u for (u, _f, _w) in utts],
                             equal_align(batch, nf, device=dev))
    print(f"align-equal: aligned {n_ok}/{len(utts)}", file=sys.stderr)


def cmd_align_mapped(args):
    """Forced alignment from precomputed loglike matrices
    (ref: bin/align-mapped.cc); Viterbi on the device."""
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = _device(args)
    model = load_gmm_system(args.model, device="cpu")
    text = _read_text_file(args.text)
    items = [(k, m) for (k, m) in
             open_rspecifier(args.loglikes_rspecifier) if k in text]
    if not items:
        raise SystemExit("align-mapped: no utterances joined")
    batch = _training_graphs(model, [text[k] for (k, _m) in items])
    ll, nf = _pad_batch(items, fill=-1e10)
    n = _write_alignments("align-mapped", args.wspecifier,
                          [k for (k, _m) in items],
                          viterbi_align(batch, ll, nf, args.acoustic_scale,
                                        device=dev))
    print(f"align-mapped: {n}/{len(items)}", file=sys.stderr)


def cmd_align_text(args):
    """Per-utterance word alignments (ref: bin/align-text.cc output:
    'utt ref1 hyp1 ; ref2 hyp2 ; ...' with <eps> for ins/del)."""
    from kaldi_tpu_torch.utils.wer import levenshtein_alignment
    refs, hyps = _read_text_file(args.ref), _read_text_file(args.hyp)
    for utt in refs:
        pairs, _errs = levenshtein_alignment(refs[utt], hyps.get(utt, []))
        print(f"{utt} " + " ; ".join(f"{r} {h}" for (r, h) in pairs))


# --------------------------------------------------------------- trees

def _read_question_sets(path: str) -> list:
    """One phone set per line (cluster-phones' output)."""
    qsets = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if toks:
                qsets.append([int(t) for t in toks])
    return qsets


def cmd_acc_tree_stats(args):
    """Per-(context, pdf-class) Gaussian stats from alignments, the
    build-tree input (ref: bin/acc-tree-stats.cc, hmm/tree-accu.h:41)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_tree_stats
    from kaldi_tpu_torch.tree.build_tree import accumulate_tree_stats
    model = load_gmm_system(args.model, device="cpu")
    if args.ci_phones:
        ci = {int(p) for p in args.ci_phones.split(":") if p}
    else:
        ci = {model.lang.phones[p] for p in model.lang.silence_phones}
    feats = dict(open_rspecifier(args.rspecifier))
    stats: dict = {}
    n = 0
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        if utt not in feats:
            print(f"acc-tree-stats: no feats for {utt}", file=sys.stderr)
            continue
        accumulate_tree_stats(
            np.asarray(feats[utt]), np.asarray(ali, np.int64),
            model.trans_model, N=args.context_width,
            P=args.central_position, ci_phones=ci, stats=stats)
        n += 1
    save_tree_stats(args.stats_out, stats, args.context_width,
                    args.central_position)
    print(f"acc-tree-stats: {n} utts, {len(stats)} event stats",
          file=sys.stderr)


def cmd_sum_tree_stats(args):
    """(ref: bin/sum-tree-stats.cc)"""
    from kaldi_tpu_torch.io.model_io import load_tree_stats, save_tree_stats
    total, N, P = None, None, None
    for p in args.stats_in:
        stats, n_, p_ = load_tree_stats(p)
        if total is None:
            total, N, P = stats, n_, p_
            continue
        assert (n_, p_) == (N, P), "mismatched context windows"
        for ev, st in stats.items():
            total[ev] = st if ev not in total else total[ev].add(st)
    save_tree_stats(args.stats_out, total, N, P)
    print(f"sum-tree-stats: {len(args.stats_in)} -> {args.stats_out}",
          file=sys.stderr)


def cmd_cluster_phones(args):
    """Phones clustered into question sets by central-phone stats
    (ref: bin/cluster-phones.cc; one ascending phone-id set per line)."""
    from kaldi_tpu_torch.io.model_io import load_tree_stats
    from kaldi_tpu_torch.tree.build_tree import obtain_questions
    stats, _N, P = load_tree_stats(args.stats)
    qsets = obtain_questions(stats, P)
    with open(args.questions_out, "w") as f:
        for q in qsets:
            f.write(" ".join(str(p) for p in sorted(q)) + "\n")
    print(f"cluster-phones: {len(qsets)} question sets", file=sys.stderr)


def cmd_build_tree(args):
    """Tied-state decision tree from tree stats + questions
    (ref: bin/build-tree.cc, tree/build-tree.h:82)."""
    from kaldi_tpu_torch.io.model_io import (load_gmm_system,
                                             load_tree_stats, save_tree)
    from kaldi_tpu_torch.steps.deltas import DeltasTrainOpts, tree_from_stats
    model = load_gmm_system(args.model, device="cpu")
    stats, N, P = load_tree_stats(args.stats)
    qsets = _read_question_sets(args.questions) if args.questions else None
    opts = DeltasTrainOpts(
        num_leaves=args.max_leaves, tree_thresh=args.thresh,
        cluster_thresh=args.cluster_thresh, sil_roots=args.sil_roots,
        context_width=N, central_position=P)
    ctx, _tm, _leaf_stats = tree_from_stats(model.lang, stats, opts, qsets)
    save_tree(args.tree_out, ctx)
    print(f"build-tree: {ctx.num_pdfs} leaves", file=sys.stderr)


def cmd_build_tree_two_level(args):
    """Two-level tree: fine leaves sharing coarse codebooks
    (ref: bin/build-tree-two-level.cc, tree/build-tree.h:145)."""
    from kaldi_tpu_torch.io.model_io import (load_gmm_system,
                                             load_tree_stats, save_tree)
    from kaldi_tpu_torch.tree.build_tree import Questions, build_tree_two_level
    from kaldi_tpu_torch.tree.context_dep import TreeContextDependency
    model = load_gmm_system(args.model, device="cpu")
    stats, N, Pc = load_tree_stats(args.tree_stats)
    qsets = _read_question_sets(args.questions)
    phones = sorted({ph for (ph, _s, _p) in model.trans_model.tuples})
    ph2cls = {p: model.lang.topo.num_pdf_classes(p) for p in phones}
    questions = Questions(qsets, num_pdf_classes=max(ph2cls.values()),
                          N=N, P=Pc)
    fine, n_fine, _coarse, n_coarse, f2c = build_tree_two_level(
        stats, questions, [[p] for p in phones], ph2cls,
        max_leaves_first=args.max_leaves_first,
        max_leaves_second=args.max_leaves_second, P=Pc)
    save_tree(args.tree_out, TreeContextDependency(N, Pc, fine, n_fine))
    with open(args.map_out, "w") as f:
        for leaf, c in enumerate(f2c):
            f.write(f"{leaf} {c}\n")
    print(f"build-tree-two-level: {n_fine} fine leaves over "
          f"{n_coarse} coarse", file=sys.stderr)


def _tree_of(path: str):
    """A tree file's tree, or a GMM system file's."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_tree
    try:
        return load_tree(path)
    except Exception:
        return load_gmm_system(path, device="cpu").ctx_dep


def cmd_copy_tree(args):
    """(ref: bin/copy-tree.cc; also takes the tree out of a GMM system
    file)"""
    from kaldi_tpu_torch.io.model_io import save_tree
    save_tree(args.tree_out, _tree_of(args.tree))
    print("copy-tree: done", file=sys.stderr)


def cmd_tree_info(args):
    """(ref: bin/tree-info.cc)"""
    ctx = _tree_of(args.model)
    print(f"num-pdfs {ctx.num_pdfs}")
    print(f"context-width {ctx.context_width}")
    print(f"central-position {ctx.central_position}")


def cmd_gmm_init_model(args):
    """GMM system from a tree + tree stats, one gaussian per leaf from the
    leaf's own stats (ref: gmmbin/gmm-init-model.cc); the AM is built for
    the device."""
    from kaldi_tpu_torch.io.model_io import (load_gmm_system,
                                             load_tree, load_tree_stats,
                                             save_gmm_system)
    from kaldi_tpu_torch.steps.deltas import (init_am_from_leaf_stats,
                                              leaf_stats_from_tree_stats,
                                              transition_model_from_tree)
    from kaldi_tpu_torch.steps.mono import MonoModel
    dev = _device(args)
    src = load_gmm_system(args.model, device="cpu")
    ctx = load_tree(args.tree)
    stats, _N, _P = load_tree_stats(args.stats)
    tm = transition_model_from_tree(src.lang, ctx)
    am = init_am_from_leaf_stats(leaf_stats_from_tree_stats(stats, ctx),
                                 src.am.dim, device=dev)
    save_gmm_system(args.model_out, MonoModel(am, tm, ctx, src.lang))
    print(f"gmm-init-model: {am.num_pdfs} pdfs, "
          f"{tm.num_transition_ids} transition ids", file=sys.stderr)


def cmd_train_deltas(args):
    """Tied-triphone training from an existing system and a data dir's
    text + features (ref: steps/train_deltas.sh fused, like train-mono),
    on the device."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_gmm_system
    from kaldi_tpu_torch.steps.deltas import DeltasTrainOpts, train_deltas
    dev = _device(args)
    ali_model = load_gmm_system(args.model, device=dev)
    utts = _load_train_utts(args.text, args.rspecifier)
    model = train_deltas(ali_model.lang, utts, ali_model, DeltasTrainOpts(
        num_iters=args.num_iters, totgauss=args.totgauss,
        num_leaves=args.num_leaves, tree_thresh=args.tree_thresh,
        realign_iters=tuple(range(1, args.num_iters)),
        sil_roots=args.sil_roots))
    save_gmm_system(args.model_out, model)
    print(f"train-deltas: {model.am.num_pdfs} pdfs, "
          f"{model.am.total_gauss} gauss", file=sys.stderr)


# ---------------------------------------------------------------- GMMs

def _post_to_pdf_post(post, tm):
    """Text-archive posterior (tid, w) frames -> (pdf, w) frames."""
    return [[(tm.transition_id_to_pdf(tid), w) for (tid, w) in frame]
            for frame in post]


def _occs(acc) -> np.ndarray:
    """Per-pdf occupancies of GMM accumulators."""
    return np.array([a.occ.sum() for a in acc.accs])


def _avg_like(acc) -> str:
    return f"{acc.tot_like / max(acc.tot_frames, 1.0):.4f}"


def cmd_gmm_init_mono(args):
    """Flat-start monophone model from global feature moments
    (ref: gmmbin/gmm-init-mono.cc); the AM is built for the device."""
    from kaldi_tpu_torch.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import save_gmm_system
    from kaldi_tpu_torch.steps.mono import flat_start
    dev = _device(args)
    with open(args.lexicon) as f:
        lex = Lexicon.parse(f.read())
    lang = prepare_lang(lex, [args.sil_phone], args.sil_phone,
                        num_sil_states=args.num_sil_states)
    feats = [v for (_k, v) in open_rspecifier(args.rspecifier)]
    model = flat_start(lang, feats, device=dev)
    save_gmm_system(args.model_out, model)
    print(f"gmm-init-mono: {model.am.num_pdfs} pdfs, dim "
          f"{model.am.dim}", file=sys.stderr)


def cmd_gmm_acc_stats_ali(args):
    """GMM + transition stats from transition-id alignments
    (ref: gmmbin/gmm-acc-stats-ali.cc); the gaussian posteriors on the
    device."""
    from kaldi_tpu_torch.gmm.estimation import AccumAmDiagGmm
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_gmm_accs
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    am, tm = model.am, model.trans_model
    acc = AccumAmDiagGmm(am)
    trans_counts = np.zeros(tm.num_transition_ids + 1, np.float64)
    feats = dict(open_rspecifier(args.rspecifier))
    n = 0
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        if utt not in feats:
            print(f"gmm-acc-stats-ali: no feats for {utt}",
                  file=sys.stderr)
            continue
        tids = np.asarray(ali, np.int64)
        acc.accumulate_from_alignment(am, feats[utt],
                                      tm.id2pdf_array[tids])
        np.add.at(trans_counts, tids, 1.0)
        n += 1
    save_gmm_accs(args.accs_out, acc, trans_counts)
    print(f"gmm-acc-stats-ali: {n} utts, avg loglike/frame "
          f"{_avg_like(acc)}", file=sys.stderr)


def cmd_gmm_sum_accs(args):
    """(ref: gmmbin/gmm-sum-accs.cc)"""
    from kaldi_tpu_torch.io.model_io import load_gmm_accs, save_gmm_accs
    total, tc_total = None, None
    for p in args.accs_in:
        acc, tc = load_gmm_accs(p)
        if total is None:
            total, tc_total = acc, tc
        else:
            total.add(acc)
            if tc is not None:
                tc_total = tc if tc_total is None else tc_total + tc
    save_gmm_accs(args.accs_out, total, tc_total)
    print(f"gmm-sum-accs: {len(args.accs_in)} -> {args.accs_out}",
          file=sys.stderr)


def cmd_gmm_est(args):
    """MLE re-estimation from accs (+ transition update, optional mixup)
    (ref: gmmbin/gmm-est.cc); host f64."""
    from kaldi_tpu_torch.gmm.estimation import mle_diag_gmm_update
    from kaldi_tpu_torch.io.model_io import (load_gmm_accs,
                                             load_gmm_system,
                                             save_gmm_system)
    model = load_gmm_system(args.model, device="cpu")
    acc, trans_counts = load_gmm_accs(args.accs)
    am = model.am
    occs = _occs(acc)
    for i, a in enumerate(acc.accs):
        am.pdfs[i] = mle_diag_gmm_update(
            am.pdfs[i], a,
            min_gaussian_occupancy=args.min_gaussian_occupancy)
    if trans_counts is not None:
        model.trans_model.mle_update(trans_counts)
    if args.mix_up and args.mix_up > am.total_gauss:
        am.split_by_count(args.mix_up, power=args.power, occs=occs)
    am.invalidate()
    save_gmm_system(args.model_out, model)
    print(f"gmm-est: {am.num_pdfs} pdfs, {am.total_gauss} gauss, "
          f"avg loglike/frame {_avg_like(acc)}", file=sys.stderr)


def cmd_gmm_boost_silence(args):
    """Mixture weights of silence-phone pdfs scaled so that silence wins
    early alignments (ref: gmmbin/gmm-boost-silence.cc)."""
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    sil = set(int(p) for p in args.silence_phones.split(":") if p)
    pdfs = sorted({pdf for (ph, _st, pdf) in model.trans_model.tuples
                   if ph in sil})
    for pdf in pdfs:
        g = model.am.pdfs[pdf]
        model.am.pdfs[pdf] = DiagGmm(g.weights * args.boost, g.means,
                                     g.vars)
    model.am.invalidate()
    save_gmm_system(args.model_out, model)
    print(f"gmm-boost-silence: boosted {len(pdfs)} pdfs by "
          f"{args.boost}", file=sys.stderr)


def cmd_gmm_mixup(args):
    """Gaussian splitting to a target total (ref: gmmbin/gmm-mixup.cc)."""
    from kaldi_tpu_torch.io.model_io import (load_gmm_accs,
                                             load_gmm_system,
                                             save_gmm_system)
    model = load_gmm_system(args.model, device="cpu")
    occs = None
    if args.occs:
        occs = _occs(load_gmm_accs(args.occs)[0])
    model.am.split_by_count(args.mix_up, power=args.power, occs=occs)
    model.am.invalidate()
    save_gmm_system(args.model_out, model)
    print(f"gmm-mixup: -> {model.am.total_gauss} gauss", file=sys.stderr)


def cmd_gmm_gselect(args):
    """Per-frame top-N gaussian indices of a UBM, best first
    (ref: gmmbin/gmm-gselect.cc; text 'utt i i i ; i i i ; ...', one
    group per frame); host numpy, as JAX scores UBMs."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(args.ubm)
    out = open(args.gselect_out, "w") if args.gselect_out != "-" \
        else sys.stdout
    n = 0
    for utt, v in open_rspecifier(args.rspecifier):
        ll = ubm.loglikes(np.asarray(v, np.float64))
        k = min(args.n, ll.shape[1])
        idx = np.argpartition(-ll, k - 1, axis=1)[:, :k]
        row_ll = np.take_along_axis(ll, idx, axis=1)
        idx = np.take_along_axis(idx, np.argsort(-row_ll, axis=1), axis=1)
        out.write(utt + " " + " ; ".join(
            " ".join(str(int(i)) for i in row) for row in idx) + "\n")
        n += 1
    if args.gselect_out != "-":
        out.close()
    print(f"gmm-gselect: {n} utts, {args.n} per frame", file=sys.stderr)


def cmd_gmm_compute_likes(args):
    """Per-pdf log-likelihood matrices of a GMM AM, the input of the
    mapped decoders (ref: gmmbin/gmm-compute-likes.cc); on the device."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, v in open_rspecifier(args.rspecifier):
            ll = model.am.loglikes_np(np.asarray(v, np.float32)[None])[0]
            out.write(utt, ll.astype(np.float32))
            n += 1
    print(f"gmm-compute-likes: {n} utts", file=sys.stderr)


def _model_feats_posts(args):
    """(model on the device, {utt: feats}, the post file's (utt, post)
    pairs) of a posterior-weighted accumulation."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    return (model, dict(open_rspecifier(args.rspecifier)),
            read_post_ark(args.post_in))


def cmd_gmm_acc_stats(args):
    """GMM + transition stats weighted by the soft posteriors of a post
    file (ref: gmmbin/gmm-acc-stats.cc, the denominator stats of
    discriminative training); the gaussian posteriors on the device."""
    from kaldi_tpu_torch.gmm.estimation import AccumAmDiagGmm
    from kaldi_tpu_torch.io.model_io import save_gmm_accs
    model, feats, posts = _model_feats_posts(args)
    am, tm = model.am, model.trans_model
    acc = AccumAmDiagGmm(am)
    trans_counts = np.zeros(tm.num_transition_ids + 1, np.float64)
    n = 0
    for utt, post in posts:
        if utt not in feats:
            continue
        acc.accumulate_from_posteriors(am, feats[utt],
                                       _post_to_pdf_post(post, tm))
        for entries in post:
            for tid, w in entries:
                trans_counts[int(tid)] += w
        n += 1
    save_gmm_accs(args.accs_out, acc, trans_counts)
    print(f"gmm-acc-stats: {n} utts", file=sys.stderr)


def cmd_gmm_acc_stats2(args):
    """Signed posteriors -> numerator (w > 0) and denominator (w < 0)
    accs in one pass (ref: gmmbin/gmm-acc-stats2.cc); the gaussian
    posteriors on the device."""
    from kaldi_tpu_torch.gmm.estimation import AccumAmDiagGmm
    from kaldi_tpu_torch.io.model_io import save_gmm_accs
    model, feats, posts = _model_feats_posts(args)
    am = model.am
    num, den = AccumAmDiagGmm(am), AccumAmDiagGmm(am)
    n = 0
    for utt, post in posts:
        if utt not in feats:
            continue
        pdf_post = _post_to_pdf_post(post, model.trans_model)
        num.accumulate_from_posteriors(
            am, feats[utt], [[(p, w) for (p, w) in fr if w > 0]
                             for fr in pdf_post])
        den.accumulate_from_posteriors(
            am, feats[utt], [[(p, -w) for (p, w) in fr if w < 0]
                             for fr in pdf_post])
        n += 1
    save_gmm_accs(args.num_accs_out, num, None)
    save_gmm_accs(args.den_accs_out, den, None)
    print(f"gmm-acc-stats2: {n} utts", file=sys.stderr)


def cmd_gmm_scale_accs(args):
    """(ref: gmmbin/gmm-scale-accs.cc)"""
    from kaldi_tpu_torch.io.model_io import load_gmm_accs, save_gmm_accs
    acc, tc = load_gmm_accs(args.accs)
    s = args.scale
    for a in acc.accs:
        a.occ *= s
        a.mean_acc *= s
        a.var_acc *= s
    acc.tot_like *= s
    acc.tot_frames *= s
    if tc is not None:
        tc = tc * s
    save_gmm_accs(args.accs_out, acc, tc)
    print(f"gmm-scale-accs: scale {s}", file=sys.stderr)


def cmd_gmm_ismooth_stats(args):
    """I-smoothing of accs toward the model
    (ref: gmmbin/gmm-ismooth-stats.cc)."""
    from kaldi_tpu_torch.gmm.ebw import ismooth_stats_diag_gmm
    from kaldi_tpu_torch.io.model_io import (load_gmm_accs,
                                             load_gmm_system,
                                             save_gmm_accs)
    model = load_gmm_system(args.model, device="cpu")
    acc, tc = load_gmm_accs(args.accs)
    for pdf in range(model.am.num_pdfs):
        acc.accs[pdf] = ismooth_stats_diag_gmm(
            acc.accs[pdf], model.am.pdfs[pdf], args.tau)
    save_gmm_accs(args.accs_out, acc, tc)
    print(f"gmm-ismooth-stats: tau {args.tau}", file=sys.stderr)


def _num_den(args):
    """(model on the CPU, numerator accs, denominator accs)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_accs, load_gmm_system
    return (load_gmm_system(args.model, device="cpu"),
            load_gmm_accs(args.num_accs)[0], load_gmm_accs(args.den_accs)[0])


def cmd_gmm_est_gaussians_ebw(args):
    """Discriminative (EBW) mean and variance update from numerator and
    denominator accs (ref: gmmbin/gmm-est-gaussians-ebw.cc)."""
    from kaldi_tpu_torch.gmm.ebw import EbwOptions, update_ebw_diag_gmm
    from kaldi_tpu_torch.io.model_io import save_gmm_system
    model, num, den = _num_den(args)
    opts = EbwOptions(E=args.E, tau=args.tau)
    for pdf in range(model.am.num_pdfs):
        model.am.pdfs[pdf] = update_ebw_diag_gmm(
            model.am.pdfs[pdf], num.accs[pdf], den.accs[pdf], opts)[0]
    model.am.invalidate()
    save_gmm_system(args.model_out, model)
    print(f"gmm-est-gaussians-ebw: updated {model.am.num_pdfs} pdfs",
          file=sys.stderr)


def cmd_gmm_est_weights_ebw(args):
    """EBW mixture-weight update (ref: gmmbin/gmm-est-weights-ebw.cc)."""
    from kaldi_tpu_torch.gmm.ebw import update_ebw_weights_diag_gmm
    from kaldi_tpu_torch.io.model_io import save_gmm_system
    model, num, den = _num_den(args)
    for pdf in range(model.am.num_pdfs):
        model.am.pdfs[pdf] = update_ebw_weights_diag_gmm(
            model.am.pdfs[pdf], num.accs[pdf], den.accs[pdf],
            weight_tau=args.weight_tau)
    model.am.invalidate()
    save_gmm_system(args.model_out, model)
    print(f"gmm-est-weights-ebw: updated {model.am.num_pdfs} pdfs",
          file=sys.stderr)


# --------------------------------------- global GMMs (UBMs; host numpy)

def _save_global_accs(path: str, acc, full: bool, tot_like: float,
                      tot_frames: float):
    """A global GMM's accumulators in JAX's npz layout."""
    blobs = {"occ": acc.occ, "mean_acc": acc.mean_acc,
             "full": np.int64(full), "tot_like": np.float64(tot_like),
             "tot_frames": np.float64(tot_frames)}
    blobs["cov_acc" if full else "var_acc"] = \
        acc.cov_acc if full else acc.var_acc
    with open(path, "wb") as f:
        np.savez(f, **blobs)


def _global_acc(ubm, dim=None):
    """-> (an empty accumulator of the UBM's covariance kind, is full)."""
    from kaldi_tpu_torch.gmm.estimation import AccumDiagGmm
    from kaldi_tpu_torch.gmm.full_gmm import AccumFullGmm, FullGmm
    full = isinstance(ubm, FullGmm)
    return ((AccumFullGmm if full else AccumDiagGmm)(
        ubm.num_gauss, ubm.dim if dim is None else dim), full)


def cmd_gmm_global_get_post(args):
    """Top-N UBM component posteriors per frame as a post file
    (ref: gmmbin/gmm-global-get-post.cc)."""
    from kaldi_tpu_torch.hmm.posterior import write_post_line
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(args.model)
    n = 0
    with open(args.post_out, "w") as out:
        for utt, feats in open_rspecifier(args.rspecifier):
            x = feats.astype(np.float64)
            post = np.asarray(ubm.posteriors(x.astype(np.float32)),
                              np.float64)
            idx = np.argsort(-post, axis=1)[:, : args.n]
            lines = []
            for t in range(len(x)):
                sel = [(int(i), float(post[t, i])) for i in idx[t]
                       if post[t, i] >= args.min_post]
                tot = sum(w for (_i, w) in sel) or 1.0
                lines.append([(i, w / tot) for (i, w) in sel])
            write_post_line(out, utt, lines)
            n += 1
    print(f"gmm-global-get-post: {n} utts", file=sys.stderr)


def cmd_gmm_global_to_fgmm(args):
    """Diagonal UBM -> full-covariance UBM
    (ref: gmmbin/gmm-global-to-fgmm.cc)."""
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.io.model_io import load_ubm, save_ubm
    ubm = load_ubm(args.model)
    covars = np.stack([np.diag(v) for v in ubm.vars])
    save_ubm(args.model_out,
             FullGmm(ubm.weights.copy(), ubm.means.copy(), covars))
    print(f"gmm-global-to-fgmm: {ubm.num_gauss} gauss, dim {ubm.dim}",
          file=sys.stderr)


def cmd_gmm_global_copy(args):
    """(ref: gmmbin/gmm-global-copy.cc)"""
    from kaldi_tpu_torch.io.model_io import load_ubm, save_ubm
    save_ubm(args.model_out, load_ubm(args.model))
    print("gmm-global-copy: done", file=sys.stderr)


def cmd_gmm_global_info(args):
    """(ref: gmmbin/gmm-global-info.cc)"""
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(args.model)
    print(f"number of gaussians {ubm.num_gauss}")
    print(f"feature dimension {ubm.dim}")
    print(f"covariance type "
          f"{'full' if isinstance(ubm, FullGmm) else 'diagonal'}")


def cmd_gmm_global_acc_stats_post(args):
    """UBM stats weighted by precomputed component posteriors
    (ref: fgmmbin/fgmm-global-acc-stats-post.cc)."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(args.model)
    acc, full = _global_acc(ubm)
    feats = dict(open_rspecifier(args.rspecifier))
    n = 0
    for utt, post in read_post_ark(args.post_in):
        if utt not in feats:
            continue
        x = feats[utt].astype(np.float64)
        P = np.zeros((len(x), ubm.num_gauss))
        for t, fr in enumerate(post):
            for (i, w) in fr:
                if t < len(x):
                    P[t, i] = w
        acc.accumulate_from_posteriors(x, P)
        n += 1
    _save_global_accs(args.accs_out, acc, full, 0.0, acc.occ.sum())
    print(f"fgmm-global-acc-stats-post: {n} utts", file=sys.stderr)


def cmd_gmm_global_acc_stats(args):
    """EM stats of a global (non-HMM) diagonal or full GMM over a feature
    archive (ref: gmmbin/gmm-global-acc-stats.cc,
    fgmmbin/fgmm-global-acc-stats.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(args.model)
    acc, full = _global_acc(ubm)
    n_frames, tot_like = 0, 0.0
    for _utt, feats in open_rspecifier(args.rspecifier):
        x = feats.astype(np.float64)
        acc.accumulate(ubm, x)
        tot_like += float(ubm.loglike(x).sum())
        n_frames += len(x)
    _save_global_accs(args.accs_out, acc, full, tot_like, n_frames)
    print(f"gmm-global-acc-stats: {n_frames} frames, avg loglike "
          f"{tot_like / max(n_frames, 1):.4f}", file=sys.stderr)


def cmd_gmm_global_est(args):
    """(ref: gmmbin/gmm-global-est.cc, fgmmbin/fgmm-global-est.cc); a
    full-covariance update floors its eigenvalues on the device."""
    from kaldi_tpu_torch.gmm.estimation import mle_diag_gmm_update
    from kaldi_tpu_torch.gmm.full_gmm import mle_full_gmm_update
    from kaldi_tpu_torch.io.model_io import load_ubm, save_ubm
    dev = _device(args)
    ubm = load_ubm(args.model)
    z = np.load(args.accs)
    acc, full = _global_acc(ubm)
    assert bool(z["full"]) == full, "accs/model covariance kind"
    acc.occ, acc.mean_acc = z["occ"], z["mean_acc"]
    if full:
        acc.cov_acc = z["cov_acc"]
        new = mle_full_gmm_update(
            ubm, acc, min_gaussian_occupancy=args.min_gaussian_occupancy,
            device=dev)
    else:
        acc.var_acc = z["var_acc"]
        new = mle_diag_gmm_update(
            ubm, acc, min_gaussian_occupancy=args.min_gaussian_occupancy)
    save_ubm(args.model_out, new)
    print(f"gmm-global-est: avg loglike/frame "
          f"{float(z['tot_like']) / max(float(z['tot_frames']), 1):.4f}",
          file=sys.stderr)


def cmd_gmm_global_get_frame_likes(args):
    """Per-frame total loglikes under a global GMM
    (ref: gmmbin/gmm-global-get-frame-likes.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(args.model)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, feats in open_rspecifier(args.rspecifier):
            out.write(utt, np.asarray(ubm.loglike(
                feats.astype(np.float64)), np.float32))
            n += 1
    print(f"gmm-global-get-frame-likes: {n} utts", file=sys.stderr)


def cmd_gmm_global_sum_accs(args):
    """(ref: gmmbin/gmm-global-sum-accs.cc)"""
    blobs = None
    for p in args.accs_in:
        z = dict(np.load(p))
        if blobs is None:
            blobs = z
        else:
            assert bool(z["full"]) == bool(blobs["full"])
            for k in z:
                if k != "full":
                    blobs[k] = blobs[k] + z[k]
    with open(args.accs_out, "wb") as f:
        np.savez(f, **blobs)
    print(f"gmm-global-sum-accs: {len(args.accs_in)} files",
          file=sys.stderr)


# ------------------------------------------------ lattice generation

def _latgen_from_loglikes(packed, keys, ll, nf, args, dev, sym=None):
    """Shared latgen tail: the padded beam search's lattice decode of a
    [B, T, P] loglike batch on `dev`, optional word-level
    determinization, best-path transcriptions (int ids, or words via
    `sym`), optional lattice ark (ref: decoder/decoder-wrappers.cc
    DecodeUtteranceLattice*)."""
    from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder
    from kaldi_tpu_torch.lat.functions import (DeterminizeLatticeOverflow,
                                               determinize_lattice,
                                               lattice_best_path)
    from kaldi_tpu_torch.lat.generate import decode_to_lattices
    from kaldi_tpu_torch.lat.io import write_lattice_ark
    dec = BeamSearchDecoder(packed, _beam_opts(args), device=dev)
    lats = decode_to_lattices(dec, ll, nf, lattice_beam=args.lattice_beam)
    if args.determinize_lattice:
        # the reference default: every raw lattice is determinized to
        # word level before writing; on blowup keep the raw lattice
        # (gmm-latgen-faster --determinize-lattice=true,
        #  decoder-wrappers.cc:267,283)
        det = []
        for lat in lats:
            if lat is None:
                det.append(None)
                continue
            try:
                det.append(determinize_lattice(lat, beam=args.lattice_beam))
            except DeterminizeLatticeOverflow as e:
                print(f"warning: {e}; keeping raw lattice",
                      file=sys.stderr)
                det.append(lat)
        lats = det
    trans_out = getattr(args, "transcription_out", "")
    out = open(trans_out, "w") if trans_out else sys.stdout
    for b, k in enumerate(keys):
        if lats[b] is None:
            out.write(f"{k}\n")
            continue
        res = lattice_best_path(lats[b])
        ws = res[0] if res else []
        txt = " ".join(sym(w) if sym else str(w) for w in ws)
        out.write(f"{k} {txt}\n")
    if trans_out:
        out.close()
    if args.lattice_out:
        write_lattice_ark(args.lattice_out,
                          {k: lats[b] for b, k in enumerate(keys)})


def _gmm_loglikes(model, items):
    """[(key, feats)] -> ([B, T, P] f32 loglikes scored on the model's
    device with the padding masked, so that no path survives past an
    utterance's end; [B] int32 frame counts)."""
    feats, nf = _pad_batch(items)
    ll = model.am.loglikes_np(feats)
    for b in range(len(items)):
        ll[b, nf[b]:] = -1e10
    return ll, nf


def cmd_latgen_faster_mapped(args):
    """Lattice-generating decode from precomputed pdf log-likelihood
    matrices (ref: bin/latgen-faster-mapped.cc — the decodable is a
    matrix, the graph maps tids to pdf rows) by the padded beam search
    on the device. Writes int transcriptions to stdout and, with
    --lattice-out, text lattices."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_hclg
    dev = _device(args)
    packed = load_hclg(args.graph)
    items = list(open_rspecifier(args.loglikes_rspecifier))
    ll, nf = _pad_batch(items, fill=-1e10)
    _latgen_from_loglikes(packed, [k for (k, _m) in items], ll, nf, args,
                          dev)


def cmd_gmm_latgen_faster(args):
    """Lattice-generating GMM decode straight from features — the
    reference's #1 entry point (ref: gmmbin/gmm-latgen-faster.cc); the
    loglikes and the search run on the device. Optional --utt2spk +
    --transform applies per-speaker fMLLR before scoring (the
    steps/decode_fmllr.sh second pass)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, read_ark
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    from kaldi_tpu_torch.transform.fmllr import apply_affine_transform
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    packed = load_hclg(args.graph)
    items = list(open_rspecifier(args.rspecifier))
    if args.transform:
        trans = {k: np.asarray(v, np.float64)
                 for (k, v) in read_ark(args.transform)}
        utt2spk = _read_utt2spk(args.utt2spk)
        items = [(k, _to_host(apply_affine_transform(
                      f, trans[utt2spk.get(k, k)], dev))
                  if utt2spk.get(k, k) in trans else f)
                 for (k, f) in items]
    ll, nf = _gmm_loglikes(model, items)
    _latgen_from_loglikes(packed, [k for (k, _f) in items], ll, nf, args,
                          dev, sym=model.lang.words.sym)


def cmd_decode_fmllr(args):
    """Two-pass fMLLR decoding: SI first pass, per-speaker fMLLR from
    first-pass alignments, adapted second pass, by the decoder
    `make_decoder` picks for the graph, on the device
    (ref: steps/decode_fmllr.sh; gmm-est-fmllr + gmm-latgen-faster)."""
    from kaldi_tpu_torch.decoder.dense import make_decoder
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    from kaldi_tpu_torch.steps.sat import SatModel, decode_fmllr
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    packed = load_hclg(args.graph)
    utt2spk = _read_utt2spk(args.utt2spk)
    utts = [(k, f.astype(np.float32), utt2spk.get(k, k))
            for (k, f) in open_rspecifier(args.rspecifier)]
    dec = make_decoder(packed, _beam_opts(args), device=dev)
    hyps = decode_fmllr(SatModel(model, {}), dec, utts, model.lang,
                        acoustic_scale=args.acoustic_scale,
                        fmllr_min_count=args.fmllr_min_count)
    out = open(args.transcription_out, "w") if args.transcription_out \
        else sys.stdout
    for (k, _f, _s) in utts:
        words = " ".join(model.lang.words.sym(w) for w in hyps.get(k, []))
        out.write(f"{k} {words}\n")
    if args.transcription_out:
        out.close()


def cmd_gmm_rescore_lattice(args):
    """Replace lattice acoustic costs with this GMM's likelihoods, scored
    on the device (ref: gmmbin/gmm-rescore-lattice.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.posteriors import rescore_lattice
    model = load_gmm_system(args.model, device=_device(args))
    feats = dict(open_rspecifier(args.rspecifier))
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        if key not in feats:
            continue
        ll = model.am.loglikes_np(feats[key].astype(np.float32)[None])[0]
        out[key] = rescore_lattice(lat, ll.astype(np.float64),
                                   model.trans_model,
                                   acoustic_scale=args.acoustic_scale)
    write_lattice_ark(args.out_ark, out)
    print(f"gmm-rescore-lattice: {len(out)}", file=sys.stderr)


def cmd_gmm_latgen_biglm_faster(args):
    """Decode with a small-LM graph on the device, rescore exactly under
    a big const-arpa LM on the host (decode-then-rescore realisation of
    the reference's on-the-fly composition; ref:
    gmmbin/gmm-latgen-biglm-faster.cc, kaldi_tpu_torch/decoder/biglm.py
    for the semantics bound)."""
    from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder
    from kaldi_tpu_torch.decoder.biglm import decode_biglm
    from kaldi_tpu_torch.fst.text_io import load_fst
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import (load_const_arpa,
                                             load_gmm_system, load_hclg)
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    packed = load_hclg(args.graph)
    old_g = load_fst(args.old_g)
    new_lm = load_const_arpa(args.new_lm)
    dec = BeamSearchDecoder(packed, _beam_opts(args), device=dev)
    items = list(open_rspecifier(args.rspecifier))
    ll, nf = _gmm_loglikes(model, items)
    results = decode_biglm(dec, ll, nf, old_g,
                           backoff_label=args.backoff_symbol,
                           new_lm=new_lm, lm_scale=args.lm_scale,
                           lattice_beam=args.lattice_beam)
    _write_transcripts(args, [k for (k, _f) in items], results,
                       model.lang.words.sym)


# ------------------------------------------- language-model rescoring

def cmd_arpa_to_const_arpa(args):
    """Build and save the packed const-arpa LM artifact
    (ref: lmbin/arpa-to-const-arpa.cc)."""
    from kaldi_tpu_torch.lm.arpa import ArpaLm
    from kaldi_tpu_torch.lm.const_arpa import ConstArpaLm
    from kaldi_tpu_torch.io.model_io import save_const_arpa
    from kaldi_tpu_torch.fst.fst import SymbolTable
    words = SymbolTable.read(args.words)
    with open(args.arpa) as f:
        clm = ConstArpaLm(ArpaLm.parse(f.read()), words)
    save_const_arpa(args.out, clm)
    print(f"arpa-to-const-arpa: {len(clm.row_lo) - 1} states, "
          f"{len(clm.col_word)} transitions", file=sys.stderr)


def cmd_lattice_lmrescore_const_arpa(args):
    """Replace/interpolate LM scores via a const-arpa LM
    (ref: latbin/lattice-lmrescore-const-arpa.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lm.arpa import ArpaLm
    from kaldi_tpu_torch.lm.const_arpa import (ConstArpaLm,
                                               lattice_lmrescore_const_arpa)
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    if args.arpa.endswith(".npz") or args.arpa.endswith(".clm"):
        from kaldi_tpu_torch.io.model_io import load_const_arpa
        clm = load_const_arpa(args.arpa)
    else:
        with open(args.arpa) as f:
            clm = ConstArpaLm(ArpaLm.parse(f.read()), model.lang.words)
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        out[key] = lattice_lmrescore_const_arpa(lat, clm,
                                                lm_scale=args.lm_scale)
    write_lattice_ark(args.out_ark, out)


def cmd_lattice_lmrescore(args):
    """Add lm_scale * G-costs by composing each lattice with a backoff
    word acceptor; run with --lm-scale=-1 on the old G then +1 on the
    new one to swap LMs (ref: latbin/lattice-lmrescore.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.functions import compose_lattice_with_lm
    from kaldi_tpu_torch.fst.text_io import load_fst
    g = load_fst(args.g_fst)
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        out[key] = compose_lattice_with_lm(
            lat, g, backoff_label=args.backoff_symbol,
            lm_scale=args.lm_scale)
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-lmrescore: {len(out)} lattices, "
          f"lm_scale={args.lm_scale}", file=sys.stderr)


def cmd_lattice_rescore_mapped(args):
    """Replace acoustic costs from new loglike matrices
    (ref: latbin/lattice-rescore-mapped.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.posteriors import rescore_lattice
    tm = load_gmm_system(args.model, device="cpu").trans_model
    likes = {k: np.asarray(v, np.float64)
             for (k, v) in open_rspecifier(args.loglikes_rspecifier)}
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        if key not in likes:
            continue
        out[key] = rescore_lattice(lat, likes[key], tm,
                                   acoustic_scale=args.acoustic_scale)
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-rescore-mapped: {len(out)}", file=sys.stderr)


def cmd_lattice_add_trans_probs(args):
    """Add transition log-probs into the graph cost
    (ref: latbin/lattice-add-trans-probs.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    tm = load_gmm_system(args.model, device="cpu").trans_model
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        for s in range(lat.num_states):
            for a in lat.arcs[s]:
                if a.ilabel:
                    a.graph_cost -= (args.transition_scale
                                     * float(tm.log_probs[a.ilabel]))
        out[key] = lat
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-add-trans-probs: {len(out)}", file=sys.stderr)


# ------------------------------------------------------ lattice tools

def _arc_frames(a) -> int:
    """Frames a lattice arc covers: its transition-id string's length,
    else one for an emitting arc."""
    tids = getattr(a, "tids", None)
    if tids:
        return len(tids)
    return 1 if a.ilabel else 0


def cmd_lattice_copy(args):
    """Copy/validate a text lattice archive (ref: latbin/lattice-copy.cc;
    with --write-ark="" prints per-lattice stats only)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    lats = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        lats[key] = lat
        if args.verbose:
            print(f"{key}: {lat.num_states} states {lat.num_arcs} arcs",
                  file=sys.stderr)
    if args.out:
        write_lattice_ark(args.out, lats)
    print(f"lattice-copy: {len(lats)} lattices", file=sys.stderr)


def cmd_lattice_depth(args):
    """Mean arc depth (arcs crossing each frame) per lattice and overall
    (ref: latbin/lattice-depth.cc Compute total arc-frames / frames)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    tot_frames, tot_arc_frames = 0, 0
    for key, lat in read_lattice_ark(args.lattice_ark):
        arc_frames = sum(_arc_frames(a)
                         for s in range(lat.num_states)
                         for a in lat.arcs[s])
        # frame count: max emitted frames over paths (time-synchronous
        # lattices agree on every path; DP over the topological order)
        order = lat.topological_order()
        nmax = np.zeros(lat.num_states, np.int64)
        for s in order:
            for a in lat.arcs[s]:
                nmax[a.nextstate] = max(nmax[a.nextstate],
                                        nmax[s] + _arc_frames(a))
        T = max((int(nmax[s]) for s in lat.finals), default=0)
        depth = arc_frames / max(T, 1)
        print(f"{key} {depth:.4f}")
        tot_frames += T
        tot_arc_frames += arc_frames
    print(f"lattice-depth: overall depth "
          f"{tot_arc_frames / max(tot_frames, 1):.4f} over "
          f"{tot_frames} frames", file=sys.stderr)


def cmd_lattice_rmali(args):
    """Strip alignments (transition-id ilabels / strings) from lattices
    (ref: latbin/lattice-rmali.cc — word lattices for LM rescoring
    don't need them)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    lats = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        for s in range(lat.num_states):
            for a in lat.arcs[s]:
                a.ilabel = 0
                if hasattr(a, "tids"):
                    a.tids = ()
        lats[key] = lat
    write_lattice_ark(args.out, lats)
    print(f"lattice-rmali: {len(lats)} lattices", file=sys.stderr)


def cmd_lattice_add_penalty(args):
    """Add a per-word insertion penalty to lattice graph costs
    (ref: latbin/lattice-add-penalty.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.functions import add_word_ins_penalty
    lats = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        add_word_ins_penalty(lat, args.word_ins_penalty)
        lats[key] = lat
    write_lattice_ark(args.out, lats)
    print(f"lattice-add-penalty: {len(lats)} lattices", file=sys.stderr)


def cmd_lattice_best_path(args):
    """Best paths from a text lattice ark, with optional rescaling
    (ref: latbin/lattice-best-path.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.functions import (add_word_ins_penalty,
                                               lattice_best_path,
                                               lattice_scale)
    for key, lat in read_lattice_ark(args.lattice_ark):
        lattice_scale(lat, lm_scale=args.lm_scale,
                      acoustic_scale=args.acoustic_scale)
        if args.word_ins_penalty:
            add_word_ins_penalty(lat, args.word_ins_penalty)
        res = lattice_best_path(lat)
        words = " ".join(str(w) for w in res[0]) if res else ""
        print(f"{key} {words}")


def _load_lattice_cmd(fn):
    """Wrap a per-lattice transform into an ark->ark command."""
    def run(args):
        from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
        out = {}
        for key, lat in read_lattice_ark(args.lattice_ark):
            r = fn(args, key, lat)
            if r is not None:
                out[key] = r
        write_lattice_ark(args.out_ark, out)
    return run


def cmd_lattice_scale(args, key, lat):
    from kaldi_tpu_torch.lat.functions import lattice_scale
    return lattice_scale(lat, lm_scale=args.lm_scale,
                         acoustic_scale=args.acoustic_scale)


def cmd_lattice_prune(args, key, lat):
    from kaldi_tpu_torch.lat.functions import prune_lattice
    return prune_lattice(lat, args.beam)


def cmd_lattice_determinize(args, key, lat):
    from kaldi_tpu_torch.lat.functions import (determinize_lattice,
                                               DeterminizeLatticeOverflow)
    try:
        return determinize_lattice(lat, beam=args.beam if args.beam > 0
                                   else None)
    except DeterminizeLatticeOverflow as e:
        # reference wrappers keep the raw lattice on determinization
        # blowup (decoder-wrappers.cc:283)
        print(f"warning: {key}: {e}; keeping raw lattice",
              file=sys.stderr)
        return lat


def cmd_lattice_push(args, key, lat):
    from kaldi_tpu_torch.lat.align import push_lattice
    return push_lattice(lat)


def cmd_lattice_minimize(args, key, lat):
    from kaldi_tpu_torch.lat.align import minimize_lattice
    return minimize_lattice(lat)


def cmd_lattice_nbest(args):
    """N best paths per lattice (ref: latbin/lattice-to-nbest.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.functions import nbest
    for key, lat in read_lattice_ark(args.lattice_ark):
        for i, (words, _tids, cost) in enumerate(nbest(lat, args.n)):
            print(f"{key}-{i + 1} {cost:.4f} "
                  + " ".join(str(w) for w in words))


def cmd_lattice_mbr_decode(args):
    """Minimum-Bayes-risk decode with confidences
    (ref: latbin/lattice-mbr-decode.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.functions import lattice_scale
    from kaldi_tpu_torch.lat.mbr import mbr_decode
    for key, lat in read_lattice_ark(args.lattice_ark):
        lattice_scale(lat, lm_scale=args.lm_scale,
                      acoustic_scale=args.acoustic_scale)
        words, bins = mbr_decode(lat)
        body = " ".join(f"{w}:{b.get(w, 0.0):.3f}"
                        for w, b in zip(words, bins))
        print(f"{key} {body}")


def cmd_lattice_oracle(args):
    """Oracle WER path through each lattice
    (ref: latbin/lattice-oracle.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.align import lattice_oracle
    refs = {}
    with open(args.ref_text) as f:
        for line in f:
            parts = line.split()
            refs[parts[0]] = [int(w) for w in parts[1:]]
    tot_err = tot_words = 0
    for key, lat in read_lattice_ark(args.lattice_ark):
        if key not in refs:
            continue
        errs, path = lattice_oracle(lat, refs[key])
        errs = int(errs)
        tot_err += errs
        tot_words += len(refs[key])
        print(f"{key} {errs} " + " ".join(str(w) for w in path))
    if tot_words:
        print(f"%oracle-WER {100.0 * tot_err / tot_words:.2f} "
              f"[ {tot_err} / {tot_words} ]", file=sys.stderr)


def cmd_lattice_union(args):
    """Per-key union of two lattice arks (ref: latbin/lattice-union.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.align import lattice_union
    a = dict(read_lattice_ark(args.ark_a))
    b = dict(read_lattice_ark(args.ark_b))
    out = {}
    for key in sorted(set(a) | set(b)):
        if key in a and key in b:
            out[key] = lattice_union(a[key], b[key])
        else:
            out[key] = a.get(key) or b[key]
    write_lattice_ark(args.out_ark, out)


def cmd_lattice_interp(args):
    """Weighted lattice interpolation (ref: latbin/lattice-interp.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.align import lattice_interp
    a = dict(read_lattice_ark(args.ark_a))
    b = dict(read_lattice_ark(args.ark_b))
    out = {}
    for key in sorted(set(a) & set(b)):
        out[key] = lattice_interp(a[key], b[key], args.alpha)
    write_lattice_ark(args.out_ark, out)


def cmd_lattice_to_ctm_conf(args):
    """Best-path CTM with MBR word confidences
    (ref: latbin/lattice-to-ctm-conf.cc): 'utt chan start dur word conf'
    with times in seconds."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.functions import (lattice_scale, best_path_ctm)
    from kaldi_tpu_torch.lat.mbr import mbr_decode, word_confidences
    for key, lat in read_lattice_ark(args.lattice_ark):
        lattice_scale(lat, lm_scale=args.lm_scale,
                      acoustic_scale=args.acoustic_scale)
        ctm = best_path_ctm(lat)
        words, bins = mbr_decode(lat)
        confs = word_confidences(words, bins)
        conf_of = ({w: c for w, c in zip(words, confs)}
                   if len(words) == len(confs) else {})
        for (w, s0, dur) in ctm:
            c = conf_of.get(w, 1.0)
            print(f"{key} 1 {s0 * args.frame_shift:.2f} "
                  f"{dur * args.frame_shift:.2f} {w} {c:.2f}")


def cmd_lattice_to_fst(args):
    """Lattices -> word FSTs (OpenFst text), weights optionally scaled
    away like the reference default (ref: latbin/lattice-to-fst.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.fst.fst import Fst
    from kaldi_tpu_torch.fst.text_io import write_fst_text
    n = 0
    with open(args.fsts_out, "w") as out:
        for key, lat in read_lattice_ark(args.lattice_ark):
            f = Fst()
            for _ in range(lat.num_states):
                f.add_state()
            f.start = lat.start
            for s in range(lat.num_states):
                for a in lat.arcs[s]:
                    w = (args.lm_scale * a.graph_cost
                         + args.acoustic_scale * a.acoustic_cost)
                    f.add_arc(s, a.olabel, a.olabel, w, a.nextstate)
            for s, (g, ac) in lat.finals.items():
                f.set_final(s, args.lm_scale * g
                            + args.acoustic_scale * ac)
            f.connect()
            out.write(f"{key}\n")
            write_fst_text(out, f)
            out.write("\n")
            n += 1
    print(f"lattice-to-fst: {n} lattices", file=sys.stderr)


def cmd_lattice_project(args):
    """Project onto output labels (word acceptor lattices)
    (ref: latbin/lattice-project.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        for s in range(lat.num_states):
            for a in lat.arcs[s]:
                a.ilabel = a.olabel
        out[key] = lat
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-project: {len(out)}", file=sys.stderr)


def cmd_lattice_depth_per_frame(args):
    """(ref: latbin/lattice-depth-per-frame.cc)"""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.posteriors import lattice_state_times
    for key, lat in read_lattice_ark(args.lattice_ark):
        times, T = lattice_state_times(lat)
        depth = np.zeros(T, np.int64)
        for s in range(lat.num_states):
            t = int(times[s])
            for a in lat.arcs[s]:
                if a.ilabel and t < T:
                    depth[t] += 1
        print(f"{key} " + " ".join(map(str, depth)))


def cmd_lattice_confidence(args):
    """Sentence-level confidence: best-path margin over the runner-up
    word sequence (ref: latbin/lattice-confidence.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.align import lattice_confidence
    for key, lat in read_lattice_ark(args.lattice_ark):
        c = lattice_confidence(lat)
        print(f"{key} {min(c, args.max_confidence):.4f}")


def cmd_lattice_compose(args):
    """Compose lattices with a word acceptor FST
    (ref: latbin/lattice-compose.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.functions import compose_lattice_with_lm
    from kaldi_tpu_torch.fst.text_io import load_fst
    g = load_fst(args.fst)
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        out[key] = compose_lattice_with_lm(lat, g, backoff_label=-1,
                                           lm_scale=1.0)
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-compose: {len(out)}", file=sys.stderr)


def cmd_lattice_1best(args):
    """Viterbi-best path of each lattice, written as a linear lattice
    (ref: latbin/lattice-1best.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.functions import lattice_scale, lattice_best_path
    from kaldi_tpu_torch.lat.lattice import Lattice
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        lattice_scale(lat, lm_scale=args.lm_scale,
                      acoustic_scale=args.acoustic_scale)
        res = lattice_best_path(lat)
        if res is None:
            print(f"warning: no path for {key}", file=sys.stderr)
            continue
        words, tids, cost = res
        lin = Lattice()
        prev = lin.add_state()
        lin.start = prev
        # emit one arc per tid; attach words greedily to the first arcs
        wq = list(words)
        for tid in tids:
            nxt = lin.add_state()
            lin.add_arc(prev, tid, wq.pop(0) if wq else 0, 0.0, 0.0, nxt)
            prev = nxt
        for w in wq:       # words beyond tids (tid-free lattice)
            nxt = lin.add_state()
            lin.add_arc(prev, 0, w, 0.0, 0.0, nxt)
            prev = nxt
        lin.set_final(prev, cost, 0.0)
        out[key] = lin
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-1best: {len(out)} lattices", file=sys.stderr)


def cmd_lattice_to_post(args):
    """Per-frame transition-id posteriors from lattice forward-backward
    (ref: latbin/lattice-to-post.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.functions import lattice_scale
    from kaldi_tpu_torch.lat.posteriors import lattice_to_post
    from kaldi_tpu_torch.hmm.posterior import write_post_line
    n, tot, frames = 0, 0.0, 0
    with open(args.post_out, "w") as f:
        for key, lat in read_lattice_ark(args.lattice_ark):
            lattice_scale(lat, lm_scale=args.lm_scale,
                          acoustic_scale=args.acoustic_scale)
            post, like = lattice_to_post(lat)
            write_post_line(f, key, post)
            tot += like
            frames += len(post)
            n += 1
    print(f"lattice-to-post: {n} lattices, avg loglike/frame "
          f"{tot / max(frames, 1):.4f}", file=sys.stderr)


def _read_ali_dict(rspecifier):
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    return {k: np.asarray(v, np.int64)
            for (k, v) in open_rspecifier(rspecifier)}


def cmd_lattice_to_mpe_post(args):
    """MPE/sMBR posteriors against a numerator alignment
    (ref: latbin/lattice-to-mpe-post.cc, lattice-to-smbr-post.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.functions import lattice_scale
    from kaldi_tpu_torch.lat.posteriors import (
        lattice_forward_backward_mpe_variants)
    from kaldi_tpu_torch.hmm.posterior import write_post_line
    model = load_gmm_system(args.model, device="cpu")
    ali = _read_ali_dict(args.ali_rspecifier)
    sil = {int(p) for p in args.silence_phones.split(":") if p}
    n, tot_acc, frames = 0, 0.0, 0
    with open(args.post_out, "w") as f:
        for key, lat in read_lattice_ark(args.lattice_ark):
            if key not in ali:
                continue
            lattice_scale(lat, lm_scale=args.lm_scale,
                          acoustic_scale=args.acoustic_scale)
            post, acc = lattice_forward_backward_mpe_variants(
                lat, ali[key], model.trans_model,
                criterion=args.criterion, silence_phones=sil,
                one_silence_class=not args.no_one_silence_class)
            write_post_line(f, key, post)
            tot_acc += acc
            frames += len(post)
            n += 1
    print(f"lattice-to-{args.criterion}-post: {n} lattices, avg "
          f"accuracy/frame {tot_acc / max(frames, 1):.4f}",
          file=sys.stderr)


def cmd_lattice_boost_ali(args):
    """Boosted-MMI lattice boosting against the numerator alignment
    (ref: latbin/lattice-boost-ali.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.posteriors import lattice_boost
    model = load_gmm_system(args.model, device="cpu")
    ali = _read_ali_dict(args.ali_rspecifier)
    sil = {int(p) for p in args.silence_phones.split(":") if p}
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        if key not in ali:
            continue
        out[key] = lattice_boost(
            lat, ali[key], model.trans_model, args.b,
            silence_phones=sil,
            max_silence_error=args.max_silence_error)
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-boost-ali: {len(out)} lattices, b={args.b}",
          file=sys.stderr)


def cmd_lattice_to_phone_lattice(args):
    """Replace word output labels with phone labels read off the
    transition-ids (ref: latbin/lattice-to-phone-lattice.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.align import phone_align_lattice
    model = load_gmm_system(args.model, device="cpu")
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        out[key] = phone_align_lattice(lat, model.trans_model,
                                       replace_output_symbols=True)
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-to-phone-lattice: {len(out)} lattices",
          file=sys.stderr)


def cmd_lattice_align_phones(args):
    """Re-segment lattice arcs on phone boundaries
    (ref: latbin/lattice-align-phones.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.align import phone_align_lattice
    model = load_gmm_system(args.model, device="cpu")
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        out[key] = phone_align_lattice(
            lat, model.trans_model,
            replace_output_symbols=args.replace_output_symbols)
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-align-phones: {len(out)} lattices", file=sys.stderr)


def cmd_lattice_equivalent(args):
    """Exit 0 iff the two archives' lattices are best-path equivalent
    within delta (a practical stand-in for the reference's randomized
    equivalence test; ref: latbin/lattice-equivalent.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    a = dict(read_lattice_ark(args.ark_a))
    b = dict(read_lattice_ark(args.ark_b))
    n_bad = 0
    for key in sorted(set(a) | set(b)):
        if key not in a or key not in b:
            n_bad += 1
            continue
        ra, rb = lattice_best_path(a[key]), lattice_best_path(b[key])
        if (ra is None) != (rb is None):
            n_bad += 1
            continue
        if ra is None:
            continue
        if ra[0] != rb[0] or abs(ra[2] - rb[2]) > args.delta:
            n_bad += 1
    print(f"lattice-equivalent: {n_bad} differ "
          f"of {len(set(a) | set(b))}", file=sys.stderr)
    if n_bad:
        sys.exit(1)


def cmd_lattice_limit_depth(args):
    """Prune with progressively tighter beams until mean depth is under
    the cap (ref: latbin/lattice-limit-depth.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.functions import prune_lattice
    from kaldi_tpu_torch.lat.posteriors import lattice_state_times
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        costs = [a.cost for arcs in lat.arcs for a in arcs]
        beam = max(1.0, float(np.ptp(costs))) if costs else 1.0
        for _ in range(10):
            _times, T = lattice_state_times(lat)
            n_arcs = sum(1 for arcs in lat.arcs for a in arcs
                         if a.ilabel != 0)
            if n_arcs / max(T, 1) <= args.max_depth:
                break
            lat = prune_lattice(lat, beam)
            beam *= 0.5       # tighten until under the depth cap
        out[key] = lat
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-limit-depth: {len(out)} lattices", file=sys.stderr)


def cmd_lattice_align_words(args):
    """Word alignment of lattices: every arc carries exactly one word
    spanning its true frames (ref: latbin/lattice-align-words-lexicon.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.fst.lang import Lexicon
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.align import word_align_lattice
    model = load_gmm_system(args.model, device="cpu")
    lang = model.lang
    with open(args.lexicon) as f:
        lex = Lexicon.parse(f.read())
    lex_phones: dict = {}
    for (word, _p, pron) in lex.entries:
        bad_ph = [ph for ph in pron if ph not in lang.phones]
        if bad_ph:
            raise SystemExit(
                f"lattice-align-words: lexicon entry '{word}' uses "
                f"phones absent from the model: {bad_ph}")
        if word not in lang.words:
            print(f"warning: lexicon word '{word}' not in the model's "
                  f"word table; skipping", file=sys.stderr)
            continue
        lex_phones.setdefault(lang.words[word], []).append(
            tuple(lang.phones[ph] for ph in pron))
    sil = {lang.phones[p] for p in lang.silence_phones
           if p in lang.phones}
    out = {}
    n_fail = 0
    for key, lat in read_lattice_ark(args.lattice_ark):
        aligned = word_align_lattice(lat, model.trans_model, lex_phones,
                                     silence_phones=sil)
        if aligned.num_states == 0 or aligned.start < 0 \
                or not aligned.finals:
            # the reference binary reports per-lattice alignment failure
            print(f"warning: word alignment failed for {key} (a word in "
                  f"the lattice has no matching pronunciation?)",
                  file=sys.stderr)
            n_fail += 1
            continue
        out[key] = aligned
    write_lattice_ark(args.lattice_out, out)
    print(f"lattice-align-words: {len(out)} lattices aligned, "
          f"{n_fail} failed", file=sys.stderr)


def cmd_lattice_reverse(args):
    """Time-reverse lattices (ref: latbin/lattice-reverse.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.lattice import Lattice
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        rev = Lattice()
        for _ in range(lat.num_states + 1):
            rev.add_state()
        # state 0 is the new super-start (the text format reads the
        # first state as the start); old state s becomes s + 1
        rev.start = 0
        for s in range(lat.num_states):
            for a in lat.arcs[s]:
                rev.add_arc(a.nextstate + 1, a.ilabel, a.olabel,
                            a.graph_cost, a.acoustic_cost, s + 1)
        for s, (g, ac) in lat.finals.items():
            rev.add_arc(0, 0, 0, g, ac, s + 1)
        rev.set_final(lat.start + 1, 0.0, 0.0)
        out[key] = rev
    write_lattice_ark(args.out_ark, out)
    print(f"lattice-reverse: {len(out)}", file=sys.stderr)


def cmd_lattice_combine(args):
    """Union lattices across N archives per key
    (ref: latbin/lattice-combine.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.align import lattice_union
    merged: dict = {}
    for p in args.arks_in:
        for key, lat in read_lattice_ark(p):
            merged[key] = (lattice_union(merged[key], lat)
                           if key in merged else lat)
    write_lattice_ark(args.out_ark, merged)
    print(f"lattice-combine: {len(merged)} keys from "
          f"{len(args.arks_in)} archives", file=sys.stderr)


# ------------------------------------------------------- n-best lists

def cmd_nbest_to_linear(args):
    """Split each lattice's n-best into numbered linear transcripts
    (ref: latbin/nbest-to-linear.cc output contract: per-path words)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.functions import nbest
    for key, lat in read_lattice_ark(args.lattice_ark):
        for i, (words, tids, cost) in enumerate(nbest(lat, args.n)):
            print(f"{key}-{i + 1} " + " ".join(str(w) for w in words))


def cmd_nbest_to_ctm(args):
    """Linear (single-path) lattices -> CTM lines with frame times
    (ref: latbin/nbest-to-ctm.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.lat.functions import best_path_ctm
    for key, lat in read_lattice_ark(args.lattice_ark):
        for (w, s0, dur) in best_path_ctm(lat):
            print(f"{key} 1 {s0 * args.frame_shift:.2f} "
                  f"{dur * args.frame_shift:.2f} {w}")


def cmd_linear_to_nbest(args):
    """Inverse of nbest-to-linear: utterance transcripts (int words) ->
    single-path lattices (ref: latbin/linear-to-nbest.cc)."""
    from kaldi_tpu_torch.lat.io import write_lattice_ark
    from kaldi_tpu_torch.lat.lattice import Lattice
    out = {}
    with open(args.transcripts) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            lin = Lattice()
            prev = lin.add_state()
            lin.start = prev
            for w in parts[1:]:
                nxt = lin.add_state()
                lin.add_arc(prev, 0, int(w), 0.0, 0.0, nxt)
                prev = nxt
            lin.set_final(prev, 0.0, 0.0)
            out[parts[0]] = lin
    write_lattice_ark(args.out_ark, out)
    print(f"linear-to-nbest: {len(out)} paths", file=sys.stderr)


def cmd_nbest_to_lattice(args):
    """Re-merge 'utt-N' n-best path lattices into one lattice per utt
    (ref: latbin/nbest-to-lattice.cc)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.align import lattice_union
    merged: dict = {}
    for key, lat in read_lattice_ark(args.nbest_ark):
        base = key.rsplit("-", 1)[0]
        merged[base] = (lattice_union(merged[base], lat)
                        if base in merged else lat)
    write_lattice_ark(args.out_ark, merged)
    print(f"nbest-to-lattice: {len(merged)} utts", file=sys.stderr)


# --------------------------------------------------------- posteriors

def cmd_weight_silence_post(args):
    """Scale posterior entries on silence-phone transition-ids
    (ref: bin/weight-silence-post.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.hmm.posterior import (read_post_ark, write_post_line,
                                               weight_silence_post)
    model = load_gmm_system(args.model, device="cpu")
    sil = [int(p) for p in args.silence_phones.split(":") if p]
    out = open(args.post_out, "w") if args.post_out != "-" else sys.stdout
    n = 0
    for utt, post in read_post_ark(args.post_in):
        write_post_line(out, utt, weight_silence_post(
            post, model.trans_model, sil, args.silence_weight))
        n += 1
    if args.post_out != "-":
        out.close()
    print(f"weight-silence-post: {n} utts", file=sys.stderr)


def cmd_sum_post(args):
    """Frame-wise posterior sum of two archives (ref: bin/sum-post.cc)."""
    from kaldi_tpu_torch.hmm.posterior import (read_post_ark, write_post_line,
                                               sum_post, scale_post)
    b_map = {u: p for (u, p) in read_post_ark(args.post_b)}
    out = open(args.post_out, "w") if args.post_out != "-" else sys.stdout
    n = 0
    for utt, pa in read_post_ark(args.post_a):
        if utt not in b_map:
            continue
        pa = scale_post(pa, args.scale1)
        pb = scale_post(b_map[utt], args.scale2)
        write_post_line(out, utt, sum_post(pa, pb))
        n += 1
    if args.post_out != "-":
        out.close()
    print(f"sum-post: {n} utts", file=sys.stderr)


def cmd_post_to_weights(args):
    """Per-frame total posterior weight vectors
    (ref: bin/post-to-weights.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.hmm.posterior import read_post_ark, post_to_weights
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, post in read_post_ark(args.post_in):
            out.write(utt, np.asarray(post_to_weights(post), np.float32))
            n += 1
    print(f"post-to-weights: {n} utts", file=sys.stderr)


def _post_map_cmd(fn, label):
    """Wrap a per-utterance posterior transform as a subcommand."""
    def run(args):
        from kaldi_tpu_torch.hmm.posterior import (read_post_ark,
                                                   write_post_line)
        n = 0
        with open(args.post_out, "w") as out:
            for utt, post in read_post_ark(args.post_in):
                write_post_line(out, utt, fn(args, post))
                n += 1
        print(f"{label}: {n} utts", file=sys.stderr)
    return run


def cmd_copy_post(args):
    """(ref: bin/copy-post.cc; --scale folds in scale-post.cc)"""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark, write_post_line, \
        scale_post
    n = 0
    with open(args.post_out, "w") as out:
        for utt, post in read_post_ark(args.post_in):
            if args.scale != 1.0:
                post = scale_post(post, args.scale)
            write_post_line(out, utt, post)
            n += 1
    print(f"copy-post: {n} utts", file=sys.stderr)


def cmd_weight_post(args):
    """Per-frame reweighting by a weights-vector archive
    (ref: bin/weight-post.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.hmm.posterior import (read_post_ark, write_post_line,
                                               weight_post)
    w = {k: np.asarray(v, np.float64)
         for (k, v) in open_rspecifier(args.weights_rspecifier)}
    n = 0
    with open(args.post_out, "w") as out:
        for utt, post in read_post_ark(args.post_in):
            if utt not in w:
                continue
            write_post_line(out, utt, weight_post(post, w[utt]))
            n += 1
    print(f"weight-post: {n} utts", file=sys.stderr)


def cmd_thresh_post(args):
    """Drop entries below the threshold (ref: bin/thresh-post.cc)."""
    def f(a, post):
        return [[(i, w) for (i, w) in fr if w >= a.threshold]
                for fr in post]
    return _post_map_cmd(f, "thresh-post")(args)


def cmd_rand_prune_post(args):
    """Randomized expectation-preserving pruning: an entry with
    |w| < scale survives with prob |w|/scale at weight ±scale
    (ref: bin/rand-prune-post.cc, RandPrune in base/kaldi-math.h)."""
    rng = np.random.RandomState(args.seed)
    s = args.scale

    def f(a, post):
        out = []
        for fr in post:
            kept = []
            for (i, w) in fr:
                if abs(w) >= s or s == 0:
                    kept.append((i, w))
                elif rng.rand() < abs(w) / s:
                    kept.append((i, s if w > 0 else -s))
            out.append(kept)
        return out
    return _post_map_cmd(f, "rand-prune-post")(args)


def cmd_post_to_pdf_post(args):
    """(ref: bin/post-to-pdf-post.cc)"""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    tm = load_gmm_system(args.model, device="cpu").trans_model
    return _post_map_cmd(
        lambda a, post: _post_to_pdf_post(post, tm),
        "post-to-pdf-post")(args)


def cmd_post_to_phone_post(args):
    """(ref: bin/post-to-phone-post.cc)"""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.hmm.posterior import post_to_phone_post
    tm = load_gmm_system(args.model, device="cpu").trans_model
    return _post_map_cmd(
        lambda a, post: post_to_phone_post(post, tm),
        "post-to-phone-post")(args)


def cmd_prob_to_post(args):
    """Probability (or log-prob) matrices -> sparse posteriors
    (ref: bin/prob-to-post.cc, bin/logprob-to-post.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.hmm.posterior import write_post_line
    n = 0
    with open(args.post_out, "w") as out:
        for utt, mat in open_rspecifier(args.rspecifier):
            p = np.asarray(mat, np.float64)
            if args.log_input:
                p = np.exp(p)
            post = [[(int(i), float(p[t, i]))
                     for i in np.nonzero(p[t] >= args.min_post)[0]]
                    for t in range(p.shape[0])]
            write_post_line(out, utt, post)
            n += 1
    print(f"prob-to-post: {n} utts", file=sys.stderr)


def cmd_get_post_on_ali(args):
    """Per-frame posterior of the aligned transition-id — the frame
    confidence used for frame-weighted training
    (ref: bin/get-post-on-ali.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    ali = {k: np.asarray(v, np.int64)
           for (k, v) in open_rspecifier(args.ali_rspecifier)}
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, post in read_post_ark(args.post_in):
            if utt not in ali:
                continue
            a = ali[utt]
            conf = np.zeros(len(post), np.float32)
            for t, fr in enumerate(post):
                if t < len(a):
                    conf[t] = sum(w for (i, w) in fr if i == a[t])
            out.write(utt, conf)
            n += 1
    print(f"get-post-on-ali: {n} utts", file=sys.stderr)


def cmd_feat_to_post(args):
    """Feature rows -> posterior entries (the KL-HMM input path)
    (ref: nnetbin/feat-to-post.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.hmm.posterior import write_post_line
    n = 0
    with open(args.post_out, "w") as out:
        for utt, f in open_rspecifier(args.rspecifier):
            post = [[(int(d), float(v)) for d, v in enumerate(row)
                     if abs(v) > args.min_value]
                    for row in np.asarray(f)]
            write_post_line(out, utt, post)
            n += 1
    print(f"feat-to-post: {n} utts", file=sys.stderr)


def cmd_paste_post(args):
    """Merge two posterior streams with the 2nd's ids offset by the
    first stream's dim (ref: nnetbin/paste-post.cc)."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark, write_post_line
    a = {k: p for (k, p) in read_post_ark(args.post_a)}
    b = {k: p for (k, p) in read_post_ark(args.post_b)}
    n = 0
    with open(args.post_out, "w") as out:
        for k in sorted(set(a) & set(b)):
            pa, pb = a[k], b[k]
            merged = [fa + [(i + args.dim_a, w) for (i, w) in fb]
                      for fa, fb in zip(pa, pb)]
            write_post_line(out, k, merged)
            n += 1
    print(f"paste-post: {n} utts", file=sys.stderr)


# ----------------------------------------------------- keyword search

def cmd_kws_search(args):
    """Keyword search over a text-lattice ark or a prebuilt index file
    (ref: kwsbin/kws-search.cc; keywords file: 'kwid word-id ...')."""
    from kaldi_tpu_torch.kws import (lattice_to_kws_index, search_index,
                                     load_kws_index)
    if getattr(args, "index", False):
        indexes = load_kws_index(args.lattice_ark)
    else:
        from kaldi_tpu_torch.lat.io import read_lattice_ark
        indexes = [lattice_to_kws_index(lat, key)
                   for key, lat in read_lattice_ark(args.lattice_ark)]
    with open(args.keywords) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            kwid, words = parts[0], [int(w) for w in parts[1:]]
            for (utt, t0, t1, p) in search_index(indexes, words):
                print(f"{kwid} {utt} {t0} {t1} {p:.4f}")


def cmd_lattice_to_kws_index(args):
    """Build the timed-factor keyword index from a lattice ark
    (ref: kwsbin/lattice-to-kws-index.cc over kws/kws-functions.h:89-97)."""
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    from kaldi_tpu_torch.kws import lattice_to_kws_index, save_kws_index
    indexes = [lattice_to_kws_index(lat, key)
               for key, lat in read_lattice_ark(args.lattice_ark)]
    save_kws_index(args.index_out, indexes)
    print(f"lattice-to-kws-index: {len(indexes)} utterances",
          file=sys.stderr)


def cmd_kws_index_union(args):
    """Union several index files (ref: kwsbin/kws-index-union.cc)."""
    from kaldi_tpu_torch.kws import (load_kws_index, save_kws_index,
                                     union_kws_indexes)
    merged = union_kws_indexes([load_kws_index(p) for p in args.indexes])
    save_kws_index(args.index_out, merged)
    print(f"kws-index-union: {len(args.indexes)} files -> "
          f"{len(merged)} utterances", file=sys.stderr)


def cmd_compute_atwv(args):
    """ATWV/STWV from a ref file ('kwid utt t_begin t_end') and a hits
    file ('kwid utt t_begin t_end score') (ref: kwsbin/compute-atwv.cc
    over kws/kws-scoring.h:188-221)."""
    from kaldi_tpu_torch.kws import compute_twv, TwvOptions

    def read4(path, with_score):
        d: dict = {}
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                kw, utt, t0, t1 = parts[:4]
                row = (utt, int(float(t0)), int(float(t1)))
                if with_score:
                    row += (float(parts[4]) if len(parts) > 4 else 1.0,)
                d.setdefault(kw, []).append(row)
        return d

    refs = read4(args.ref, with_score=False)
    hits = read4(args.hits, with_score=True)
    res = compute_twv(refs, hits, args.duration,
                      TwvOptions(score_threshold=args.score_threshold))
    print(f"ATWV {res['atwv']:.4f}")
    print(f"STWV {res['stwv']:.4f}")
    for kw in sorted(res["per_kw"]):
        print(f"{kw} {res['per_kw'][kw]:.4f}")


def cmd_generate_proxy_keywords(args):
    """Proxy keywords for OOVs by phone-confusion distance over the
    lexicon (ref: kwsbin/generate-proxy-keywords.cc). Keywords file:
    'kwid phone phone ...'; lexicon: 'word phone phone ...'."""
    from kaldi_tpu_torch.kws import generate_proxy_keywords
    lexicon: dict = {}
    with open(args.lexicon) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                lexicon.setdefault(parts[0], []).append(parts[1:])
    confusion = {}
    if args.confusion_matrix:
        with open(args.confusion_matrix) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    confusion[(parts[0], parts[1])] = float(parts[2])
    with open(args.keywords) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            kwid, pron = parts[0], parts[1:]
            for words, cost in generate_proxy_keywords(
                    pron, lexicon, confusion,
                    nbest=args.nbest, beam=args.proxy_beam):
                print(f"{kwid} {cost:.3f} " + " ".join(words))


# ------------------------------------------------ nnet3 (nnet3bin)

def _load_am3(path, device="cpu"):
    from kaldi_tpu_torch.io.model_io import load_am_nnet3
    return load_am_nnet3(path, device=device)


def _am3_tree(am) -> dict:
    """An AmNnet3's weights as JAX's {component: {leaf: array}}, in its
    file order (io/model_io.py `param_order`)."""
    from kaldi_tpu_torch.params import nnet3_params_to_jax
    tree = nnet3_params_to_jax(am.model.state_dict())
    order = getattr(am.model, "param_order", None)
    if not order:
        return tree
    out: dict = {}
    for c, k in order:
        out.setdefault(c, {})[k] = tree[c][k]
    return out


def _egs_tensors(egs, dev):
    """An egs dict's feats, targets and weights as tensors on `dev`."""
    return tuple(torch.as_tensor(egs[k], device=dev)
                 for k in ("feats", "targets", "weights"))


def cmd_nnet3_info(args):
    """Print an nnet3 model's structure: dims, context, nodes,
    components, parameter counts (ref: nnet3bin/nnet3-info.cc /
    nnet3-am-info.cc)."""
    am = _load_am3(args.model)
    net = am.model
    print(f"input-dim {net.dims.get('input', '?')}")
    print(f"output-dim {net.dims['output']}")
    print(f"left-context {net.left_context}")
    print(f"right-context {net.right_context}")
    print(f"num-parameters {net.num_params()}")
    print(f"num-nodes {len(net.nodes)}")
    print(f"num-components {len(net.components)}")
    for n in net.nodes:
        print(f"node {n.name} kind={n.kind} dim={net.dims.get(n.name)}")
    for name, cfg in net.components.items():
        print(f"component {name} type={cfg['type']}")


def cmd_nnet3_copy(args):
    """Copy an nnet3 model, optionally scaling parameters
    (ref: nnet3bin/nnet3-copy.cc --scale)."""
    from kaldi_tpu_torch.io.model_io import save_am_nnet3
    am = _load_am3(args.model)
    if args.scale != 1.0:
        am = am.replace_params({
            comp: {k: np.asarray(v) * args.scale for k, v in leaf.items()}
            for comp, leaf in _am3_tree(am).items()})
    save_am_nnet3(args.model_out, am)
    print(f"nnet3-copy: scale {args.scale}", file=sys.stderr)


def cmd_nnet3_compute(args):
    """Forward an nnet3 model over a feature archive on the device; writes
    the net output per utterance (log-posteriors), or pseudo-loglikes with
    --use-priors (ref: nnet3bin/nnet3-compute.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    dev = _device(args)
    am = _load_am3(args.model, dev)
    n = 0
    with open_wspecifier(args.wspecifier) as out, torch.inference_mode():
        for utt, feats in open_rspecifier(args.rspecifier):
            x = feats.astype(np.float32)[None]
            if args.use_priors:
                y = am.loglikes_np(x)[0]
            else:
                y = _to_host(am.model(torch.as_tensor(x, device=dev),
                                      pad_context=True)[0])
            out.write(utt, y.astype(np.float32))
            n += 1
    print(f"nnet3-compute: {n} utts", file=sys.stderr)


def cmd_nnet3_init(args):
    """Random-init an nnet3 model from a config file (ref:
    nnet3bin/nnet3-init.cc + steps/nnet3/make_tdnn_configs.py); the
    weights come from a torch.Generator seeded with --seed, not JAX's
    key."""
    from kaldi_tpu_torch.io.model_io import save_am_nnet3
    from kaldi_tpu_torch.nnet3.network import Nnet3
    from kaldi_tpu_torch.nnet3.training import AmNnet3
    with open(args.config) as f:
        net = Nnet3(f.read(), device="cpu")
    net.init(torch.Generator().manual_seed(args.seed))
    save_am_nnet3(args.nnet_out, AmNnet3(net))
    print(f"nnet3-init: output-dim {net.dims['output']}, "
          f"{len(net.components)} components", file=sys.stderr)


def cmd_nnet3_train(args):
    """SGD over an egs dir through the nnet3 trainer on the device
    (ref: nnet3bin/nnet3-train.cc, nnet3/nnet-training.cc:37)."""
    from kaldi_tpu_torch.io.model_io import save_am_nnet3
    from kaldi_tpu_torch.nnet3.training import Nnet3TrainOpts, train_nnet3
    dev = _device(args)
    am = _load_am3(args.nnet_in, dev)
    egs = _read_egs_dir(args.egs_dir)
    params, history = train_nnet3(
        am.model, am.model.params(), egs,
        Nnet3TrainOpts(initial_lr=args.initial_lr,
                       final_lr=args.final_lr,
                       num_epochs=args.num_epochs,
                       minibatch_size=args.minibatch_size,
                       momentum=args.momentum))
    save_am_nnet3(args.nnet_out, am.replace_params(params))
    if history:
        print(f"nnet3-train: final loss {history[-1][2]:.3f} "
              f"acc {history[-1][3]:.3f}", file=sys.stderr)


def cmd_nnet3_compute_prob(args):
    """Diagnostic objective over an egs dir on the device
    (ref: nnet3bin/nnet3-compute-prob.cc, nnet3/nnet-diagnostics.h:81)."""
    from kaldi_tpu_torch.nnet3.training import nnet3_objective
    dev = _device(args)
    am = _load_am3(args.nnet, dev)
    egs = _read_egs_dir(args.egs_dir)
    with torch.no_grad():
        loss, acc = nnet3_objective(am.model, am.model.params(),
                                    *_egs_tensors(egs, dev))
    print(f"log-probability-per-frame {-float(loss):.4f} "
          f"accuracy {float(acc):.4f}")


def _average_trees(trees):
    """JAX's average_params on numpy trees: sum(xs) / len(xs) per leaf,
    dict keys sorted as a JAX tree map leaves them."""
    if isinstance(trees[0], dict):
        return {k: _average_trees([t[k] for t in trees])
                for k in sorted(trees[0])}
    if isinstance(trees[0], list):
        return [_average_trees(list(xs)) for xs in zip(*trees)]
    return sum(trees) / len(trees)


def cmd_nnet3_average(args):
    """(ref: nnet3bin/nnet3-average.cc)"""
    from kaldi_tpu_torch.io.model_io import save_am_nnet3
    ams = [_load_am3(p) for p in args.nnets_in]
    out = ams[0].replace_params(_average_trees([_am3_tree(a) for a in ams]))
    out.priors = np.mean([a.priors for a in ams], axis=0)
    save_am_nnet3(args.nnet_out, out)
    print(f"nnet3-average: {len(ams)} models", file=sys.stderr)


def cmd_nnet3_combine(args):
    """Validation-optimal combination, fitted on the device
    (ref: nnet3bin/nnet3-combine.cc)."""
    from kaldi_tpu_torch.io.model_io import save_am_nnet3
    from kaldi_tpu_torch.nnet.combine import combine_params
    from kaldi_tpu_torch.nnet3.training import nnet3_objective
    dev = _device(args)
    ams = [_load_am3(p, dev) for p in args.nnets_in]
    feats, targets, weights = _egs_tensors(_read_egs_dir(args.valid_egs),
                                           dev)
    net = ams[0].model

    def loss_fn(params):
        return nnet3_objective(net, params, feats, targets, weights)[0]

    params, final_loss = combine_params(
        [a.model.params() for a in ams], loss_fn, num_steps=args.num_steps)
    save_am_nnet3(args.nnet_out, ams[0].replace_params(params))
    print(f"nnet3-combine: {len(ams)} models, valid loss "
          f"{final_loss:.4f}", file=sys.stderr)


def cmd_nnet3_adjust_priors(args):
    """priors := average posterior over the features, the forward on the
    device (ref: nnet3bin/nnet3-am-adjust-priors.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import save_am_nnet3
    am = _load_am3(args.nnet_in, _device(args))
    am.set_priors_from_posteriors(
        f.astype(np.float32)[None]
        for (_k, f) in open_rspecifier(args.rspecifier))
    save_am_nnet3(args.nnet_out, am)
    print("nnet3-am-adjust-priors: done", file=sys.stderr)


def _nnet_latgen(args, am, dev):
    """nnet-latgen-faster / nnet3-latgen-faster: the AM's pseudo-loglikes
    of the padded batch on `dev` (past each utterance's end masked), then
    `_latgen_from_loglikes` with the words of the GMM system's lang."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    model = load_gmm_system(args.model, device="cpu")
    packed = load_hclg(args.graph)
    items = list(open_rspecifier(args.rspecifier))
    feats, nf = _pad_batch(items)
    ll = np.array(am.loglikes_np(feats), np.float32)
    for b in range(len(items)):
        ll[b, nf[b]:] = -1e10
    _latgen_from_loglikes(packed, [k for (k, _f) in items], ll, nf, args,
                          dev, sym=model.lang.words.sym)


def cmd_nnet3_latgen_faster(args):
    """Hybrid nnet3 lattice-generating decode on the device
    (ref: nnet3bin/nnet3-latgen-faster.cc)."""
    dev = _device(args)
    _nnet_latgen(args, _load_am3(args.nnet, dev), dev)


# ------------------------------------------------ nnet1 (nnetbin)

def _nnet1_params(params: dict, offset: int) -> dict:
    """An nnet1 params dict with its component indexes shifted."""
    out = {}
    for name, v in params.items():
        i, leaf = name.split(".", 1)
        out[f"{int(i) + offset}.{leaf}"] = v
    return out


def cmd_nnet1_initialize(args):
    """Proto file -> randomly initialised nnet1 component stack
    (ref: nnetbin/nnet-initialize.cc); the weights come from a
    torch.Generator seeded with --seed, not JAX's key."""
    from kaldi_tpu_torch.nnet1.nnet import Nnet1, save_nnet1
    with open(args.proto) as f:
        net = Nnet1.from_proto(f.read(), device="cpu")
    params = net.init(torch.Generator().manual_seed(args.seed))
    save_nnet1(args.nnet_out, net, params)
    print(f"nnet-initialize: {len(net.components)} components, "
          f"{net.input_dim}->{net.output_dim}", file=sys.stderr)


def cmd_nnet1_info(args):
    """(ref: nnetbin/nnet-info.cc)"""
    from kaldi_tpu_torch.nnet1.nnet import load_nnet1
    net, params = load_nnet1(args.nnet, device="cpu")
    print(f"num-components {len(net.components)}")
    print(f"input-dim {net.input_dim}")
    print(f"output-dim {net.output_dim}")
    print(f"num-parameters {sum(v.numel() for v in params.values())}")
    for c in net.components:
        print(f"component {c.kind} {c.in_dim}->{c.out_dim}")


def cmd_nnet1_copy(args):
    """(ref: nnetbin/nnet-copy.cc)"""
    from kaldi_tpu_torch.nnet1.nnet import load_nnet1, save_nnet1
    save_nnet1(args.nnet_out, *load_nnet1(args.nnet_in, device="cpu"))
    print("nnet-copy: done", file=sys.stderr)


def cmd_nnet1_concat(args):
    """Stack nets front-to-back (ref: nnetbin/nnet-concat.cc)."""
    from kaldi_tpu_torch.nnet1.nnet import load_nnet1, save_nnet1
    net, params = load_nnet1(args.nnets_in[0], device="cpu")
    for p in args.nnets_in[1:]:
        n2, p2 = load_nnet1(p, device="cpu")
        params = {**params, **_nnet1_params(p2, len(net.components))}
        net = net.concat(n2)
    save_nnet1(args.nnet_out, net, params)
    print(f"nnet-concat: {len(args.nnets_in)} nets -> "
          f"{len(net.components)} components", file=sys.stderr)


def cmd_nnet1_forward(args):
    """The net on the device (ref: nnetbin/nnet-forward.cc; --apply-log
    keeps the log domain, --class-frame-counts divides by priors)."""
    from kaldi_tpu_torch.io.kaldi_io import (open_rspecifier,
                                             open_wspecifier, read_ark)
    from kaldi_tpu_torch.nnet1.nnet import load_nnet1
    dev = _device(args)
    net, params = load_nnet1(args.nnet, device=dev)
    log_prior = None
    if args.class_frame_counts:
        (cnt,) = [v for _, v in read_ark(args.class_frame_counts)]
        p = np.asarray(cnt, np.float64) + 0.5
        log_prior = np.log(p / p.sum())
    n = 0
    with open_wspecifier(args.wspecifier) as out, torch.inference_mode():
        for k, f in open_rspecifier(args.rspecifier):
            y = _to_host(net.apply(params, torch.as_tensor(
                f, dtype=torch.float32, device=dev)))
            if log_prior is not None:
                y = y - log_prior
            if not args.apply_log:
                y = np.exp(y)
            out.write(k, y.astype(np.float32))
            n += 1
    print(f"nnet-forward: {n} utts", file=sys.stderr)


def cmd_nnet1_train_frmshuff(args):
    """Frame-shuffled xent SGD over features + pdf alignments on the
    device (ref: nnetbin/nnet-train-frmshuff.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.nnet1.nnet import (load_nnet1, save_nnet1,
                                            train_frmshuff)
    dev = _device(args)
    net, params = load_nnet1(args.nnet_in, device=dev)
    feats = {k: v for (k, v) in open_rspecifier(args.rspecifier)}
    X, T = [], []
    for utt, ali in open_rspecifier(args.targets_rspecifier):
        if utt not in feats:
            continue
        n = min(len(ali), feats[utt].shape[0])
        X.append(feats[utt][:n])
        T.append(np.asarray(ali[:n], np.int64))
    X = np.concatenate(X).astype(np.float32)
    T = np.concatenate(T)
    params, hist = train_frmshuff(
        net, params, torch.as_tensor(X, device=dev),
        torch.as_tensor(T, device=dev), learn_rate=args.learn_rate,
        minibatch=args.minibatch_size, num_epochs=args.num_epochs,
        momentum=args.momentum, seed=args.seed)
    save_nnet1(args.nnet_out, net, params)
    print(f"nnet-train-frmshuff: {len(X)} frames, final loss "
          f"{hist[-1][0]:.3f} acc {hist[-1][1]:.3f}", file=sys.stderr)


def cmd_rbm_train_cd1_frmshuff(args):
    """CD-1 RBM pretraining over pooled frames on the device (ref:
    nnetbin/rbm-train-cd1-frmshuff.cc). The weights start from JAX's
    numpy draw; the hidden samples come from a torch.Generator on the
    device seeded with --seed (JAX draws them from its key)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.nnet1.rbm import Rbm, RbmConfig
    from kaldi_tpu_torch.nnet1.train import FrameShuffler
    dev = _device(args)
    X = np.concatenate([v for (_k, v) in
                        open_rspecifier(args.rspecifier)]).astype(np.float32)
    rbm = Rbm(RbmConfig(visible_dim=X.shape[1], hidden_dim=args.hidden_dim,
                        learning_rate=args.learn_rate), seed=args.seed,
              device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    Xd = torch.as_tensor(X, device=dev)
    mse = 0.0
    for ep in range(args.num_epochs):
        shuf = FrameShuffler(Xd, np.zeros(len(X), np.int32),
                             args.minibatch_size, seed=args.seed + ep)
        for x, _t in shuf:
            mse = rbm.cd1_step(x, gen)
    with open(args.rbm_out, "wb") as f:
        np.savez(f, W=_to_host(rbm.W), vis_bias=_to_host(rbm.vis_bias),
                 hid_bias=_to_host(rbm.hid_bias))
    print(f"rbm-train-cd1-frmshuff: final mse {mse:.4f}", file=sys.stderr)


def cmd_rbm_convert_to_nnet(args):
    """RBM -> AffineTransform+Sigmoid stack
    (ref: nnetbin/rbm-convert-to-nnet.cc)."""
    from kaldi_tpu_torch.nnet1.nnet import Component, Nnet1, save_nnet1
    z = np.load(args.rbm)
    W, b = z["W"], z["hid_bias"]
    H, V = W.shape
    net = Nnet1([Component("AffineTransform", V, H),
                 Component("Sigmoid", H, H)], device="cpu")
    save_nnet1(args.nnet_out, net, {"0.w": torch.as_tensor(W),
                                    "0.b": torch.as_tensor(b)})
    print(f"rbm-convert-to-nnet: {V}->{H}", file=sys.stderr)


def cmd_cmvn_to_nnet(args):
    """Global CMVN stats -> AddShift+Rescale front components
    (ref: nnetbin/cmvn-to-nnet.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.nnet1.nnet import Component, Nnet1, save_nnet1
    # sum all stats entries (per-spk or global)
    total = None
    for _k, st in open_rspecifier(args.cmvn_rspecifier):
        total = st if total is None else total + st
    st = np.asarray(total, np.float64)
    cnt = st[0, -1]
    mean = st[0, :-1] / cnt
    var = st[1, :-1] / cnt - mean ** 2
    D = len(mean)
    net = Nnet1([Component("AddShift", D, D), Component("Rescale", D, D)],
                device="cpu")
    save_nnet1(args.nnet_out, net, {
        "0.b": torch.as_tensor((-mean).astype(np.float32)),
        "1.s": torch.as_tensor((1.0 / np.sqrt(np.maximum(var, 1e-10)))
                               .astype(np.float32))})
    print(f"cmvn-to-nnet: dim {D}", file=sys.stderr)


def cmd_transf_to_nnet(args):
    """Linear/affine transform matrix -> AffineTransform component
    (ref: nnetbin/transf-to-nnet.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    from kaldi_tpu_torch.nnet1.nnet import Component, Nnet1, save_nnet1
    (M,) = [v for _, v in read_ark(args.transform)]
    M = np.asarray(M, np.float64)
    out_dim, in_cols = M.shape
    if args.affine or in_cols == out_dim + 1:
        W, b = M[:, :-1], M[:, -1]
    else:
        W, b = M, np.zeros(out_dim)
    net = Nnet1([Component("AffineTransform", W.shape[1], out_dim)],
                device="cpu")
    save_nnet1(args.nnet_out, net, {
        "0.w": torch.as_tensor(W.astype(np.float32)),
        "0.b": torch.as_tensor(b.astype(np.float32))})
    print(f"transf-to-nnet: {W.shape[1]}->{out_dim}", file=sys.stderr)


def cmd_nnet_kl_hmm_acc(args):
    """Accumulate KL-HMM state distributions from posterior features +
    state alignments (ref: nnetbin/nnet-kl-hmm-acc.cc); host counts."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.nnet1.kl_hmm import KlHmm
    feats = {k: v for (k, v) in open_rspecifier(args.rspecifier)}
    kl = None
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        if utt not in feats:
            continue
        f = np.asarray(feats[utt], np.float64)
        a = np.asarray(ali, np.int64)
        n = min(len(f), len(a))
        if kl is None:
            kl = KlHmm(f.shape[1], args.num_states)
        kl.accumulate(f[:n], a[:n])
    with open(args.accs_out, "wb") as f:
        np.savez(f, counts=kl.counts)
    print(f"nnet-kl-hmm-acc: {int(kl.counts.sum())} total mass",
          file=sys.stderr)


def cmd_nnet_kl_hmm_sum_accs(args):
    """(ref: nnetbin/nnet-kl-hmm-sum-accs.cc)"""
    total = None
    for p in args.accs_in:
        c = np.load(p)["counts"]
        total = c if total is None else total + c
    with open(args.accs_out, "wb") as f:
        np.savez(f, counts=total)
    print(f"nnet-kl-hmm-sum-accs: {len(args.accs_in)} files",
          file=sys.stderr)


# ------------------------------------------------ nnet2 egs (nnet2bin)

def _read_egs_dir(egs_dir):
    """-> egs dict {feats, targets, weights} concatenated over archives
    (weights.<a>.ark read when present, else all-ones)."""
    import glob as _glob
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    feats, targets, weights = [], [], []
    for p in sorted(_glob.glob(os.path.join(egs_dir, "egs.*.ark"))):
        a = p.rsplit("egs.", 1)[1].split(".ark")[0]
        targ = dict(read_ark(os.path.join(egs_dir, f"targets.{a}.ark")))
        wpath = os.path.join(egs_dir, f"weights.{a}.ark")
        wts = dict(read_ark(wpath)) if os.path.exists(wpath) else {}
        for k, x in read_ark(p):
            feats.append(x)
            targets.append(targ[k].astype(np.int32))
            weights.append(np.asarray(wts[k], np.float32).reshape(-1)
                           if k in wts else None)
    if not feats:
        raise SystemExit(f"no egs archives under {egs_dir}")
    f = np.stack(feats)
    t = np.stack(targets)
    w = np.stack([np.ones(t.shape[1], np.float32) if x is None else x
                  for x in weights])
    return {"feats": f, "targets": t, "weights": w}


def cmd_nnet_get_egs(args):
    """Dump frame-chunk training examples with context to randomized
    archives (ref: nnet2bin/nnet-get-egs.cc + steps/nnet2/get_egs2.sh)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.steps.egs import dump_egs
    tm = load_gmm_system(args.model, device="cpu").trans_model
    feats = {k: v for (k, v) in open_rspecifier(args.rspecifier)}
    aligned, utt_names = [], []
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        if utt in feats:
            tids = np.asarray(ali, np.int64)
            aligned.append((feats[utt].astype(np.float32),
                            tm.id2pdf_array[tids]))
            utt_names.append(utt)
    n = dump_egs(aligned, args.left_context, args.right_context,
                 args.chunk, args.egs_dir,
                 num_archives=args.num_archives,
                 compress=not args.no_compress, seed=args.seed,
                 utt_names=utt_names)
    print(f"nnet-get-egs: {len(aligned)} utts -> {n} archives",
          file=sys.stderr)


def _rewrite_egs(in_dir, out_dir, transform, num_archives, seed):
    """Shared egs-archive rewriter: reads all (feats, target) examples,
    applies `transform(examples, rng) -> examples`, writes round-robin
    into num_archives archives."""
    import glob as _glob
    from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark
    rng = np.random.RandomState(seed)
    examples = []
    have_weights = False
    for p in sorted(_glob.glob(os.path.join(in_dir, "egs.*.ark"))):
        a = p.rsplit("egs.", 1)[1].split(".ark")[0]
        targ = dict(read_ark(os.path.join(in_dir, f"targets.{a}.ark")))
        wpath = os.path.join(in_dir, f"weights.{a}.ark")
        wts = dict(read_ark(wpath)) if os.path.exists(wpath) else {}
        have_weights = have_weights or bool(wts)
        for k, x in read_ark(p):
            examples.append((k, x, targ[k], wts.get(k)))
    examples = transform(examples, rng)
    os.makedirs(out_dir, exist_ok=True)
    buckets = [[] for _ in range(num_archives)]
    for i, ex in enumerate(examples):
        buckets[i % num_archives].append(ex)
    for a, items in enumerate(buckets):
        write_ark(os.path.join(out_dir, f"egs.{a}.ark"),
                  {k: x for (k, x, _y, _w) in items})
        write_ark(os.path.join(out_dir, f"targets.{a}.ark"),
                  {k: y for (k, _x, y, _w) in items})
        if have_weights:
            write_ark(os.path.join(out_dir, f"weights.{a}.ark"),
                      {k: w for (k, _x, _y, w) in items
                       if w is not None})
    return len(examples)


def cmd_nnet_copy_egs(args):
    """Redistribute egs across archives (ref: nnet2bin/nnet-copy-egs.cc)."""
    n = _rewrite_egs(args.egs_in, args.egs_out, lambda ex, rng: ex,
                     args.num_archives, args.seed)
    print(f"nnet-copy-egs: {n} examples -> {args.num_archives} archives",
          file=sys.stderr)


def cmd_nnet_shuffle_egs(args):
    """(ref: nnet2bin/nnet-shuffle-egs.cc)"""
    def shuf(ex, rng):
        order = rng.permutation(len(ex))
        return [ex[i] for i in order]
    n = _rewrite_egs(args.egs_in, args.egs_out, shuf,
                     args.num_archives, args.seed)
    print(f"nnet-shuffle-egs: {n} examples", file=sys.stderr)


def cmd_nnet_subset_egs(args):
    """(ref: nnet2bin/nnet-subset-egs.cc)"""
    def take(ex, rng):
        if args.randomize:
            order = rng.permutation(len(ex))[: args.n]
            return [ex[i] for i in sorted(order)]
        return ex[: args.n]
    n = _rewrite_egs(args.egs_in, args.egs_out, take, 1, args.seed)
    print(f"nnet-subset-egs: kept {n}", file=sys.stderr)


# ------------------------------------------ nnet2 models (nnet2bin)

def cmd_nnet_am_init(args):
    """Random-init a multisplice TDNN AmNnet sized to a GMM system's pdf
    count (ref: nnet2bin/nnet-am-init.cc + nnet-init); the weights come
    from a torch.Generator seeded with --seed, not JAX's key."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_am_nnet
    from kaldi_tpu_torch.nnet.am_nnet import AmNnet
    from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
    model = load_gmm_system(args.model, device="cpu")
    _k, f0 = next(iter(open_rspecifier(args.rspecifier)))
    splice = tuple(tuple(int(t) for t in grp.split(","))
                   for grp in args.splice_indexes.split(";"))
    cfg = TdnnConfig(feat_dim=f0.shape[1], num_pdfs=model.am.num_pdfs,
                     splice_indexes=splice, hidden_dim=args.hidden_dim,
                     pnorm_output_dim=args.pnorm_output_dim,
                     nonlinearity=args.nonlinearity)
    net = Tdnn(cfg, device="cpu")
    net.init(torch.Generator().manual_seed(args.seed))
    save_am_nnet(args.nnet_out, AmNnet(net))
    print(f"nnet-am-init: {cfg.num_pdfs} pdfs, "
          f"{len(cfg.splice_indexes)} layers", file=sys.stderr)


def cmd_nnet_train_simple(args):
    """SGD over an egs dir, one process, on the device
    (ref: nnet2bin/nnet-train-simple.cc)."""
    from kaldi_tpu_torch.io.model_io import save_am_nnet
    from kaldi_tpu_torch.nnet.train import NnetTrainOpts, train_epochs
    dev = _device(args)
    am = cli_nnet._load_am(args.nnet_in, dev)
    egs = _read_egs_dir(args.egs_dir)
    params, history = train_epochs(
        am.model, am.model.params(), egs,
        NnetTrainOpts(initial_lr=args.initial_lr, final_lr=args.final_lr,
                      num_epochs=args.num_epochs,
                      minibatch_size=args.minibatch_size,
                      momentum=args.momentum), device=dev)
    save_am_nnet(args.nnet_out, am.replace_params(params))
    if history:
        print(f"nnet-train-simple: final loss {history[-1][2]:.3f} "
              f"acc {history[-1][3]:.3f}", file=sys.stderr)


def cmd_nnet_am_info(args):
    """(ref: nnet2bin/nnet-am-info.cc)"""
    am = cli_nnet._load_am(args.nnet)
    cfg = am.model.config
    print(f"num-components {len(cfg.splice_indexes) + 1}")
    print(f"num-pdfs {cfg.num_pdfs}")
    print(f"input-dim {cfg.feat_dim}")
    print(f"left-context {cfg.left_context}")
    print(f"right-context {cfg.right_context}")
    print(f"num-parameters {am.model.num_params()}")
    for i, ctx in enumerate(cfg.splice_indexes):
        print(f"layer {i} splice {list(ctx)} hidden {cfg.hidden_dim} "
              f"({cfg.nonlinearity})")


def cmd_nnet_am_copy(args):
    """(ref: nnet2bin/nnet-am-copy.cc)"""
    from kaldi_tpu_torch.io.model_io import save_am_nnet
    save_am_nnet(args.nnet_out, cli_nnet._load_am(args.nnet_in))
    print("nnet-am-copy: done", file=sys.stderr)


def cmd_nnet_am_average(args):
    """Average parameters of N models (ref: nnet2bin/nnet-am-average.cc —
    the reduce step of parallel-SGD-with-model-averaging)."""
    from kaldi_tpu_torch.io.model_io import save_am_nnet
    ams = [cli_nnet._load_am(p) for p in args.nnets_in]
    out = ams[0].replace_params(
        _average_trees([cli_nnet._tree(a) for a in ams]))
    out.priors = np.mean([a.priors for a in ams], axis=0)
    save_am_nnet(args.nnet_out, out)
    print(f"nnet-am-average: {len(ams)} models", file=sys.stderr)


def cmd_nnet_combine_fast(args):
    """Validation-loss-optimal model combination, fitted on the device
    (ref: nnet2bin/nnet-combine-fast.cc)."""
    from kaldi_tpu_torch.io.model_io import save_am_nnet
    from kaldi_tpu_torch.nnet.combine import combine_params
    from kaldi_tpu_torch.nnet.train import cross_entropy_loss
    dev = _device(args)
    ams = [cli_nnet._load_am(p, dev) for p in args.nnets_in]
    feats, targets, weights = _egs_tensors(_read_egs_dir(args.valid_egs),
                                           dev)
    model = ams[0].model

    def loss_fn(params):
        return cross_entropy_loss(model, params, feats, targets,
                                  weights)[0]

    params, final_loss = combine_params(
        [a.model.params() for a in ams], loss_fn, num_steps=args.num_steps)
    save_am_nnet(args.nnet_out, ams[0].replace_params(params))
    print(f"nnet-combine-fast: {len(ams)} models, valid loss "
          f"{final_loss:.4f}", file=sys.stderr)


def cmd_nnet_adjust_priors(args):
    """priors := average posterior over held-out features, the forward on
    the device (ref: nnet2bin/nnet-adjust-priors.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import save_am_nnet
    am = cli_nnet._load_am(args.nnet_in, _device(args))
    am.set_priors_from_posteriors(
        f.astype(np.float32)[None]
        for (_k, f) in open_rspecifier(args.rspecifier))
    save_am_nnet(args.nnet_out, am)
    print(f"nnet-adjust-priors: prior entropy "
          f"{-np.sum(am.priors * np.log(np.maximum(am.priors, 1e-20))):.3f}",
          file=sys.stderr)


def cmd_nnet_latgen_faster(args):
    """Hybrid nnet2 lattice-generating decode on the device
    (ref: nnet2bin/nnet-latgen-faster.cc)."""
    dev = _device(args)
    _nnet_latgen(args, cli_nnet._load_am(args.nnet, dev), dev)


# ---------------------------------------------- speaker recognition (5a)

def cmd_compute_eer(args):
    """(ref: ivectorbin/compute-eer.cc — scores file: '<score> target' or
    '<score> nontarget' per line)."""
    from kaldi_tpu_torch.ivector.metrics import compute_eer
    tgt, non = [], []
    with open(args.scores) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            (tgt if parts[1] == "target" else non).append(float(parts[0]))
    eer, thresh = compute_eer(tgt, non)
    print(f"EER {eer * 100:.4f}% at threshold {thresh:.6f}")


def cmd_train_ubm(args):
    """Diagonal (and optionally full-covariance) UBM from pooled feats,
    each EM pass's statistics on the device (ref: sid/train_diag_ubm.sh +
    train_full_ubm.sh driving gmm-global-* / fgmm-global-*)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import save_ubm
    from kaldi_tpu_torch.steps.ubm import (DiagUbmTrainOpts,
                                           FullUbmTrainOpts, train_diag_ubm,
                                           train_full_ubm)
    dev = _device(args)
    pooled = np.concatenate([v for (_k, v) in
                             open_rspecifier(args.rspecifier)])
    ubm = train_diag_ubm(pooled.astype(np.float64),
                         DiagUbmTrainOpts(num_gauss=args.num_gauss,
                                          num_iters=args.num_iters),
                         device=dev)
    if args.full:
        ubm = train_full_ubm(ubm, pooled.astype(np.float64),
                             FullUbmTrainOpts(num_iters=args.full_iters),
                             device=dev)
    save_ubm(args.ubm_out, ubm)
    print(f"train-ubm: {args.num_gauss} gauss "
          f"({'full' if args.full else 'diag'}) over {len(pooled)} frames",
          file=sys.stderr)


def cmd_train_ivector_extractor(args):
    """EM over the utterances' statistics on the device
    (ref: sid/train_ivector_extractor.sh / ivector-extractor-est)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_ubm, save_ivector_extractor
    from kaldi_tpu_torch.ivector.extractor import train_ivector_extractor
    dev = _device(args)
    ubm = load_ubm(args.ubm)
    feats = [v.astype(np.float64)
             for (_k, v) in open_rspecifier(args.rspecifier)]
    ext = train_ivector_extractor(
        ubm, feats, ivector_dim=args.ivector_dim,
        num_iters=args.num_iters, num_gselect=args.num_gselect, device=dev)
    save_ivector_extractor(args.extractor_out, ext)
    print(f"train-ivector-extractor: dim {args.ivector_dim} over "
          f"{len(feats)} utts", file=sys.stderr)


def _ivector_stats(ext, rspecifier, num_gselect, dev):
    """-> (keys, gamma [N, I], X [N, I, D]): every utterance's
    gselect-pruned zeroth and first-order statistics, f64 on `dev`."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    keys, feats = [], []
    for utt, v in open_rspecifier(rspecifier):
        keys.append(utt)
        feats.append(v.astype(np.float64))
    gamma, X = ext.batch_stats(feats, num_gselect, device=dev)
    return keys, gamma, X


def cmd_ivector_extract(args):
    """Per-utterance (or per-speaker with --spk2utt) i-vectors, the
    statistics and the posterior solves batched on the device
    (ref: ivectorbin/ivector-extract.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_ivector_extractor
    from kaldi_tpu_torch.ivector.extractor import BATCH
    dev = _device(args)
    ext = load_ivector_extractor(args.extractor)
    spk2utt = None
    if args.spk2utt:
        spk2utt = {}
        with open(args.spk2utt) as f:
            for line in f:
                parts = line.split()
                spk2utt[parts[0]] = parts[1:]
    keys, gamma, X = _ivector_stats(ext, args.rspecifier, args.num_gselect,
                                    dev)
    if spk2utt is not None:
        row = {k: i for i, k in enumerate(keys)}
        keys = list(spk2utt)
        idx = [[row[u] for u in utts if u in row]
               for utts in spk2utt.values()]
        gamma = torch.stack([gamma[i].sum(0) if i else gamma.new_zeros(
            gamma.shape[1:]) for i in idx])
        X = torch.stack([X[i].sum(0) if i else X.new_zeros(X.shape[1:])
                         for i in idx])
    w = [ext.posterior_batch(gamma[i:i + BATCH], X[i:i + BATCH])[0]
         for i in range(0, len(keys), BATCH)]
    w = _to_host(torch.cat(w)) if w else np.zeros((0, ext.ivector_dim))
    with open_wspecifier(args.wspecifier) as out:
        for key, v in zip(keys, w):
            out.write(key, v.astype(np.float32))
    print(f"ivector-extract: {len(keys)} i-vectors", file=sys.stderr)


def cmd_ivector_extractor_init(args):
    """Default-init a T-matrix extractor from a UBM
    (ref: ivectorbin/ivector-extractor-init.cc)."""
    from kaldi_tpu_torch.io.model_io import load_ubm, save_ivector_extractor
    from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
    ubm = load_ubm(args.ubm)
    ext = IvectorExtractor(ubm, args.ivector_dim,
                           prior_offset=args.prior_offset, seed=args.seed)
    save_ivector_extractor(args.extractor_out, ext)
    print(f"ivector-extractor-init: dim {args.ivector_dim}, "
          f"{ext.M.shape[0]} gauss", file=sys.stderr)


def cmd_ivector_extractor_acc_stats(args):
    """The E-step's statistics A and B, batched on the device
    (ref: ivectorbin/ivector-extractor-acc-stats.cc)."""
    from kaldi_tpu_torch.io.model_io import load_ivector_extractor
    from kaldi_tpu_torch.ivector.extractor import BATCH, IvectorStats
    dev = _device(args)
    ext = load_ivector_extractor(args.extractor)
    _keys, gamma, X = _ivector_stats(ext, args.rspecifier,
                                     args.num_gselect, dev)
    st = IvectorStats(ext, dev)
    for i in range(0, len(gamma), BATCH):
        st.accumulate_batch(ext, gamma[i:i + BATCH], X[i:i + BATCH])
    with open(args.accs_out, "wb") as f:
        np.savez(f, A=_to_host(st.A), B=_to_host(st.B),
                 count=np.float64(st.count))
    print(f"ivector-extractor-acc-stats: {int(st.count)} utts",
          file=sys.stderr)


def cmd_ivector_extractor_sum_accs(args):
    """(ref: ivectorbin/ivector-extractor-sum-accs.cc)"""
    A, B, count = None, None, 0.0
    for p in args.accs_in:
        z = np.load(p)
        A = z["A"] if A is None else A + z["A"]
        B = z["B"] if B is None else B + z["B"]
        count += float(z["count"])
    with open(args.accs_out, "wb") as f:
        np.savez(f, A=A, B=B, count=np.float64(count))
    print(f"ivector-extractor-sum-accs: {len(args.accs_in)} files",
          file=sys.stderr)


def cmd_ivector_extractor_est(args):
    """M-step, a batched Cholesky solve on the device
    (ref: ivectorbin/ivector-extractor-est.cc)."""
    from kaldi_tpu_torch.io.model_io import (load_ivector_extractor,
                                             save_ivector_extractor)
    from kaldi_tpu_torch.ivector.extractor import IvectorStats
    dev = _device(args)
    ext = load_ivector_extractor(args.extractor)
    z = np.load(args.accs)
    st = IvectorStats(ext, dev)
    st.A = torch.as_tensor(z["A"], dtype=torch.float64, device=dev)
    st.B = torch.as_tensor(z["B"], dtype=torch.float64, device=dev)
    st.count = float(z["count"])
    st.update(ext)
    save_ivector_extractor(args.extractor_out, ext)
    print(f"ivector-extractor-est: updated from {int(st.count)} utts",
          file=sys.stderr)


def cmd_ivector_compute_lda(args):
    """LDA projection for i-vectors from speaker labels
    (ref: ivectorbin/ivector-compute-lda.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
    from kaldi_tpu_torch.transform.lda import LdaStats, estimate_lda
    utt2spk = _read_utt2spk(args.utt2spk)
    ivecs = [(utt2spk.get(k, k), np.asarray(v, np.float64))
             for (k, v) in open_rspecifier(args.rspecifier)]
    spks = sorted({s for (s, _v) in ivecs})
    spk_id = {s: i for i, s in enumerate(spks)}
    stats = LdaStats(len(spks), ivecs[0][1].size)
    for (s, v) in ivecs:
        stats.accumulate(v[None, :], np.array([spk_id[s]]))
    M, _evals = estimate_lda(stats, args.dim)
    write_ark(args.matrix_out, {"lda": np.asarray(M, np.float32)})
    print(f"ivector-compute-lda: {M.shape[0]}x{M.shape[1]} from "
          f"{len(spks)} speakers", file=sys.stderr)


def cmd_ivector_compute_dot_products(args):
    """Cosine scoring of trials (ref:
    ivectorbin/ivector-compute-dot-products.cc; trials lines
    '<key1> <key2>')."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    vecs = {k: np.asarray(v, np.float64)
            for (k, v) in open_rspecifier(args.rspecifier)}
    with open(args.trials) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            a, b = parts[0], parts[1]
            if a not in vecs or b not in vecs:
                continue
            va, vb = vecs[a], vecs[b]
            score = float(va @ vb / (np.linalg.norm(va)
                                     * np.linalg.norm(vb) + 1e-20))
            print(f"{a} {b} {score:.6f}")


def cmd_ivector_adapt_plda(args):
    """Unsupervised PLDA domain adaptation from unlabeled i-vectors
    (ref: ivectorbin/ivector-adapt-plda.cc,
    plda.h PldaUnsupervisedAdaptor)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_plda, save_plda
    from kaldi_tpu_torch.ivector.plda import length_normalize
    plda = load_plda(args.plda)
    xs = np.stack([length_normalize(np.asarray(v, np.float64))
                   for (_k, v) in open_rspecifier(args.rspecifier)])
    adapted = plda.adapt(
        xs, mean_diff_scale=args.mean_diff_scale,
        within_covar_scale=args.within_covar_scale,
        between_covar_scale=args.between_covar_scale)
    save_plda(args.plda_out, adapted)
    print(f"ivector-adapt-plda: {len(xs)} adaptation vectors",
          file=sys.stderr)


def cmd_ivector_copy_plda(args):
    """(ref: ivectorbin/ivector-copy-plda.cc; --smoothing scales psi)"""
    from kaldi_tpu_torch.io.model_io import load_plda, save_plda
    plda = load_plda(args.plda)
    if args.smoothing > 0:
        # between-class smoothing: psi <- psi + s * mean(psi)
        plda.psi = plda.psi + args.smoothing * float(np.mean(plda.psi))
    save_plda(args.plda_out, plda)
    print("ivector-copy-plda: done", file=sys.stderr)


def cmd_train_plda(args):
    """(ref: ivectorbin/ivector-compute-plda.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import save_plda
    from kaldi_tpu_torch.ivector.plda import (Plda, PldaStats,
                                              length_normalize)
    spk2utt = {}
    with open(args.spk2utt) as f:
        for line in f:
            parts = line.split()
            spk2utt[parts[0]] = parts[1:]
    ivecs = dict(open_rspecifier(args.rspecifier))
    dim = next(iter(ivecs.values())).shape[-1]
    stats = PldaStats(dim)
    for _spk, utts in spk2utt.items():
        rows = [length_normalize(ivecs[u]) for u in utts if u in ivecs]
        if rows:
            stats.add_speaker(np.stack(rows))
    plda = Plda.train(stats, num_iters=args.num_iters)
    save_plda(args.plda_out, plda)
    print(f"train-plda: {len(spk2utt)} speakers, dim {dim}",
          file=sys.stderr)


def cmd_ivector_plda_scoring(args):
    """Trial scoring: LLR per (enroll, test) pair, each i-vector
    length-normalized and transformed once, as `Plda.score_trials` does
    per pair (ref: ivectorbin/ivector-plda-scoring.cc; trials file lines
    '<enroll-key> <test-key>')."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_plda
    from kaldi_tpu_torch.ivector.plda import length_normalize
    plda = load_plda(args.plda)
    raw = (dict(open_rspecifier(args.enroll_rspecifier)),
           dict(open_rspecifier(args.test_rspecifier)))
    done: tuple = ({}, {})

    def prep(side, key):
        if key not in done[side]:
            done[side][key] = plda.transform_ivector(length_normalize(
                np.asarray(raw[side][key], np.float64)))
        return done[side][key]

    out = open(args.scores_out, "w") if args.scores_out else sys.stdout
    n = 0
    with open(args.trials) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            e, t = parts[0], parts[1]
            s = plda.llr(prep(0, e), 1, prep(1, t))
            out.write(f"{e} {t} {s:.6f}\n")
            n += 1
    if args.scores_out:
        out.close()
    print(f"ivector-plda-scoring: {n} trials", file=sys.stderr)


def cmd_ivector_extract_online2(args):
    """Streaming per-frame i-vectors from a feature ark, the host copy of
    the online extractor (ref: online2bin/ivector-extract-online2.cc —
    writes, every ivector-period frames, the i-vector estimated from
    stats so far; speaker adaptation state carries across an
    utt2spk-grouped stream)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_ivector_extractor
    from kaldi_tpu_torch.online.ivector import (OnlineIvectorConfig,
                                                OnlineIvectorFeature)
    ext = load_ivector_extractor(args.extractor)
    cfg = OnlineIvectorConfig(ivector_period=args.ivector_period,
                              num_gselect=args.num_gselect,
                              use_most_recent_ivector=False)
    utt2spk = _read_utt2spk(args.utt2spk)
    spk_state: dict = {}
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, feats in open_rspecifier(args.rspecifier):
            spk = utt2spk.get(utt, utt)
            iv = OnlineIvectorFeature(ext, cfg,
                                      adaptation_state=spk_state.get(spk))
            T = feats.shape[0]
            f64 = np.asarray(feats, np.float64)
            rows = []
            # each period's i-vector uses only the statistics so far
            for lo in range(0, T, args.ivector_period):
                hi = min(T, lo + args.ivector_period)
                iv.accept_features(f64[lo:hi])
                rows.extend(iv.get_frame(t) for t in range(lo, hi))
            out.write(utt, np.stack(rows).astype(np.float32))
            spk_state[spk] = iv.get_adaptation_state()
            n += 1
    print(f"ivector-extract-online2: {n} utterances", file=sys.stderr)


def cmd_ivector_mean(args):
    """Average vectors: with --spk2utt, one mean per speaker; otherwise
    a single global mean under key 'mean'
    (ref: ivectorbin/ivector-mean.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    vecs = {k: np.asarray(v, np.float64)
            for (k, v) in open_rspecifier(args.rspecifier)}
    with open_wspecifier(args.wspecifier) as out:
        if args.spk2utt:
            with open(args.spk2utt) as f:
                for line in f:
                    parts = line.split()
                    spk, utts = parts[0], [u for u in parts[1:]
                                           if u in vecs]
                    if not utts:
                        continue
                    out.write(spk, np.mean([vecs[u] for u in utts],
                                           axis=0).astype(np.float32))
        else:
            out.write("mean", np.mean(list(vecs.values()),
                                      axis=0).astype(np.float32))
    print(f"ivector-mean: {len(vecs)} vectors in", file=sys.stderr)


def cmd_ivector_normalize_length(args):
    """Scale each vector to length sqrt(dim)
    (ref: ivectorbin/ivector-normalize-length.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    ratios = []
    with open_wspecifier(args.wspecifier) as out:
        for key, v in open_rspecifier(args.rspecifier):
            v = np.asarray(v, np.float64)
            ratio = np.linalg.norm(v) / np.sqrt(v.size)
            ratios.append(ratio)
            if not args.scaleup and ratio < 1.0:
                ratio = 1.0   # --scaleup=false: only shrink long vectors
            out.write(key, (v / max(ratio, 1e-20)).astype(np.float32))
    print(f"ivector-normalize-length: {len(ratios)} vectors, avg ratio "
          f"{np.mean(ratios):.4f}", file=sys.stderr)


def cmd_ivector_subtract_global_mean(args):
    """Subtract the mean of all input vectors (or a precomputed one via
    --mean) (ref: ivectorbin/ivector-subtract-global-mean.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import (open_rspecifier, open_wspecifier,
                                             read_ark)
    items = [(k, np.asarray(v, np.float64))
             for (k, v) in open_rspecifier(args.rspecifier)]
    if args.mean:
        mean = np.asarray(next(iter(dict(read_ark(args.mean)).values())),
                          np.float64)
    else:
        mean = np.mean([v for (_k, v) in items], axis=0)
    with open_wspecifier(args.wspecifier) as out:
        for k, v in items:
            out.write(k, (v - mean).astype(np.float32))
    print(f"ivector-subtract-global-mean: {len(items)} vectors",
          file=sys.stderr)


def cmd_logistic_regression_train(args):
    """Multiclass logistic regression on vectors (e.g. language-id on
    i-vectors), its Adam steps on the device
    (ref: ivectorbin/logistic-regression-train.cc). utt2label: text file
    'utt label'; class names are stored with the model."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.ivector.logistic_regression import (
        LogisticRegression, LogisticRegressionConfig)
    dev = _device(args)
    labels_txt = _read_utt2spk(args.utt2label)
    X, y, classes = [], [], {}
    for utt, v in open_rspecifier(args.rspecifier):
        if utt not in labels_txt:
            continue
        lab = labels_txt[utt]
        classes.setdefault(lab, len(classes))
        X.append(np.asarray(v, np.float32))
        y.append(classes[lab])
    lr = LogisticRegression()
    loss = lr.train(np.stack(X), np.asarray(y, np.int32),
                    LogisticRegressionConfig(max_steps=args.max_steps,
                                             normalizer=args.normalizer),
                    device=dev)
    names = [c for c, _i in sorted(classes.items(), key=lambda kv: kv[1])]
    with open(args.model_out, "wb") as f:
        np.savez(f, weights=lr.weights,
                 classes=np.frombuffer(
                     "\n".join(names).encode(), dtype=np.uint8))
    print(f"logistic-regression-train: {len(X)} examples, "
          f"{len(classes)} classes, final loss {loss:.4f}",
          file=sys.stderr)


def cmd_logistic_regression_eval(args):
    """Log-posteriors (and argmax class) of vectors under a trained
    model, host numpy as in JAX
    (ref: ivectorbin/logistic-regression-eval.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.ivector.logistic_regression import LogisticRegression
    z = np.load(args.model)
    lr = LogisticRegression(z["weights"])
    names = z["classes"].tobytes().decode().split("\n")
    n_correct, n_tot = 0, 0
    truth = _read_utt2spk(args.utt2label) if args.utt2label else {}
    with open_wspecifier(args.wspecifier) as out:
        for utt, v in open_rspecifier(args.rspecifier):
            lp = lr.log_posteriors(np.asarray(v, np.float32)[None])[0]
            out.write(utt, lp.astype(np.float32))
            if utt in truth:
                n_tot += 1
                n_correct += int(names[int(np.argmax(lp))] == truth[utt])
    if n_tot:
        print(f"logistic-regression-eval: accuracy "
              f"{n_correct / n_tot:.4f} over {n_tot}", file=sys.stderr)


def cmd_logistic_regression_copy(args):
    """(ref: ivectorbin/logistic-regression-copy.cc)"""
    z = dict(np.load(args.model).items())
    with open(args.model_out, "wb") as f:
        np.savez(f, **z)
    print("logistic-regression-copy: done", file=sys.stderr)


def cmd_copy_gselect(args):
    """(ref: bin/copy-gselect.cc)"""
    n = 0
    with open(args.gselect_out, "w") as out:
        with open(args.gselect_in) as f:
            for line in f:
                out.write(line)
                n += 1
    print(f"copy-gselect: {n} utts", file=sys.stderr)


def cmd_fgmm_global_to_gmm(args):
    """Full-covariance UBM -> diagonal (keep the covar diagonal)
    (ref: fgmmbin/fgmm-global-to-gmm.cc)."""
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.io.model_io import load_ubm, save_ubm
    ubm = load_ubm(args.model)
    assert isinstance(ubm, FullGmm), "input must be a full-cov UBM"
    variances = np.stack([np.diag(c) for c in ubm.covars])
    save_ubm(args.model_out,
             DiagGmm(ubm.weights.copy(), ubm.means.copy(), variances))
    print(f"fgmm-global-to-gmm: {ubm.num_gauss} gauss", file=sys.stderr)


# ------------------------------------------------------------ LDA / MLLT

def cmd_acc_lda(args):
    """LDA class stats (class = pdf) from weighted posteriors
    (ref: bin/acc-lda.cc, transform/lda-estimate.h:57)."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.lda import LdaStats
    model = load_gmm_system(args.model, device="cpu")
    tm = model.trans_model
    feats = dict(open_rspecifier(args.rspecifier))
    stats = None
    n = 0
    for utt, post in read_post_ark(args.post_in):
        if utt not in feats:
            continue
        x = feats[utt]
        if stats is None:
            stats = LdaStats(model.am.num_pdfs, x.shape[1])
        rows, classes, ws = [], [], []
        for t, frame in enumerate(post):
            for tid, w in frame:
                rows.append(t)
                classes.append(tm.transition_id_to_pdf(tid))
                ws.append(w)
        stats.accumulate(x[np.asarray(rows)],
                         np.asarray(classes, np.int64),
                         np.asarray(ws, np.float64))
        n += 1
    with open(args.accs_out, "wb") as f:
        np.savez(f, zero_acc=stats.zero_acc, first_acc=stats.first_acc,
                 total_second=stats.total_second)
    print(f"acc-lda: {n} utts, {stats.total_count:.0f} frames",
          file=sys.stderr)


def cmd_est_lda(args):
    """(ref: bin/est-lda.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import write_ark
    from kaldi_tpu_torch.transform.lda import LdaStats, estimate_lda
    z = np.load(args.accs)
    stats = LdaStats(z["zero_acc"].shape[0], z["first_acc"].shape[1])
    stats.zero_acc, stats.first_acc = z["zero_acc"], z["first_acc"]
    stats.total_second = z["total_second"]
    W, evals = estimate_lda(stats, args.dim)
    write_ark(args.matrix_out, {"lda": np.asarray(W, np.float32)})
    print(f"est-lda: {W.shape[0]}x{W.shape[1]}, eig sum "
          f"{evals.sum():.2f}", file=sys.stderr)


def cmd_gmm_acc_mllt(args):
    """MLLT (STC) stats from weighted posteriors, host f64 as in JAX
    (ref: gmmbin/gmm-acc-mllt.cc, transform/mllt.h:42)."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.mllt import MlltStats
    model = load_gmm_system(args.model, device="cpu")
    feats = dict(open_rspecifier(args.rspecifier))
    stats = MlltStats(model.am.dim)
    n = 0
    for utt, post in read_post_ark(args.post_in):
        if utt not in feats:
            continue
        stats.accumulate_from_gmm_post(
            feats[utt], model.am,
            _post_to_pdf_post(post, model.trans_model))
        n += 1
    with open(args.accs_out, "wb") as f:
        np.savez(f, G=stats.G, beta=stats.beta)
    print(f"gmm-acc-mllt: {n} utts, beta {stats.beta:.0f}",
          file=sys.stderr)


def cmd_est_mllt(args):
    """(ref: bin/est-mllt.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import write_ark
    from kaldi_tpu_torch.transform.mllt import MlltStats, update_mllt
    z = np.load(args.accs)
    stats = MlltStats(z["G"].shape[1])
    stats.G, stats.beta = z["G"], float(z["beta"])
    M, impr = update_mllt(stats)
    write_ark(args.matrix_out, {"mllt": np.asarray(M, np.float32)})
    print(f"est-mllt: objf impr/frame {impr / max(stats.beta, 1.0):.4f} "
          f"over {stats.beta:.0f} frames", file=sys.stderr)


def cmd_sum_lda_accs(args):
    """(ref: bin/sum-lda-accs.cc)"""
    z0 = None
    for p in args.accs_in:
        z = dict(np.load(p).items())
        if z0 is None:
            z0 = z
        else:
            for k in z:
                z0[k] = z0[k] + z[k]
    with open(args.accs_out, "wb") as f:
        np.savez(f, **z0)
    print(f"sum-lda-accs: {len(args.accs_in)} files", file=sys.stderr)


def cmd_sum_mllt_accs(args):
    """(ref: bin/sum-mllt-accs.cc)"""
    G, beta = None, 0.0
    for p in args.accs_in:
        z = np.load(p)
        G = z["G"] if G is None else G + z["G"]
        beta += float(z["beta"])
    with open(args.accs_out, "wb") as f:
        np.savez(f, G=G, beta=np.float64(beta))
    print(f"sum-mllt-accs: {len(args.accs_in)} files", file=sys.stderr)


def cmd_train_lda_mllt(args):
    """Splice -> LDA -> tied-triphone GMM with iterative MLLT, fused, on
    the device (ref: steps/train_lda_mllt.sh). Writes the model and the
    composed MLLT·LDA feature transform; decode with
    `splice-feats | transform-feats <transform>` features."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, write_ark
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_gmm_system
    from kaldi_tpu_torch.steps.lda_mllt import (LdaMlltTrainOpts,
                                                train_lda_mllt)
    dev = _device(args)
    ali_model = load_gmm_system(args.model, device=dev)
    utts_align = _load_train_utts(args.text, args.ali_rspecifier)
    raw = dict(open_rspecifier(args.rspecifier))
    utts_raw = [(u, raw[u].astype(np.float32), w)
                for (u, _f, w) in utts_align if u in raw]
    if len(utts_raw) != len(utts_align):
        raise SystemExit("raw and alignment feature archives disagree")
    opts = LdaMlltTrainOpts(
        num_iters=args.num_iters, totgauss=args.totgauss,
        num_leaves=args.num_leaves, lda_dim=args.lda_dim,
        splice_left=args.splice_left, splice_right=args.splice_right,
        realign_iters=tuple(range(1, args.num_iters)))
    lm = train_lda_mllt(ali_model.lang, utts_align, utts_raw, ali_model,
                        opts)
    save_gmm_system(args.model_out, lm.model)
    write_ark(args.transform_out,
              {"final": np.asarray(lm.transform, np.float32)})
    print(f"train-lda-mllt: {lm.model.am.num_pdfs} pdfs, "
          f"{lm.model.am.total_gauss} gauss, transform "
          f"{lm.transform.shape[0]}x{lm.transform.shape[1]}",
          file=sys.stderr)


# ---------------------------------------------------------- online GMM

def _online_mfcc_opts(args):
    from kaldi_tpu_torch.ops import FrameOpts, MfccOpts
    return MfccOpts(frame_opts=FrameOpts(samp_freq=args.sample_frequency,
                                         dither=0.0),
                    num_ceps=args.num_ceps)


def cmd_online2_wav_dump_features(args):
    """Stream wavs through the online feature pipeline on the device and
    dump the features (ref: online2bin/online2-wav-dump-features.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.io.wave import read_wave
    from kaldi_tpu_torch.online.features import OnlineFeaturePipeline
    dev = _device(args)
    fo = _online_mfcc_opts(args)
    chunk = int(args.chunk_secs * args.sample_frequency)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, path in _read_wav_scp(args.wav_scp):
            wave, _sr = read_wave(path)
            pipe = OnlineFeaturePipeline(fo, delta_order=args.delta_order,
                                         device=dev)
            w = wave[0]
            for lo in range(0, len(w), chunk):
                pipe.accept_waveform(w[lo: lo + chunk])
            pipe.input_finished()
            out.write(utt, np.asarray(pipe.get_features(), np.float32))
            n += 1
    print(f"online2-wav-dump-features: {n} utts", file=sys.stderr)


def cmd_online2_wav_gmm_latgen_faster(args):
    """Streaming GMM decoding of a wav.scp with mid-utterance fMLLR and
    per-speaker adaptation state carried across utterances; features,
    loglikes and the padded search on the device
    (ref: online2bin/online2-wav-gmm-latgen-faster.cc)."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    from kaldi_tpu_torch.io.wave import read_wave
    from kaldi_tpu_torch.online.features import OnlineFeaturePipeline
    from kaldi_tpu_torch.online.gmm_decoding import (AdaptationPolicy,
                                                     SingleUtteranceGmmDecoder)
    dev = _device(args)
    gmm = load_gmm_system(args.model, device=dev)
    base_dec = BeamSearchDecoder(load_hclg(args.graph), BeamSearchOpts(
        beam=args.beam, max_active=args.max_active,
        acoustic_scale=args.acoustic_scale), device=dev)
    fo = _online_mfcc_opts(args)
    utt2spk = _read_utt2spk(args.utt2spk)
    states: dict = {}
    out = open(args.transcription_out, "w") if args.transcription_out \
        else sys.stdout
    chunk = int(args.chunk_secs * args.sample_frequency)
    n = 0
    for utt, path in _read_wav_scp(args.wav_scp):
        spk = utt2spk.get(utt, utt)
        wave, _sr = read_wave(path)
        w = wave[0]
        pipe = OnlineFeaturePipeline(fo, delta_order=args.delta_order,
                                     device=dev)
        sud = SingleUtteranceGmmDecoder(
            gmm.am, gmm.trans_model, base_dec, pipe,
            adaptation_state=states.get(spk),
            policy=AdaptationPolicy(
                adaptation_first_utt_delay=args.adaptation_delay),
            is_first_utt=spk not in states,
            fmllr_min_count=args.fmllr_min_count)
        for lo in range(0, len(w), chunk):
            pipe.accept_waveform(w[lo: lo + chunk])
            sud.advance_decoding()
        sud.finalize_decoding()
        states[spk] = sud.get_adaptation_state()
        res = sud.best_path()
        words = "" if res is None else " ".join(
            gmm.lang.words.sym(x) for x in res[0])
        out.write(f"{utt} {words}\n")
        n += 1
    if args.transcription_out:
        out.close()
    n_adapt = sum(1 for s in states.values() if s.transform is not None)
    print(f"online2-wav-gmm-latgen-faster: decoded {n} utts, "
          f"{n_adapt} speakers adapted", file=sys.stderr)


def cmd_post_to_tacc(args):
    """Sum posterior mass per transition-id over the archive
    (ref: bin/post-to-tacc.cc)."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import write_ark
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    tm = load_gmm_system(args.model, device="cpu").trans_model
    acc = np.zeros(tm.num_transition_ids + 1, np.float64)
    for _utt, post in read_post_ark(args.post_in):
        for fr in post:
            for (i, w) in fr:
                if 0 <= i < len(acc):
                    acc[i] += w
    write_ark(args.acc_out, {"tacc": acc.astype(np.float32)})
    print(f"post-to-tacc: total {acc.sum():.1f}", file=sys.stderr)


# ------------------------------------------- adaptation (slice 5b)

def cmd_train_sat(args):
    """Speaker-adapted (fMLLR) tied-triphone training, fused, on the
    device (ref: steps/train_sat.sh). Writes the model plus per-speaker
    transforms."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_gmm_system
    from kaldi_tpu_torch.steps.sat import SatTrainOpts, train_sat
    dev = _device(args)
    ali_model = load_gmm_system(args.model, device=dev)
    utt2spk = _read_utt2spk(args.utt2spk)
    utts3 = _load_train_utts(args.text, args.rspecifier)
    utts = [(u, f, w, utt2spk.get(u, u)) for (u, f, w) in utts3]
    sat = train_sat(ali_model.lang, utts, ali_model, SatTrainOpts(
        num_iters=args.num_iters, totgauss=args.totgauss,
        num_leaves=args.num_leaves,
        realign_iters=tuple(range(1, args.num_iters)),
        fmllr_min_count=args.fmllr_min_count))
    save_gmm_system(args.model_out, sat.model)
    with open_wspecifier(args.trans_out) as out:
        for spk, W in sorted(sat.transforms.items()):
            out.write(spk, np.asarray(W, np.float32))
    print(f"train-sat: {sat.model.am.num_pdfs} pdfs, "
          f"{sat.model.am.total_gauss} gauss, "
          f"{len(sat.transforms)} speaker transforms", file=sys.stderr)


def _fmllr_stats_by_spk(model, rspecifier, post_in, utt2spk_path,
                        name=None):
    """Per-speaker FmllrStats from posteriors, the gaussian posteriors on
    the model's device; `name` reports an utterance without features."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.transform.fmllr import FmllrStats
    utt2spk = _read_utt2spk(utt2spk_path)
    feats = dict(open_rspecifier(rspecifier))
    by_spk: dict = {}
    for utt, post in read_post_ark(post_in):
        if utt not in feats:
            if name:
                print(f"{name}: no feats for {utt}", file=sys.stderr)
            continue
        spk = utt2spk.get(utt, utt)
        st = by_spk.setdefault(spk, FmllrStats(feats[utt].shape[1]))
        st.accumulate_from_posteriors(
            model.am, feats[utt], _post_to_pdf_post(post, model.trans_model))
    return by_spk


def cmd_gmm_est_fmllr(args):
    """Per-speaker fMLLR transforms from weighted posteriors
    (ref: gmmbin/gmm-est-fmllr.cc, transform/fmllr-diag-gmm.h:61); the
    gaussian posteriors on the device, the solve host f64."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.fmllr import estimate_fmllr
    model = load_gmm_system(args.model, device=_device(args))
    by_spk = _fmllr_stats_by_spk(model, args.rspecifier, args.post_in,
                                 args.utt2spk, name="gmm-est-fmllr")
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for spk, st in sorted(by_spk.items()):
            W, impr, count = estimate_fmllr(st, min_count=args.min_count)
            # below min-count the identity, written anyway so every
            # speaker decodes (ref: fmllr-diag-gmm.cc:161)
            out.write(spk, np.asarray(W, np.float32))
            print(f"gmm-est-fmllr: {spk} auxf impr/frame "
                  f"{impr / max(count, 1.0):.4f} over {count:.0f} frames",
                  file=sys.stderr)
            n += 1
    print(f"gmm-est-fmllr: wrote {n} transforms", file=sys.stderr)


def cmd_gmm_est_map(args):
    """MAP (tau-prior) re-estimation from accs, host f64
    (ref: gmmbin/gmm-est-map.cc, gmm/mle-diag-gmm.h:225)."""
    from kaldi_tpu_torch.gmm.estimation import map_diag_gmm_update
    from kaldi_tpu_torch.io.model_io import (load_gmm_accs, load_gmm_system,
                                             save_gmm_system)
    model = load_gmm_system(args.model, device="cpu")
    acc, _tc = load_gmm_accs(args.accs)
    for i, a in enumerate(acc.accs):
        model.am.pdfs[i] = map_diag_gmm_update(
            model.am.pdfs[i], a, mean_tau=args.mean_tau,
            weight_tau=args.weight_tau, variance_tau=args.variance_tau,
            update_weights=args.update_weights,
            update_vars=args.update_vars)
    model.am.invalidate()
    save_gmm_system(args.model_out, model)
    print(f"gmm-est-map: tau {args.mean_tau}, avg loglike/frame "
          f"{_avg_like(acc)}", file=sys.stderr)


def _save_lvtln(path, lv):
    """JAX's LVTLN file: the class matrices `A` and f64 `warps`."""
    with open(path, "wb") as f:
        np.savez(f, A=_to_host(lv.A), warps=np.asarray(lv.warps, np.float64))


def _load_lvtln(path, device="cpu"):
    from kaldi_tpu_torch.transform.lvtln import LinearVtln
    z = np.load(path)
    lv = LinearVtln(z["A"].shape[1], [float(w) for w in z["warps"]],
                    device=device)
    lv.A = torch.tensor(z["A"], dtype=torch.float64, device=lv.device)
    return lv


def cmd_gmm_init_lvtln(args):
    """Identity-initialised LVTLN classes, one per warp factor
    (ref: gmmbin/gmm-init-lvtln.cc)."""
    from kaldi_tpu_torch.transform.lvtln import LinearVtln
    warps = [float(w) for w in args.warps.split(":")]
    _save_lvtln(args.lvtln_out, LinearVtln(args.dim, warps, device="cpu"))
    print(f"gmm-init-lvtln: {len(warps)} classes, dim {args.dim}",
          file=sys.stderr)


def cmd_gmm_train_lvtln_special(args):
    """Train one LVTLN class from (unwarped, warped) feature pairs, the
    least-squares solve on the device
    (ref: gmmbin/gmm-train-lvtln-special.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    lv = _load_lvtln(args.lvtln, _device(args))
    orig = dict(open_rspecifier(args.rspecifier_orig))
    warp = dict(open_rspecifier(args.rspecifier_warped))
    keys = sorted(set(orig) & set(warp))
    X = np.concatenate([orig[k][: len(warp[k])] for k in keys]) \
        .astype(np.float64)
    Y = np.concatenate([warp[k][: len(orig[k])] for k in keys]) \
        .astype(np.float64)
    lv.train_class(args.class_idx, X, Y)
    _save_lvtln(args.lvtln_out, lv)
    print(f"gmm-train-lvtln-special: class {args.class_idx} from "
          f"{len(X)} frames", file=sys.stderr)


def _write_lvtln_choices(name, lv, by_spk, wspecifier):
    """Each speaker's LVTLN class and transform (the selection on the
    LVTLN's device)."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    n = 0
    with open_wspecifier(wspecifier) as out:
        for spk, st in sorted(by_spk.items()):
            c, W, _auxfs = lv.select_class(st)
            out.write(spk, np.asarray(W, np.float32))
            print(f"{name}: {spk} class {c} warp {lv.warp_of(c)}",
                  file=sys.stderr)
            n += 1
    print(f"{name}: {n} speakers", file=sys.stderr)


def cmd_gmm_est_lvtln_trans(args):
    """Per-speaker LVTLN class selection + bias; writes transforms and
    the chosen warp factors (ref: gmmbin/gmm-est-lvtln-trans.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    lv = _load_lvtln(args.lvtln, dev)
    by_spk = _fmllr_stats_by_spk(model, args.rspecifier, args.post_in,
                                 args.utt2spk)
    _write_lvtln_choices("gmm-est-lvtln-trans", lv, by_spk, args.wspecifier)


def cmd_gmm_adapt_map(args):
    """Per-speaker MAP-adapted models written to a directory, the
    gaussian posteriors on the device (ref: gmmbin/gmm-adapt-map.cc)."""
    from kaldi_tpu_torch.gmm.estimation import (AccumAmDiagGmm,
                                                map_diag_gmm_update)
    from kaldi_tpu_torch.io.model_io import save_gmm_system
    model, feats, posts = _model_feats_posts(args)
    am, tm = model.am, model.trans_model
    utt2spk = _read_utt2spk(args.utt2spk)
    by_spk: dict = {}
    for utt, post in posts:
        if utt not in feats:
            continue
        spk = utt2spk.get(utt, utt)
        acc = by_spk.setdefault(spk, AccumAmDiagGmm(am))
        acc.accumulate_from_posteriors(am, feats[utt],
                                       _post_to_pdf_post(post, tm))
    os.makedirs(args.out_dir, exist_ok=True)
    pdfs = am.pdfs
    for spk, acc in sorted(by_spk.items()):
        am.pdfs = [map_diag_gmm_update(pdfs[p], acc.accs[p],
                                       mean_tau=args.mean_tau)
                   for p in range(am.num_pdfs)]
        am.invalidate()
        save_gmm_system(os.path.join(args.out_dir, f"{spk}.npz"), model)
    print(f"gmm-adapt-map: {len(by_spk)} speakers -> {args.out_dir}",
          file=sys.stderr)


def _save_regtree(path, tree):
    """JAX's regression-tree file: the tree pickled at the highest
    protocol under the JAX package's class name, in an npz `__host__`."""
    import io as _io
    import pickle

    from kaldi_tpu_torch.io.model_io import JaxNamePickler
    buf = _io.BytesIO()
    JaxNamePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(tree)
    with open(path, "wb") as f:
        np.savez(f, __host__=np.frombuffer(buf.getvalue(), np.uint8))


def _load_regtree(path, device="cpu"):
    """A regression-tree file (either package's) -> the port's tree on
    `device`."""
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.io.model_io import _loads
    tree = _loads(np.load(path)["__host__"].tobytes())
    tree.device = resolve_device(device)
    return tree


def cmd_gmm_make_regtree(args):
    """Gaussian regression tree for regtree-(f)MLLR, JAX's host 2-means
    (ref: gmmbin/gmm-make-regtree.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.regtree import RegressionTree
    model = load_gmm_system(args.model, device="cpu")
    tree = RegressionTree(model.am, num_base_classes=args.max_leaves,
                          seed=args.seed, device="cpu")
    _save_regtree(args.tree_out, tree)
    print(f"gmm-make-regtree: {len(tree.leaves)} base classes",
          file=sys.stderr)


def _stack_by_leaf(tree, xf, leaves):
    """Per-gaussian transforms -> one per leaf, stacked [L*D, D+1] in
    leaf order (the apply side regroups)."""
    return np.concatenate(
        [xf[int(np.flatnonzero(tree.gauss2leaf == lf)[0])] for lf in leaves],
        axis=0)


def cmd_gmm_est_regtree_fmllr(args):
    """Per-speaker regression-tree fMLLR: one transform per base class
    with occupancy backoff up the tree, statistics on the device
    (ref: gmmbin/gmm-est-regtree-fmllr.cc)."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.regtree import (RegtreeStats,
                                                   estimate_regtree_fmllr)
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    tm = model.trans_model
    tree = _load_regtree(args.regtree, dev)
    utt2spk = _read_utt2spk(args.utt2spk)
    feats = dict(open_rspecifier(args.rspecifier))
    by_spk: dict = {}
    D = model.am.dim
    for utt, post in read_post_ark(args.post_in):
        if utt not in feats:
            continue
        spk = utt2spk.get(utt, utt)
        acc = by_spk.setdefault(spk, RegtreeStats(tree, D))
        acc.accumulate(model.am, feats[utt].astype(np.float64),
                       _post_to_pdf_post(post, tm))
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for spk, acc in sorted(by_spk.items()):
            xf = estimate_regtree_fmllr(acc, min_count=args.min_count)
            leaves = sorted({int(tree.gauss2leaf[g]) for g in xf})
            out.write(spk, _stack_by_leaf(tree, xf, leaves)
                      .astype(np.float32))
            n += 1
    print(f"gmm-est-regtree-fmllr: {n} speakers", file=sys.stderr)


def cmd_gmm_transform_means(args):
    """Left-multiply every Gaussian mean by a linear/affine transform,
    host f64 (ref: gmmbin/gmm-transform-means.cc)."""
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.io.kaldi_io import read_ark
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    mats = dict(read_ark(args.transform))
    if len(mats) != 1:
        raise SystemExit("gmm-transform-means: transform ark must hold "
                         "exactly one matrix")
    (M,) = mats.values()
    M = np.asarray(M, np.float64)
    D = model.am.dim
    if M.shape == (D, D + 1):
        A, b = M[:, :D], M[:, D]
    elif M.shape == (D, D):
        A, b = M, np.zeros(D)
    else:
        raise SystemExit(f"gmm-transform-means: transform shape "
                         f"{M.shape} does not match dim {D}")
    for pdf in range(model.am.num_pdfs):
        g = model.am.pdfs[pdf]
        model.am.pdfs[pdf] = DiagGmm(g.weights, g.means @ A.T + b, g.vars)
    model.am.invalidate()
    save_gmm_system(args.model_out, model)
    print(f"gmm-transform-means: {model.am.num_pdfs} pdfs",
          file=sys.stderr)


def _basis_accus(model, by_spk):
    """BasisFmllrAccus over the speakers' statistics, on the model's
    device."""
    from kaldi_tpu_torch.transform.basis_fmllr import BasisFmllrAccus
    accus = BasisFmllrAccus(model.am.dim, device=model.am.device)
    for _spk, st in sorted(by_spk.items()):
        accus.accumulate_from_speaker(st)
    return accus


def cmd_gmm_basis_fmllr_training(args):
    """Estimate an fMLLR basis from training speakers' gradient scatter
    on the device (ref: gmmbin/gmm-basis-fmllr-training.cc,
    transform/basis-fmllr-diag-gmm.h:63)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.basis_fmllr import estimate_fmllr_basis
    model = load_gmm_system(args.model, device=_device(args))
    by_spk = _fmllr_stats_by_spk(model, args.rspecifier, args.post_in,
                                 args.utt2spk)
    basis = _to_host(estimate_fmllr_basis(_basis_accus(model, by_spk),
                                          args.basis_size))
    with open(args.basis_out, "wb") as f:
        np.savez(f, basis=basis)
    print(f"gmm-basis-fmllr-training: basis {basis.shape[0]} x "
          f"{basis.shape[1]}x{basis.shape[2]} from {len(by_spk)} "
          f"speakers", file=sys.stderr)


def cmd_gmm_est_basis_fmllr(args):
    """Per-speaker basis-fMLLR coefficients, the ascent on the device
    (ref: gmmbin/gmm-est-basis-fmllr.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.basis_fmllr import (
        compute_basis_fmllr_transform)
    dev = _device(args)
    model = load_gmm_system(args.model, device=dev)
    basis = torch.as_tensor(np.load(args.basis)["basis"],
                            dtype=torch.float64, device=dev)
    by_spk = _fmllr_stats_by_spk(model, args.rspecifier, args.post_in,
                                 args.utt2spk)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for spk, st in sorted(by_spk.items()):
            W, n_coef, impr = compute_basis_fmllr_transform(st, basis)
            out.write(spk, _to_host(W).astype(np.float32))
            print(f"gmm-est-basis-fmllr: {spk} coeffs {n_coef} auxf "
                  f"impr/frame {impr:.4f}", file=sys.stderr)
            n += 1
    print(f"gmm-est-basis-fmllr: wrote {n} transforms", file=sys.stderr)


# ------------------------------------------------------- fMPE (slice 5b)

def _save_fmpe(path, fmpe):
    """JAX's fMPE file: `M`, the UBM's weights / means / vars, int64 dim,
    f64 post_scale and learning_rate, the context windows as JSON bytes."""
    with open(path, "wb") as f:
        np.savez(f, M=fmpe.M, weights=fmpe.gmm.weights,
                 means=fmpe.gmm.means, vars=fmpe.gmm.vars,
                 dim=np.int64(fmpe.dim),
                 post_scale=np.float64(fmpe.opts.post_scale),
                 learning_rate=np.float64(fmpe.opts.learning_rate),
                 context_windows=np.frombuffer(json.dumps(
                     [list(w) for w in fmpe.opts.context_windows]).encode(),
                     dtype=np.uint8))


def _load_fmpe(path):
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.transform.fmpe import Fmpe, FmpeOptions
    z = np.load(path)
    opts = FmpeOptions(
        context_windows=tuple(tuple(w) for w in json.loads(
            z["context_windows"].tobytes().decode())),
        post_scale=float(z["post_scale"]),
        learning_rate=float(z["learning_rate"]))
    f = Fmpe(DiagGmm(z["weights"], z["means"], z["vars"]), int(z["dim"]),
             opts)
    f.M = z["M"].copy()
    return f


def _save_fmpe_accs(path, acc, frames):
    with open(path, "wb") as f:
        np.savez(f, acc=acc, frames=np.float64(frames))


def _fmpe_acc(model, fmpe, rspecifier, post_in):
    """The fMPE differential dF/dM summed over a post file's utterances,
    host f64 as in JAX (`Fmpe`'s posteriors are the UBM's on the host)
    -> (acc, frames)."""
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    feats = dict(open_rspecifier(rspecifier))
    acc = np.zeros_like(fmpe.M)
    frames = 0
    for utt, post in read_post_ark(post_in):
        if utt not in feats:
            continue
        x = np.asarray(feats[utt], np.float64)
        x_out = fmpe.apply(x)
        dF = fmpe.direct_differential(
            model.am, x_out, _post_to_pdf_post(post, model.trans_model))
        acc += dF.T @ fmpe._h(x)
        frames += len(x)
    return acc, frames


def cmd_fmpe_copy(args):
    """(ref: featbin/fmpe-copy.cc)"""
    _save_fmpe(args.fmpe_out, _load_fmpe(args.fmpe))
    print("fmpe-copy: done", file=sys.stderr)


def cmd_fmpe_init(args):
    """Zero-initialised fMPE transform over a diag UBM
    (ref: featbin/fmpe-init.cc)."""
    from kaldi_tpu_torch.io.model_io import load_ubm
    from kaldi_tpu_torch.transform.fmpe import Fmpe, FmpeOptions
    ubm = load_ubm(args.ubm)
    f = Fmpe(ubm, ubm.dim, FmpeOptions(
        post_scale=args.post_scale, learning_rate=args.learning_rate))
    _save_fmpe(args.fmpe_out, f)
    print(f"fmpe-init: {ubm.num_gauss} gauss, dim {ubm.dim}",
          file=sys.stderr)


def cmd_fmpe_acc_stats(args):
    """Accumulate the fMPE differential dF/dM from signed pdf posteriors
    (ref: featbin/fmpe-acc-stats.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    acc, frames = _fmpe_acc(load_gmm_system(args.model, device="cpu"),
                            _load_fmpe(args.fmpe), args.rspecifier,
                            args.post_in)
    _save_fmpe_accs(args.accs_out, acc, frames)
    print(f"fmpe-acc-stats: {frames} frames", file=sys.stderr)


def cmd_fmpe_sum_accs(args):
    """(ref: featbin/fmpe-sum-accs.cc)"""
    acc, frames = None, 0.0
    for p in args.accs_in:
        z = np.load(p)
        acc = z["acc"] if acc is None else acc + z["acc"]
        frames += float(z["frames"])
    _save_fmpe_accs(args.accs_out, acc, frames)
    print(f"fmpe-sum-accs: {len(args.accs_in)} files", file=sys.stderr)


def cmd_fmpe_est(args):
    """SGD step on M from accumulated differentials
    (ref: featbin/fmpe-est.cc)."""
    fmpe = _load_fmpe(args.fmpe)
    z = np.load(args.accs)
    fmpe.M += (fmpe.opts.learning_rate * z["acc"]
               / max(float(z["frames"]), 1.0))
    _save_fmpe(args.fmpe_out, fmpe)
    print(f"fmpe-est: |M| {np.abs(fmpe.M).max():.4f}", file=sys.stderr)


def cmd_fmpe_apply_transform(args):
    """(ref: featbin/fmpe-apply-transform.cc)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    fmpe = _load_fmpe(args.fmpe)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            out.write(k, fmpe.apply(v.astype(np.float64))
                      .astype(np.float32))
            n += 1
    print(f"fmpe-apply-transform: {n} utts", file=sys.stderr)


# ------------------------------------------------------- SGMM2 (slice 5b)

def cmd_train_sgmm2(args):
    """SGMM2 system from a trained GMM system's alignments, fused, on the
    device (ref: steps/train_sgmm2.sh)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_sgmm2
    from kaldi_tpu_torch.steps.sgmm_steps import (SgmmTrainOpts,
                                                  train_sgmm2_system)
    gmm = load_gmm_system(args.model, device=_device(args))
    utts = _load_train_utts(args.text, args.rspecifier)
    sgmm_am, likes = train_sgmm2_system(gmm, utts, SgmmTrainOpts(
        ubm_gauss=args.ubm_gauss, phn_dim=args.phn_dim,
        spk_dim=args.spk_dim, num_iters=args.num_iters,
        num_gselect=args.num_gselect,
        total_substates=args.total_substates))
    save_sgmm2(args.sgmm_out, sgmm_am)
    print(f"train-sgmm2: {sgmm_am.sgmm.num_states} states, "
          f"{sgmm_am.sgmm.num_gauss} gauss, phn-dim "
          f"{sgmm_am.sgmm.phn_dim}, final loglike/frame "
          f"{likes[-1]:.4f}", file=sys.stderr)


def cmd_sgmm2_info(args):
    """(ref: sgmm2bin/sgmm2-info.cc)"""
    from kaldi_tpu_torch.io.model_io import load_sgmm2
    s = load_sgmm2(args.model, device="cpu").sgmm
    print(f"number of states {s.num_states}")
    print(f"number of gaussians {s.num_gauss}")
    print(f"feature dimension {s.dim}")
    print(f"phone-space dimension {s.phn_dim}")
    print(f"speaker-space dimension {s.spk_dim}")
    print(f"number of substates {int(s.offsets[-1])}")


def _sgmm_loglikes(am, items):
    """[(key, feats)] -> ([B, T, J] f32 SGMM loglikes on the model's
    device, the padding masked; [B] int32 frame counts)."""
    feats, nf = _pad_batch(items)
    ll = am.loglikes_np(feats)
    for b in range(len(items)):
        ll[b, nf[b]:] = -1e10
    return ll, nf


def cmd_sgmm2_latgen_faster(args):
    """Lattice-generating decode with an SGMM2 acoustic model on the
    device; the graph's words come from the companion GMM system
    (ref: sgmm2bin/sgmm2-latgen-faster.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import (load_gmm_system, load_hclg,
                                             load_sgmm2)
    dev = _device(args)
    sgmm_am = load_sgmm2(args.model, device=dev)
    gmm = load_gmm_system(args.gmm_model, device="cpu")
    packed = load_hclg(args.graph)
    items = list(open_rspecifier(args.rspecifier))
    ll, nf = _sgmm_loglikes(sgmm_am, items)
    _latgen_from_loglikes(packed, [k for (k, _f) in items], ll, nf, args,
                          dev, sym=gmm.lang.words.sym)


def cmd_sgmm2_gselect(args):
    """Per-frame Gaussian preselection indices, scored on the device
    (ref: sgmm2bin/sgmm2-gselect.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_sgmm2
    am = load_sgmm2(args.model, device=_device(args))
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, feats in open_rspecifier(args.rspecifier):
            gsel = am.sgmm.gselect(feats.astype(np.float64),
                                   args.num_gselect)
            out.write(utt, _to_host(gsel).astype(np.float32))
            n += 1
    print(f"sgmm2-gselect: {n} utts", file=sys.stderr)


def cmd_sgmm2_acc_stats(args):
    """SGMM2 EM stats from per-frame posteriors, on the device
    (ref: sgmm2bin/sgmm2-acc-stats.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_sgmm2, save_sgmm2_accs
    from kaldi_tpu_torch.sgmm.estimate import Sgmm2Accs
    am = load_sgmm2(args.model, device=_device(args))
    feats = dict(open_rspecifier(args.rspecifier))
    xs, post = [], []
    for utt, pdf_post in cli_sgmm._pdf_posts(args.gmm_model, args.post_in):
        if utt not in feats:
            continue
        xs.append(feats[utt].astype(np.float64))
        post += pdf_post[:len(xs[-1])] + [[]] * (len(xs[-1]) - len(pdf_post))
    accs = Sgmm2Accs(am.sgmm)
    if xs:
        # one pass over the utterances' frames together: the sums JAX
        # makes utterance by utterance, in one loop over the states
        accs.accumulate(am.sgmm, np.concatenate(xs), post,
                        num_gselect=am.num_gselect)
    n = len(xs)
    save_sgmm2_accs(args.accs_out, accs)
    print(f"sgmm2-acc-stats: {n} utts, avg loglike/frame "
          f"{accs.tot_like / max(accs.tot_frames, 1.0):.4f}",
          file=sys.stderr)


def cmd_sgmm2_sum_accs(args):
    """(ref: sgmm2bin/sgmm2-sum-accs.cc) Host f64 sums of JAX's arrays."""
    from kaldi_tpu_torch.io.model_io import load_sgmm2_accs, save_sgmm2_accs
    total = None
    for p in args.accs_in:
        a = load_sgmm2_accs(p, device="cpu")
        if total is None:
            total = a
            continue
        for name in ("gamma", "y", "Y", "Q", "_S2", "_Sx", "_tot_like",
                     "_tot_frames"):
            getattr(total, name).add_(getattr(a, name))
    save_sgmm2_accs(args.accs_out, total)
    print(f"sgmm2-sum-accs: {len(args.accs_in)} files", file=sys.stderr)


def cmd_sgmm2_est(args):
    """ML M-step on the device (ref: sgmm2bin/sgmm2-est.cc)."""
    from kaldi_tpu_torch.io.model_io import (load_sgmm2, load_sgmm2_accs,
                                             save_sgmm2)
    from kaldi_tpu_torch.sgmm.estimate import update_sgmm2
    dev = _device(args)
    am = load_sgmm2(args.model, device=dev)
    accs = load_sgmm2_accs(args.accs, device=dev)
    sgmm = update_sgmm2(am.sgmm, accs, update_flags=args.update_flags)
    if args.split_substates:
        sgmm.split_substates(args.split_substates,
                             state_occs=accs.state_occs())
    am.sgmm = sgmm
    save_sgmm2(args.model_out, am)
    print(f"sgmm2-est: flags {args.update_flags}, avg loglike/frame "
          f"{accs.tot_like / max(accs.tot_frames, 1.0):.4f}",
          file=sys.stderr)


def cmd_sgmm2_est_ebw(args):
    """Discriminative EBW M-step from num/den stats, on the device
    (ref: sgmm2bin/sgmm2-est-ebw.cc, estimate-am-sgmm2-ebw.h)."""
    from kaldi_tpu_torch.io.model_io import (load_sgmm2, load_sgmm2_accs,
                                             save_sgmm2)
    from kaldi_tpu_torch.sgmm.ebw import EbwSgmm2Options, update_sgmm2_ebw
    dev = _device(args)
    am = load_sgmm2(args.model, device=dev)
    num = load_sgmm2_accs(args.num_accs, device=dev)
    den = load_sgmm2_accs(args.den_accs, device=dev)
    impr = update_sgmm2_ebw(am.sgmm, num, den, EbwSgmm2Options(),
                            update_flags=args.update_flags)
    save_sgmm2(args.model_out, am)
    print("sgmm2-est-ebw: auxf impr " +
          " ".join(f"{k}={v:.3f}" for k, v in impr.items()),
          file=sys.stderr)


def cmd_sgmm2_align(args):
    """Forced alignment with SGMM2 acoustics over per-utterance training
    graphs, loglikes and Viterbi on the device
    (ref: sgmm2bin/sgmm2-align-compiled.cc)."""
    from kaldi_tpu_torch.decoder.viterbi import viterbi_align
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_sgmm2
    dev = _device(args)
    am = load_sgmm2(args.model, device=dev)
    gmm = load_gmm_system(args.gmm_model, device="cpu")
    utts = _load_train_utts(args.text, args.rspecifier)
    batch = _training_graphs(gmm, [w for (_u, _f, w) in utts])
    feats, nf = _pad_batch([(u, f) for (u, f, _w) in utts])
    results = viterbi_align(batch, am.loglikes_np(feats), nf,
                            args.acoustic_scale, device=dev)
    n_ok = _write_alignments("sgmm2-align", args.wspecifier,
                             [u for (u, _f, _w) in utts], results)
    print(f"sgmm2-align: aligned {n_ok}/{len(utts)}", file=sys.stderr)


def cmd_sgmm2_est_spkvecs(args):
    """Per-speaker vector estimation on the device
    (ref: sgmm2bin/sgmm2-est-spkvecs.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_sgmm2
    from kaldi_tpu_torch.sgmm.estimate import estimate_speaker_vector
    am = load_sgmm2(args.model, device=_device(args))
    utt2spk = _read_utt2spk(args.utt2spk)
    feats = dict(open_rspecifier(args.rspecifier))
    by_spk: dict = {}
    for utt, pdf_post in cli_sgmm._pdf_posts(args.gmm_model, args.post_in):
        if utt not in feats:
            continue
        by_spk.setdefault(utt2spk.get(utt, utt), []).append(
            (feats[utt].astype(np.float64), pdf_post))
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for spk, pieces in sorted(by_spk.items()):
            f = np.concatenate([x for (x, _p) in pieces])
            post = [fr for (_x, p) in pieces for fr in p]
            st = estimate_speaker_vector(am.sgmm, f, post,
                                         num_gselect=am.num_gselect)
            out.write(spk, _to_host(st.v).astype(np.float32))
            n += 1
    print(f"sgmm2-est-spkvecs: {n} speakers", file=sys.stderr)


def _register_adapt(sub):
    """The fifth slice's (5b) subcommands of this module: adaptation,
    fMPE and SGMM2 (kaldi_tpu/cli.py main)."""
    q = sub.add_parser("gmm-transform-means")
    q.add_argument("transform")
    q.add_argument("model")
    q.add_argument("model_out")
    q.set_defaults(func=cmd_gmm_transform_means)

    q = sub.add_parser("train-sat")
    q.add_argument("model", help="alignment system")
    q.add_argument("text")
    q.add_argument("rspecifier")
    q.add_argument("utt2spk")
    q.add_argument("model_out")
    q.add_argument("trans_out", help="per-speaker fMLLR transform ark")
    q.add_argument("--num-iters", type=int, default=15)
    q.add_argument("--totgauss", type=int, default=200)
    q.add_argument("--num-leaves", type=int, default=50)
    q.add_argument("--fmllr-min-count", type=float, default=100.0)
    q.set_defaults(func=cmd_train_sat)

    q = sub.add_parser("gmm-est-fmllr")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("wspecifier")
    q.add_argument("--utt2spk", default="")
    q.add_argument("--min-count", type=float, default=500.0)
    q.set_defaults(func=cmd_gmm_est_fmllr)

    q = sub.add_parser("gmm-est-map")
    q.add_argument("model")
    q.add_argument("accs")
    q.add_argument("model_out")
    q.add_argument("--mean-tau", type=float, default=10.0)
    q.add_argument("--weight-tau", type=float, default=10.0)
    q.add_argument("--variance-tau", type=float, default=50.0)
    q.add_argument("--update-weights", action="store_true")
    q.add_argument("--update-vars", action="store_true")
    q.set_defaults(func=cmd_gmm_est_map)

    q = sub.add_parser("fmpe-init")
    q.add_argument("ubm")
    q.add_argument("fmpe_out")
    q.add_argument("--post-scale", type=float, default=5.0)
    q.add_argument("--learning-rate", type=float, default=0.005)
    q.set_defaults(func=cmd_fmpe_init)

    q = sub.add_parser("fmpe-acc-stats")
    q.add_argument("model")
    q.add_argument("fmpe")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("accs_out")
    q.set_defaults(func=cmd_fmpe_acc_stats)

    q = sub.add_parser("fmpe-sum-accs")
    q.add_argument("accs_out")
    q.add_argument("accs_in", nargs="+")
    q.set_defaults(func=cmd_fmpe_sum_accs)

    q = sub.add_parser("fmpe-est")
    q.add_argument("fmpe")
    q.add_argument("accs")
    q.add_argument("fmpe_out")
    q.set_defaults(func=cmd_fmpe_est)

    q = sub.add_parser("fmpe-apply-transform")
    q.add_argument("fmpe")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_fmpe_apply_transform)

    q = sub.add_parser("fmpe-copy")
    q.add_argument("fmpe")
    q.add_argument("fmpe_out")
    q.set_defaults(func=cmd_fmpe_copy)

    q = sub.add_parser("gmm-init-lvtln")
    q.add_argument("lvtln_out")
    q.add_argument("--dim", type=int, default=39)
    q.add_argument("--warps", default="0.9:0.95:1.0:1.05:1.1")
    q.set_defaults(func=cmd_gmm_init_lvtln)

    q = sub.add_parser("gmm-train-lvtln-special")
    q.add_argument("class_idx", type=int)
    q.add_argument("lvtln")
    q.add_argument("rspecifier_orig")
    q.add_argument("rspecifier_warped")
    q.add_argument("lvtln_out")
    q.set_defaults(func=cmd_gmm_train_lvtln_special)

    q = sub.add_parser("gmm-est-lvtln-trans")
    q.add_argument("model")
    q.add_argument("lvtln")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("wspecifier")
    q.add_argument("--utt2spk", default="")
    q.set_defaults(func=cmd_gmm_est_lvtln_trans)

    q = sub.add_parser("gmm-adapt-map")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("out_dir")
    q.add_argument("--utt2spk", default="")
    q.add_argument("--mean-tau", type=float, default=10.0)
    q.set_defaults(func=cmd_gmm_adapt_map)

    q = sub.add_parser("gmm-make-regtree")
    q.add_argument("model")
    q.add_argument("tree_out")
    q.add_argument("--max-leaves", type=int, default=4)
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(func=cmd_gmm_make_regtree)

    q = sub.add_parser("gmm-est-regtree-fmllr")
    q.add_argument("model")
    q.add_argument("regtree")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("wspecifier")
    q.add_argument("--utt2spk", default="")
    q.add_argument("--min-count", type=float, default=200.0)
    q.set_defaults(func=cmd_gmm_est_regtree_fmllr)

    q = sub.add_parser("gmm-basis-fmllr-training")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("basis_out")
    q.add_argument("--utt2spk", default="")
    q.add_argument("--basis-size", type=int, default=50)
    q.set_defaults(func=cmd_gmm_basis_fmllr_training)

    q = sub.add_parser("gmm-est-basis-fmllr")
    q.add_argument("model")
    q.add_argument("basis")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("wspecifier")
    q.add_argument("--utt2spk", default="")
    q.set_defaults(func=cmd_gmm_est_basis_fmllr)

    q = sub.add_parser("train-sgmm2")
    q.add_argument("model", help="trained GMM system (alignment model)")
    q.add_argument("text")
    q.add_argument("rspecifier")
    q.add_argument("sgmm_out")
    q.add_argument("--ubm-gauss", type=int, default=16)
    q.add_argument("--phn-dim", type=int, default=10)
    q.add_argument("--spk-dim", type=int, default=0)
    q.add_argument("--num-iters", type=int, default=8)
    q.add_argument("--num-gselect", type=int, default=8)
    q.add_argument("--total-substates", type=int, default=None)
    q.set_defaults(func=cmd_train_sgmm2)

    q = sub.add_parser("sgmm2-info")
    q.add_argument("model")
    q.set_defaults(func=cmd_sgmm2_info)

    q = sub.add_parser("sgmm2-latgen-faster")
    q.add_argument("model", help="sgmm2 model file")
    q.add_argument("gmm_model", help="companion GMM system (graph/words)")
    q.add_argument("graph")
    q.add_argument("rspecifier")
    q.add_argument("--lattice-out", default="")
    q.add_argument("--transcription-out", default="")
    q.add_argument("--determinize-lattice", action="store_true")
    q.add_argument("--beam", type=float, default=16.0)
    q.add_argument("--lattice-beam", type=float, default=8.0)
    q.add_argument("--max-active", type=int, default=512)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_sgmm2_latgen_faster)

    q = sub.add_parser("sgmm2-gselect")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--num-gselect", type=int, default=10)
    q.set_defaults(func=cmd_sgmm2_gselect)

    q = sub.add_parser("sgmm2-acc-stats")
    q.add_argument("model")
    q.add_argument("gmm_model")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("accs_out")
    q.set_defaults(func=cmd_sgmm2_acc_stats)

    q = sub.add_parser("sgmm2-sum-accs")
    q.add_argument("accs_out")
    q.add_argument("accs_in", nargs="+")
    q.set_defaults(func=cmd_sgmm2_sum_accs)

    q = sub.add_parser("sgmm2-est")
    q.add_argument("model")
    q.add_argument("accs")
    q.add_argument("model_out")
    q.add_argument("--update-flags", default="vMwSc")
    q.add_argument("--split-substates", type=int, default=0)
    q.set_defaults(func=cmd_sgmm2_est)

    q = sub.add_parser("sgmm2-est-ebw")
    q.add_argument("model")
    q.add_argument("num_accs")
    q.add_argument("den_accs")
    q.add_argument("model_out")
    q.add_argument("--update-flags", default="vMc")
    q.set_defaults(func=cmd_sgmm2_est_ebw)

    q = sub.add_parser("sgmm2-align")
    q.add_argument("model")
    q.add_argument("gmm_model")
    q.add_argument("text")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_sgmm2_align)

    q = sub.add_parser("sgmm2-est-spkvecs")
    q.add_argument("model")
    q.add_argument("gmm_model")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("wspecifier")
    q.add_argument("--utt2spk", default="")
    q.set_defaults(func=cmd_sgmm2_est_spkvecs)


# Reference binary names that resolve to a canonical subcommand: the
# ported ones of kaldi_tpu/cli.py's `_ALIASES`. Options after the alias
# pass straight through to the canonical command.
_ALIASES: dict = {
    # fstbin (OpenFst-style names)
    "fsttablecompose": ["fst-compose", "--table"],
    "fstdeterminizestar": ["fst-determinize-star"],
    "fstdeterminizelog": ["fst-determinize-star", "--use-log"],
    "fstminimizeencoded": ["fst-minimize-encoded"],
    "fstpushspecial": ["fst-push-special"],
    "fstrmepslocal": ["fst-rmepslocal"],
    "fstrmsymbols": ["fst-rmsymbols"],
    "fstphicompose": ["fst-phi-compose"],
    "fstcomposecontext": ["fst-compose-context"],
    "fstaddselfloops": ["add-self-loops"],
    # featbin
    "compute-kaldi-pitch-feats": ["compute-pitch-feats"],
    # alignment and decode variants
    "gmm-align-compiled": ["gmm-align"],
    "align-equal-compiled": ["align-equal"],
    "align-compiled-mapped": ["align-mapped"],
    "gmm-decode-faster": ["decode-faster"],
    "gmm-decode-simple": ["gmm-decode-faster"],
    "gmm-latgen-faster-parallel": ["gmm-latgen-faster"],
    "gmm-latgen-simple": ["gmm-latgen-faster"],
    "latgen-faster-mapped-parallel": ["latgen-faster-mapped"],
    # word alignment by lexicon is the one word aligner
    "lattice-align-words-lexicon": ["lattice-align-words"],
    "lattice-word-align": ["lattice-align-words"],
    # the pruned determinizations are lattice-determinize --beam
    "lattice-determinize-pruned": ["lattice-determinize"],
    "lattice-determinize-pruned-parallel": ["lattice-determinize"],
    "lattice-determinize-phone-pruned": ["lattice-determinize"],
    "lattice-determinize-phone-pruned-parallel": ["lattice-determinize"],
    # the sgmm tree tools are the generic tree tools
    "sgmm-acc-tree-stats": ["acc-tree-stats"],
    "sgmm-build-tree": ["build-tree"],
    "sgmm-cluster-phones": ["cluster-phones"],
    "sgmm-sum-tree-stats": ["sum-tree-stats"],
    # the top-N selection does not depend on the covariance kind
    "fgmm-gselect": ["gmm-gselect"],
    "sum-matrices": ["matrix-sum"],
    "nnet-train-transitions": ["train-transitions"],
    "nnet3-am-train-transitions": ["train-transitions"],
    # nnet2 / nnet3 am-wrappers and the parallel variants, which are the
    # same batched computation
    "nnet-latgen-faster-parallel": ["nnet-latgen-faster"],
    "nnet-train-parallel": ["nnet-train-simple"],
    "nnet-train-perutt": ["nnet-train-simple"],
    "nnet-train-parallel-perturbed": ["nnet-train-simple-perturbed"],
    "nnet-train-discriminative-parallel":
        ["nnet-train-discriminative-simple"],
    "nnet-perturb-egs-fmllr": ["nnet-perturb-egs"],
    "nnet-get-feature-transform-multi": ["nnet-get-feature-transform"],
    "nnet-logprob-parallel": ["nnet-logprob"],
    "nnet-logprob2-parallel": ["nnet-logprob2"],
    "nnet-combine": ["nnet-combine-fast"],
    "nnet-combine-a": ["nnet-combine-fast"],
    "nnet-am-combine": ["nnet-combine-fast"],
    "nnet-init": ["nnet-am-init"],
    "nnet3-am-copy": ["nnet3-copy"],
    "nnet3-am-info": ["nnet3-info"],
    "nnet3-am-init": ["nnet3-init"],
    # ivector / online
    "ivector-extract-online": ["ivector-extract-online2"],
    "online-wav-gmm-decode-faster": ["online2-wav-gmm-latgen-faster"],
    # the reference's mic-driven decoder; audio arrives from wav.scp
    "online-gmm-decode-faster": ["online2-wav-gmm-latgen-faster"],
    # adaptation: the -gpost variants take the same posteriors
    "gmm-est-fmllr-gpost": ["gmm-est-fmllr"],
    "gmm-est-basis-fmllr-gpost": ["gmm-est-basis-fmllr"],
    "gmm-transform-means-global": ["gmm-transform-means"],
    # SGMM2 variants, and the legacy SGMM (v1), which is AmSgmm2 without
    # the speaker weights: the same commands, model files tagged 'sgmm'
    "sgmm2-latgen-faster-parallel": ["sgmm2-latgen-faster"],
    "sgmm2-align-compiled": ["sgmm2-align"],
    "sgmm2-est-fmllr-gpost": ["sgmm2-est-fmllr"],
    "sgmm2-est-spkvecs-gpost": ["sgmm2-est-spkvecs"],
    "sgmm-init": ["sgmm2-init", "--kind", "sgmm"],
    "sgmm-info": ["sgmm2-info"],
    "sgmm-copy": ["sgmm2-copy"],
    "sgmm-gselect": ["sgmm2-gselect"],
    "sgmm-acc-stats": ["sgmm2-acc-stats"],
    "sgmm-acc-stats-gpost": ["sgmm2-acc-stats-gpost"],
    "sgmm-acc-stats2": ["sgmm2-acc-stats2"],
    "sgmm-est": ["sgmm2-est"],
    "sgmm-est-ebw": ["sgmm2-est-ebw"],
    "sgmm-sum-accs": ["sgmm2-sum-accs"],
    "sgmm-align-compiled": ["sgmm2-align"],
    "sgmm-latgen-faster": ["sgmm2-latgen-faster"],
    "sgmm-latgen-simple": ["sgmm2-latgen-faster"],
    "sgmm-decode-faster": ["sgmm2-latgen-faster"],
    "sgmm-est-spkvecs": ["sgmm2-est-spkvecs"],
    "sgmm-est-spkvecs-gpost": ["sgmm2-est-spkvecs"],
    "sgmm-post-to-gpost": ["sgmm2-post-to-gpost"],
    "sgmm-rescore-lattice": ["sgmm2-rescore-lattice"],
    "sgmm-est-fmllr": ["sgmm2-est-fmllr"],
    "sgmm-est-fmllr-gpost": ["sgmm2-est-fmllr"],
    "sgmm-comp-prexform": ["sgmm2-comp-prexform"],
}

# the fifth slice's (5a) subcommands that build a device object: the UBM
# and extractor EM, the batched i-vector solves, logistic regression's
# Adam steps, LDA+MLLT training and the online GMM's features and search
SPEAKER_DEVICE_COMMANDS = (
    "fgmm-global-est", "train-ubm", "train-ivector-extractor",
    "ivector-extract", "ivector-extractor-acc-stats", "ivector-extractor-est",
    "logistic-regression-train", "train-lda-mllt",
    "online2-wav-dump-features", "online2-wav-gmm-latgen-faster")

# the fifth slice's (5b) subcommands here that build a device object:
# SAT, the fMLLR, LVTLN, MAP, regression-tree and basis statistics and
# solves, and the SGMM2 scoring, statistics, updates, alignment and search
ADAPT_DEVICE_COMMANDS = (
    "train-sat", "gmm-est-fmllr", "gmm-train-lvtln-special",
    "gmm-est-lvtln-trans", "gmm-adapt-map", "gmm-est-regtree-fmllr",
    "gmm-basis-fmllr-training", "gmm-est-basis-fmllr", "train-sgmm2",
    "sgmm2-latgen-faster", "sgmm2-gselect", "sgmm2-acc-stats", "sgmm2-est",
    "sgmm2-est-ebw", "sgmm2-align", "sgmm2-est-spkvecs")

# the subcommands that build a device object (`--device`): this module's,
# cli_gmm_extra.py's, cli_adapt.py's and cli_sgmm.py's, and those of
# cli_nnet.py and cli_tail.py that run a network
DEVICE_COMMANDS = (
    "compute-mfcc-feats", "compute-fbank-feats", "compute-spectrogram-feats",
    "compute-plp-feats", "compute-pitch-feats",
    "compute-and-process-kaldi-pitch-feats", "add-deltas", "add-deltas-sdc",
    "splice-feats", "apply-cmvn", "apply-cmvn-sliding", "transform-feats",
    "wav-reverberate", "train-mono", "train-tdnn", "train-nnet3",
    "gmm-align", "decode-faster", "decode-faster-mapped",
    "online2-wav-nnet2-latgen-faster", "recipe-yesno-files",
    "recipe-yesno", "align-equal", "align-mapped", "gmm-init-mono",
    "gmm-init-model", "gmm-init-model-flat", "gmm-acc-stats-ali",
    "gmm-acc-stats", "gmm-acc-stats2", "gmm-compute-likes",
    "gmm-global-est", "train-deltas", "latgen-faster-mapped",
    "gmm-latgen-faster", "gmm-latgen-biglm-faster", "gmm-decode-biglm-faster",
    "gmm-rescore-lattice", "decode-fmllr", "nnet3-compute", "nnet-forward",
    "nnet-train-frmshuff", "rbm-train-cd1-frmshuff", "nnet3-train",
    "nnet3-compute-prob", "nnet3-combine", "nnet3-am-adjust-priors",
    "nnet3-latgen-faster", "nnet-train-simple", "nnet-combine-fast",
    "nnet-adjust-priors", "nnet-latgen-faster") + (
        cli_nnet.DEVICE_COMMANDS + cli_tail.DEVICE_COMMANDS
        + SPEAKER_DEVICE_COMMANDS + ADAPT_DEVICE_COMMANDS
        + cli_adapt.DEVICE_COMMANDS + cli_sgmm.DEVICE_COMMANDS)


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

    # --- FSTs and graphs (text interchange like the fstbin binaries)
    def fst_io(name, transform):
        qq = sub.add_parser(name)
        qq.add_argument("fst_in")
        qq.add_argument("fst_out")
        qq.set_defaults(func=_fst_unary(transform))
        return qq

    q = fst_io("fst-determinize-star", _fst_determinize)
    q.add_argument("--use-log", action="store_true")
    q = fst_io("fst-rmepsilon", _fst_rmepsilon)
    q.add_argument("--use-log", action="store_true")
    fst_io("fst-minimize-encoded", _fst_minimize)
    fst_io("fst-push-special", _fst_push)
    q = fst_io("fst-arcsort", lambda fst, a: fst.arcsort(by=a.sort_type))
    q.add_argument("--sort-type", default="ilabel",
                   choices=["ilabel", "olabel"])
    q = fst_io("fst-project",
               lambda fst, a: fst.project(output=a.project_output))
    q.add_argument("--project-output", action="store_true")
    fst_io("fst-invert", lambda fst, a: fst.invert())
    fst_io("fst-connect", lambda fst, a: fst.connect())
    fst_io("fst-rmepslocal", _fst_rmepslocal)

    q = sub.add_parser("fst-compose")
    q.add_argument("a")
    q.add_argument("b")
    q.add_argument("fst_out")
    q.add_argument("--table", action="store_true",
                   help="table-compose (fsttablecompose)")
    q.set_defaults(func=cmd_fst_compose)

    for name, func in (("fst-shortest-path", cmd_fst_shortest_path),
                       ("fst-info", cmd_fst_info)):
        q = sub.add_parser(name)
        q.add_argument("fst_in")
        q.set_defaults(func=func)

    q = sub.add_parser("arpa2fst")
    q.add_argument("arpa")
    q.add_argument("words")
    q.add_argument("fst_out")
    q.add_argument("--backoff-symbol", default="#0")
    q.set_defaults(func=cmd_arpa2fst)

    q = sub.add_parser("fst-compose-context")
    q.add_argument("ilabels_out")
    q.add_argument("fst_in")
    q.add_argument("fst_out")
    q.add_argument("--context-size", type=int, default=3)
    q.add_argument("--central-position", type=int, default=1)
    q.add_argument("--read-disambig-syms", default="")
    q.set_defaults(func=cmd_fst_compose_context)

    q = sub.add_parser("make-h-transducer")
    q.add_argument("ilabels")
    q.add_argument("model")
    q.add_argument("fst_out")
    q.add_argument("--disambig-syms-out", default="")
    q.add_argument("--transition-scale", type=float, default=1.0)
    q.set_defaults(func=cmd_make_h_transducer)

    q = sub.add_parser("add-self-loops")
    q.add_argument("model")
    q.add_argument("fst_in")
    q.add_argument("fst_out")
    q.add_argument("--self-loop-scale", type=float, default=0.1)
    q.add_argument("--disambig-syms", default="")
    q.set_defaults(func=cmd_add_self_loops)

    q = sub.add_parser("fst-rmsymbols")
    q.add_argument("syms")
    q.add_argument("fst_in")
    q.add_argument("fst_out")
    q.set_defaults(func=cmd_fst_rmsymbols)

    q = sub.add_parser("fst-pack-graph")
    q.add_argument("model")
    q.add_argument("fst_in")
    q.add_argument("graph_out")
    q.set_defaults(func=cmd_fst_pack_graph)

    q = sub.add_parser("fstcopy")
    q.add_argument("fst_in")
    q.add_argument("fst_out")
    q.set_defaults(func=cmd_fst_copy)

    q = sub.add_parser("fstisstochastic")
    q.add_argument("fst_in")
    q.add_argument("--delta", type=float, default=0.01)
    q.set_defaults(func=cmd_fst_is_stochastic)

    q = sub.add_parser("fst-phi-compose")
    q.add_argument("phi_label", type=int)
    q.add_argument("a")
    q.add_argument("b")
    q.add_argument("fst_out")
    q.set_defaults(func=cmd_fst_phi_compose)

    q = sub.add_parser("make-pdf-to-tid-transducer")
    q.add_argument("model")
    q.add_argument("fst_out")
    q.set_defaults(func=cmd_make_pdf_to_tid_transducer)

    q = sub.add_parser("transcripts-to-fsts")
    q.add_argument("transcripts")
    q.add_argument("fsts_out")
    q.add_argument("--word-symbols", default="")
    q.set_defaults(func=cmd_transcripts_to_fsts)

    q = sub.add_parser("fsts-to-transcripts")
    q.add_argument("fsts_in")
    q.set_defaults(func=cmd_fsts_to_transcripts)

    q = sub.add_parser("compile-train-graphs")
    q.add_argument("model")
    q.add_argument("text")
    q.set_defaults(func=cmd_compile_train_graphs)

    # --- HMMs and alignments
    for name, func in (("hmm-info", cmd_hmm_info), ("am-info", cmd_am_info),
                       ("gmm-info", cmd_am_info),
                       ("show-transitions", cmd_show_transitions)):
        q = sub.add_parser(name)
        q.add_argument("model")
        q.set_defaults(func=func)

    q = sub.add_parser("show-alignments")
    q.add_argument("model")
    q.add_argument("ali_rspecifier")
    q.set_defaults(func=cmd_show_alignments)

    for name in ("gmm-copy", "copy-transition-model"):
        q = sub.add_parser(name)
        q.add_argument("model")
        q.add_argument("model_out")
        q.set_defaults(func=cmd_gmm_copy)

    q = sub.add_parser("train-transitions")
    q.add_argument("model")
    q.add_argument("ali_rspecifier")
    q.add_argument("model_out")
    q.set_defaults(func=cmd_train_transitions)

    q = sub.add_parser("ali-to-pdf")
    q.add_argument("model")
    q.add_argument("ali_rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_ali_to_pdf)

    q = sub.add_parser("ali-to-phones")
    q.add_argument("model")
    q.add_argument("ali_rspecifier")
    q.add_argument("--write-lengths", action="store_true")
    q.add_argument("--ctm-output", action="store_true")
    q.add_argument("--frame-shift", type=float, default=0.01)
    q.set_defaults(func=cmd_ali_to_phones)

    q = sub.add_parser("ali-to-post")
    q.add_argument("ali_rspecifier")
    q.add_argument("post_out")
    q.set_defaults(func=cmd_ali_to_post)

    q = sub.add_parser("convert-ali")
    q.add_argument("old_model")
    q.add_argument("new_model")
    q.add_argument("ali_rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_convert_ali)

    for name in ("analyze-counts", "pdf-to-counts"):
        q = sub.add_parser(name)
        q.add_argument("rspecifier")
        q.add_argument("counts_out")
        q.set_defaults(func=cmd_analyze_counts)

    q = sub.add_parser("align-equal")
    q.add_argument("model")
    q.add_argument("text")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--transition-scale", type=float, default=1.0)
    q.add_argument("--self-loop-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_align_equal)

    q = sub.add_parser("align-mapped")
    q.add_argument("model")
    q.add_argument("text")
    q.add_argument("loglikes_rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_align_mapped)

    q = sub.add_parser("align-text")
    q.add_argument("ref")
    q.add_argument("hyp")
    q.set_defaults(func=cmd_align_text)

    # --- trees
    q = sub.add_parser("acc-tree-stats")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("ali_rspecifier")
    q.add_argument("stats_out")
    q.add_argument("--context-width", type=int, default=3)
    q.add_argument("--central-position", type=int, default=1)
    q.add_argument("--ci-phones", default="",
                   help="colon-separated context-independent phone ids "
                        "(default: the model's silence phones)")
    q.set_defaults(func=cmd_acc_tree_stats)

    q = sub.add_parser("sum-tree-stats")
    q.add_argument("stats_out")
    q.add_argument("stats_in", nargs="+")
    q.set_defaults(func=cmd_sum_tree_stats)

    q = sub.add_parser("cluster-phones")
    q.add_argument("stats")
    q.add_argument("questions_out")
    q.set_defaults(func=cmd_cluster_phones)

    sil_roots = ["shared_not_split", "shared_split", "per_state"]
    q = sub.add_parser("build-tree")
    q.add_argument("model")
    q.add_argument("stats")
    q.add_argument("tree_out")
    q.add_argument("--questions", default="",
                   help="question-sets file (cluster-phones output); "
                        "derived from the stats when absent")
    q.add_argument("--max-leaves", type=int, default=500)
    q.add_argument("--thresh", type=float, default=30.0)
    q.add_argument("--cluster-thresh", type=float, default=-1.0)
    q.add_argument("--sil-roots", default="shared_not_split",
                   choices=sil_roots)
    q.set_defaults(func=cmd_build_tree)

    q = sub.add_parser("build-tree-two-level")
    q.add_argument("model")
    q.add_argument("tree_stats")
    q.add_argument("questions")
    q.add_argument("tree_out")
    q.add_argument("map_out")
    q.add_argument("--max-leaves-first", type=int, default=100)
    q.add_argument("--max-leaves-second", type=int, default=400)
    q.set_defaults(func=cmd_build_tree_two_level)

    q = sub.add_parser("copy-tree")
    q.add_argument("tree")
    q.add_argument("tree_out")
    q.set_defaults(func=cmd_copy_tree)

    q = sub.add_parser("tree-info")
    q.add_argument("model", help="tree file or GMM system npz")
    q.set_defaults(func=cmd_tree_info)

    q = sub.add_parser("gmm-init-model")
    q.add_argument("model", help="source system (lang/topology)")
    q.add_argument("tree")
    q.add_argument("stats")
    q.add_argument("model_out")
    q.set_defaults(func=cmd_gmm_init_model)

    q = sub.add_parser("train-deltas")
    q.add_argument("model", help="alignment (mono) system")
    q.add_argument("text")
    q.add_argument("rspecifier")
    q.add_argument("model_out")
    q.add_argument("--num-iters", type=int, default=15)
    q.add_argument("--totgauss", type=int, default=200)
    q.add_argument("--num-leaves", type=int, default=50)
    q.add_argument("--tree-thresh", type=float, default=30.0)
    q.add_argument("--sil-roots", default="shared_not_split",
                   choices=sil_roots)
    q.set_defaults(func=cmd_train_deltas)

    # --- GMMs
    q = sub.add_parser("gmm-init-mono")
    q.add_argument("lexicon")
    q.add_argument("rspecifier")
    q.add_argument("model_out")
    q.add_argument("--sil-phone", default="SIL")
    q.add_argument("--num-sil-states", type=int, default=3)
    q.set_defaults(func=cmd_gmm_init_mono)

    q = sub.add_parser("gmm-acc-stats-ali")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("ali_rspecifier")
    q.add_argument("accs_out")
    q.set_defaults(func=cmd_gmm_acc_stats_ali)

    q = sub.add_parser("gmm-acc-stats")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("accs_out")
    q.set_defaults(func=cmd_gmm_acc_stats)

    q = sub.add_parser("gmm-acc-stats2")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("post_in")
    q.add_argument("num_accs_out")
    q.add_argument("den_accs_out")
    q.set_defaults(func=cmd_gmm_acc_stats2)

    q = sub.add_parser("gmm-sum-accs")
    q.add_argument("accs_out")
    q.add_argument("accs_in", nargs="+")
    q.set_defaults(func=cmd_gmm_sum_accs)

    q = sub.add_parser("gmm-scale-accs")
    q.add_argument("scale", type=float)
    q.add_argument("accs")
    q.add_argument("accs_out")
    q.set_defaults(func=cmd_gmm_scale_accs)

    q = sub.add_parser("gmm-ismooth-stats")
    q.add_argument("model")
    q.add_argument("accs")
    q.add_argument("accs_out")
    q.add_argument("--tau", type=float, default=100.0)
    q.set_defaults(func=cmd_gmm_ismooth_stats)

    q = sub.add_parser("gmm-est")
    q.add_argument("model")
    q.add_argument("accs")
    q.add_argument("model_out")
    q.add_argument("--mix-up", type=int, default=0)
    q.add_argument("--power", type=float, default=0.2)
    q.add_argument("--min-gaussian-occupancy", type=float, default=10.0)
    q.set_defaults(func=cmd_gmm_est)

    q = sub.add_parser("gmm-est-gaussians-ebw")
    q.add_argument("model")
    q.add_argument("num_accs")
    q.add_argument("den_accs")
    q.add_argument("model_out")
    q.add_argument("--E", type=float, default=2.0)
    q.add_argument("--tau", type=float, default=100.0)
    q.set_defaults(func=cmd_gmm_est_gaussians_ebw)

    q = sub.add_parser("gmm-est-weights-ebw")
    q.add_argument("model")
    q.add_argument("num_accs")
    q.add_argument("den_accs")
    q.add_argument("model_out")
    q.add_argument("--weight-tau", type=float, default=10.0)
    q.set_defaults(func=cmd_gmm_est_weights_ebw)

    q = sub.add_parser("gmm-boost-silence")
    q.add_argument("silence_phones", help="colon-separated phone ids")
    q.add_argument("model")
    q.add_argument("model_out")
    q.add_argument("--boost", type=float, default=1.0)
    q.set_defaults(func=cmd_gmm_boost_silence)

    q = sub.add_parser("gmm-mixup")
    q.add_argument("model")
    q.add_argument("model_out")
    q.add_argument("--mix-up", type=int, required=True)
    q.add_argument("--power", type=float, default=0.2)
    q.add_argument("--occs", default="",
                   help="gmm accs file supplying occupancies")
    q.set_defaults(func=cmd_gmm_mixup)

    q = sub.add_parser("gmm-gselect")
    q.add_argument("ubm")
    q.add_argument("rspecifier")
    q.add_argument("gselect_out")
    q.add_argument("--n", type=int, default=50)
    q.set_defaults(func=cmd_gmm_gselect)

    q = sub.add_parser("gmm-compute-likes")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_gmm_compute_likes)

    # --- global GMMs
    q = sub.add_parser("gmm-global-get-post")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("post_out")
    q.add_argument("--n", type=int, default=10)
    q.add_argument("--min-post", type=float, default=0.0)
    q.set_defaults(func=cmd_gmm_global_get_post)

    for name, func in (("gmm-global-to-fgmm", cmd_gmm_global_to_fgmm),
                       ("gmm-global-copy", cmd_gmm_global_copy),
                       ("fgmm-global-copy", cmd_gmm_global_copy),
                       ("fgmm-global-to-gmm", cmd_fgmm_global_to_gmm)):
        q = sub.add_parser(name)
        q.add_argument("model")
        q.add_argument("model_out")
        q.set_defaults(func=func)

    # the full-covariance names share the diagonal commands' handlers,
    # which take either kind of UBM (as JAX registers them)
    for pre in ("gmm", "fgmm"):
        q = sub.add_parser(f"{pre}-global-info")
        q.add_argument("model")
        q.set_defaults(func=cmd_gmm_global_info)

        q = sub.add_parser(f"{pre}-global-acc-stats-post")
        q.add_argument("model")
        q.add_argument("rspecifier")
        q.add_argument("post_in")
        q.add_argument("accs_out")
        q.set_defaults(func=cmd_gmm_global_acc_stats_post)

        q = sub.add_parser(f"{pre}-global-acc-stats")
        q.add_argument("model")
        q.add_argument("rspecifier")
        q.add_argument("accs_out")
        q.set_defaults(func=cmd_gmm_global_acc_stats)

        q = sub.add_parser(f"{pre}-global-est")
        q.add_argument("model")
        q.add_argument("accs")
        q.add_argument("model_out")
        q.add_argument("--min-gaussian-occupancy", type=float,
                       default=10.0)
        q.set_defaults(func=cmd_gmm_global_est)

        q = sub.add_parser(f"{pre}-global-get-frame-likes")
        q.add_argument("model")
        q.add_argument("rspecifier")
        q.add_argument("wspecifier")
        q.set_defaults(func=cmd_gmm_global_get_frame_likes)

        q = sub.add_parser(f"{pre}-global-sum-accs")
        q.add_argument("accs_out")
        q.add_argument("accs_in", nargs="+")
        q.set_defaults(func=cmd_gmm_global_sum_accs)

    # the third slice: lattice generation and rescoring, lattice tools,
    # n-best lists, posteriors and keyword search
    q = sub.add_parser("latgen-faster-mapped")
    q.add_argument("graph")
    q.add_argument("loglikes_rspecifier")
    q.add_argument("--lattice-out", default="")
    q.add_argument("--determinize-lattice", action="store_true",
                   help="word-level determinization of each lattice "
                        "(the reference's default decode mode)")
    q.add_argument("--beam", type=float, default=16.0)
    q.add_argument("--lattice-beam", type=float, default=8.0)
    q.add_argument("--max-active", type=int, default=512)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_latgen_faster_mapped)

    q = sub.add_parser("gmm-latgen-faster")
    q.add_argument("model")
    q.add_argument("graph")
    q.add_argument("rspecifier")
    q.add_argument("--lattice-out", default="")
    q.add_argument("--transcription-out", default="")
    q.add_argument("--determinize-lattice", action="store_true")
    q.add_argument("--beam", type=float, default=16.0)
    q.add_argument("--lattice-beam", type=float, default=8.0)
    q.add_argument("--max-active", type=int, default=512)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.add_argument("--utt2spk", default="")
    q.add_argument("--transform", default="",
                   help="fMLLR transform ark, looked up per --utt2spk")
    q.set_defaults(func=cmd_gmm_latgen_faster)

    q = sub.add_parser("decode-fmllr")
    q.add_argument("model")
    q.add_argument("graph")
    q.add_argument("rspecifier")
    q.add_argument("utt2spk")
    q.add_argument("--transcription-out", default="")
    q.add_argument("--beam", type=float, default=16.0)
    q.add_argument("--max-active", type=int, default=512)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.add_argument("--fmllr-min-count", type=float, default=100.0)
    q.set_defaults(func=cmd_decode_fmllr)

    q = sub.add_parser("lattice-copy")
    q.add_argument("lattice_ark")
    q.add_argument("--out", default="")
    q.add_argument("--verbose", action="store_true")
    q.set_defaults(func=cmd_lattice_copy)

    q = sub.add_parser("lattice-depth")
    q.add_argument("lattice_ark")
    q.set_defaults(func=cmd_lattice_depth)

    q = sub.add_parser("lattice-rmali")
    q.add_argument("lattice_ark")
    q.add_argument("out")
    q.set_defaults(func=cmd_lattice_rmali)

    q = sub.add_parser("lattice-add-penalty")
    q.add_argument("lattice_ark")
    q.add_argument("out")
    q.add_argument("--word-ins-penalty", type=float, default=0.0)
    q.set_defaults(func=cmd_lattice_add_penalty)

    q = sub.add_parser("lattice-best-path")
    q.add_argument("lattice_ark")
    q.add_argument("--lm-scale", type=float, default=1.0)
    q.add_argument("--acoustic-scale", type=float, default=1.0)
    q.add_argument("--word-ins-penalty", type=float, default=0.0)
    q.set_defaults(func=cmd_lattice_best_path)

    q = sub.add_parser("lattice-scale")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.add_argument("--lm-scale", type=float, default=1.0)
    q.add_argument("--acoustic-scale", type=float, default=1.0)
    q.set_defaults(func=_load_lattice_cmd(cmd_lattice_scale))

    q = sub.add_parser("lattice-prune")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.add_argument("--beam", type=float, default=4.0)
    q.set_defaults(func=_load_lattice_cmd(cmd_lattice_prune))

    q = sub.add_parser("lattice-to-nbest")
    q.add_argument("lattice_ark")
    q.add_argument("--n", type=int, default=10)
    q.set_defaults(func=cmd_lattice_nbest)

    q = sub.add_parser("lattice-mbr-decode")
    q.add_argument("lattice_ark")
    q.add_argument("--lm-scale", type=float, default=1.0)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_lattice_mbr_decode)

    q = sub.add_parser("lattice-oracle")
    q.add_argument("lattice_ark")
    q.add_argument("ref_text")
    q.set_defaults(func=cmd_lattice_oracle)

    q = sub.add_parser("arpa-to-const-arpa")
    q.add_argument("words")
    q.add_argument("arpa")
    q.add_argument("out")
    q.set_defaults(func=cmd_arpa_to_const_arpa)

    q = sub.add_parser("lattice-lmrescore-const-arpa")
    q.add_argument("model")
    q.add_argument("arpa")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.add_argument("--lm-scale", type=float, default=1.0)
    q.set_defaults(func=cmd_lattice_lmrescore_const_arpa)

    q = sub.add_parser("lattice-determinize")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.add_argument("--beam", type=float, default=0.0)
    q.set_defaults(func=_load_lattice_cmd(cmd_lattice_determinize))

    q = sub.add_parser("lattice-push")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.set_defaults(func=_load_lattice_cmd(cmd_lattice_push))

    q = sub.add_parser("lattice-minimize")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.set_defaults(func=_load_lattice_cmd(cmd_lattice_minimize))

    q = sub.add_parser("lattice-union")
    q.add_argument("ark_a")
    q.add_argument("ark_b")
    q.add_argument("out_ark")
    q.set_defaults(func=cmd_lattice_union)

    q = sub.add_parser("lattice-interp")
    q.add_argument("ark_a")
    q.add_argument("ark_b")
    q.add_argument("out_ark")
    q.add_argument("--alpha", type=float, default=0.5)
    q.set_defaults(func=cmd_lattice_interp)

    q = sub.add_parser("nbest-to-linear")
    q.add_argument("lattice_ark")
    q.add_argument("--n", type=int, default=10)
    q.set_defaults(func=cmd_nbest_to_linear)

    q = sub.add_parser("lattice-to-ctm-conf")
    q.add_argument("lattice_ark")
    q.add_argument("--lm-scale", type=float, default=1.0)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.add_argument("--frame-shift", type=float, default=0.01)
    q.set_defaults(func=cmd_lattice_to_ctm_conf)

    q = sub.add_parser("lattice-1best")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.add_argument("--lm-scale", type=float, default=1.0)
    q.add_argument("--acoustic-scale", type=float, default=1.0)
    q.set_defaults(func=cmd_lattice_1best)

    q = sub.add_parser("linear-to-nbest")
    q.add_argument("transcripts")
    q.add_argument("out_ark")
    q.set_defaults(func=cmd_linear_to_nbest)

    q = sub.add_parser("lattice-to-post")
    q.add_argument("lattice_ark")
    q.add_argument("post_out")
    q.add_argument("--lm-scale", type=float, default=1.0)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_lattice_to_post)

    for name, crit in (("lattice-to-mpe-post", "mpfe"),
                       ("lattice-to-smbr-post", "smbr")):
        q = sub.add_parser(name)
        q.add_argument("model")
        q.add_argument("ali_rspecifier")
        q.add_argument("lattice_ark")
        q.add_argument("post_out")
        q.add_argument("--lm-scale", type=float, default=1.0)
        q.add_argument("--acoustic-scale", type=float, default=0.1)
        q.add_argument("--silence-phones", default="")
        q.add_argument("--no-one-silence-class", action="store_true")
        q.set_defaults(func=cmd_lattice_to_mpe_post, criterion=crit)

    q = sub.add_parser("lattice-boost-ali")
    q.add_argument("model")
    q.add_argument("lattice_ark")
    q.add_argument("ali_rspecifier")
    q.add_argument("out_ark")
    q.add_argument("--b", type=float, default=0.05)
    q.add_argument("--silence-phones", default="")
    q.add_argument("--max-silence-error", type=float, default=0.0)
    q.set_defaults(func=cmd_lattice_boost_ali)

    q = sub.add_parser("lattice-lmrescore")
    q.add_argument("lattice_ark")
    q.add_argument("g_fst")
    q.add_argument("out_ark")
    q.add_argument("--lm-scale", type=float, default=1.0)
    q.add_argument("--backoff-symbol", type=int, required=True,
                   help="word-id of the #0 backoff symbol in G")
    q.set_defaults(func=cmd_lattice_lmrescore)

    q = sub.add_parser("lattice-to-phone-lattice")
    q.add_argument("model")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.set_defaults(func=cmd_lattice_to_phone_lattice)

    q = sub.add_parser("lattice-align-phones")
    q.add_argument("model")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.add_argument("--replace-output-symbols", action="store_true")
    q.set_defaults(func=cmd_lattice_align_phones)

    q = sub.add_parser("lattice-equivalent")
    q.add_argument("ark_a")
    q.add_argument("ark_b")
    q.add_argument("--delta", type=float, default=0.1)
    q.set_defaults(func=cmd_lattice_equivalent)

    q = sub.add_parser("lattice-limit-depth")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.add_argument("--max-depth", type=int, default=80)
    q.set_defaults(func=cmd_lattice_limit_depth)

    q = sub.add_parser("kws-search")
    q.add_argument("lattice_ark")
    q.add_argument("keywords")
    q.add_argument("--index", action="store_true",
                   help="input is a lattice-to-kws-index file, not an ark")
    q.set_defaults(func=cmd_kws_search)

    q = sub.add_parser("lattice-to-kws-index")
    q.add_argument("lattice_ark")
    q.add_argument("index_out")
    q.set_defaults(func=cmd_lattice_to_kws_index)

    q = sub.add_parser("kws-index-union")
    q.add_argument("index_out")
    q.add_argument("indexes", nargs="+")
    q.set_defaults(func=cmd_kws_index_union)

    q = sub.add_parser("compute-atwv")
    q.add_argument("duration", type=float,
                   help="total audio duration in seconds")
    q.add_argument("ref", help="'kwid utt t_begin t_end' lines")
    q.add_argument("hits", help="'kwid utt t_begin t_end score' lines")
    q.add_argument("--score-threshold", type=float, default=0.5)
    q.set_defaults(func=cmd_compute_atwv)

    q = sub.add_parser("generate-proxy-keywords")
    q.add_argument("keywords", help="'kwid phone phone ...' lines")
    q.add_argument("lexicon", help="'word phone phone ...' lines")
    q.add_argument("--confusion-matrix", default="",
                   help="'phone phone cost' lines")
    q.add_argument("--nbest", type=int, default=10)
    q.add_argument("--proxy-beam", type=float, default=4.0)
    q.set_defaults(func=cmd_generate_proxy_keywords)

    q = sub.add_parser("weight-silence-post")
    q.add_argument("silence_weight", type=float)
    q.add_argument("silence_phones", help="colon-separated phone ids")
    q.add_argument("model")
    q.add_argument("post_in")
    q.add_argument("post_out")
    q.set_defaults(func=cmd_weight_silence_post)

    q = sub.add_parser("sum-post")
    q.add_argument("post_a")
    q.add_argument("post_b")
    q.add_argument("post_out")
    q.add_argument("--scale1", type=float, default=1.0)
    q.add_argument("--scale2", type=float, default=1.0)
    q.set_defaults(func=cmd_sum_post)

    q = sub.add_parser("post-to-weights")
    q.add_argument("post_in")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_post_to_weights)

    for name in ("copy-post", "scale-post"):
        q = sub.add_parser(name)
        q.add_argument("post_in")
        q.add_argument("post_out")
        q.add_argument("--scale", type=float, default=1.0)
        q.set_defaults(func=cmd_copy_post)

    q = sub.add_parser("weight-post")
    q.add_argument("post_in")
    q.add_argument("weights_rspecifier")
    q.add_argument("post_out")
    q.set_defaults(func=cmd_weight_post)

    q = sub.add_parser("thresh-post")
    q.add_argument("post_in")
    q.add_argument("post_out")
    q.add_argument("--threshold", type=float, default=0.01)
    q.set_defaults(func=cmd_thresh_post)

    q = sub.add_parser("rand-prune-post")
    q.add_argument("post_in")
    q.add_argument("post_out")
    q.add_argument("--scale", type=float, default=0.1)
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(func=cmd_rand_prune_post)

    q = sub.add_parser("post-to-pdf-post")
    q.add_argument("model")
    q.add_argument("post_in")
    q.add_argument("post_out")
    q.set_defaults(func=cmd_post_to_pdf_post)

    q = sub.add_parser("post-to-phone-post")
    q.add_argument("model")
    q.add_argument("post_in")
    q.add_argument("post_out")
    q.set_defaults(func=cmd_post_to_phone_post)

    for name, log_in in (("prob-to-post", False),
                         ("logprob-to-post", True)):
        q = sub.add_parser(name)
        q.add_argument("rspecifier")
        q.add_argument("post_out")
        q.add_argument("--min-post", type=float, default=0.01)
        q.set_defaults(func=cmd_prob_to_post, log_input=log_in)

    q = sub.add_parser("get-post-on-ali")
    q.add_argument("post_in")
    q.add_argument("ali_rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_get_post_on_ali)

    q = sub.add_parser("lattice-to-fst")
    q.add_argument("lattice_ark")
    q.add_argument("fsts_out")
    q.add_argument("--lm-scale", type=float, default=0.0)
    q.add_argument("--acoustic-scale", type=float, default=0.0)
    q.set_defaults(func=cmd_lattice_to_fst)

    q = sub.add_parser("lattice-project")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.set_defaults(func=cmd_lattice_project)

    q = sub.add_parser("lattice-depth-per-frame")
    q.add_argument("lattice_ark")
    q.set_defaults(func=cmd_lattice_depth_per_frame)

    q = sub.add_parser("lattice-confidence")
    q.add_argument("lattice_ark")
    q.add_argument("--max-confidence", type=float, default=1e6)
    q.set_defaults(func=cmd_lattice_confidence)

    q = sub.add_parser("nbest-to-ctm")
    q.add_argument("lattice_ark")
    q.add_argument("--frame-shift", type=float, default=0.01)
    q.set_defaults(func=cmd_nbest_to_ctm)

    q = sub.add_parser("lattice-rescore-mapped")
    q.add_argument("model")
    q.add_argument("lattice_ark")
    q.add_argument("loglikes_rspecifier")
    q.add_argument("out_ark")
    q.add_argument("--acoustic-scale", type=float, default=1.0)
    q.set_defaults(func=cmd_lattice_rescore_mapped)

    q = sub.add_parser("lattice-add-trans-probs")
    q.add_argument("model")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.add_argument("--transition-scale", type=float, default=1.0)
    q.set_defaults(func=cmd_lattice_add_trans_probs)

    q = sub.add_parser("lattice-compose")
    q.add_argument("lattice_ark")
    q.add_argument("fst")
    q.add_argument("out_ark")
    q.set_defaults(func=cmd_lattice_compose)

    q = sub.add_parser("lattice-reverse")
    q.add_argument("lattice_ark")
    q.add_argument("out_ark")
    q.set_defaults(func=cmd_lattice_reverse)

    q = sub.add_parser("lattice-combine")
    q.add_argument("out_ark")
    q.add_argument("arks_in", nargs="+")
    q.set_defaults(func=cmd_lattice_combine)

    q = sub.add_parser("nbest-to-lattice")
    q.add_argument("nbest_ark")
    q.add_argument("out_ark")
    q.set_defaults(func=cmd_nbest_to_lattice)

    q = sub.add_parser("lattice-align-words")
    q.add_argument("lexicon")
    q.add_argument("model")
    q.add_argument("lattice_ark")
    q.add_argument("lattice_out")
    q.set_defaults(func=cmd_lattice_align_words)

    q = sub.add_parser("gmm-rescore-lattice")
    q.add_argument("model")
    q.add_argument("lattice_ark")
    q.add_argument("rspecifier")
    q.add_argument("out_ark")
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.set_defaults(func=cmd_gmm_rescore_lattice)

    for name in ("gmm-latgen-biglm-faster", "gmm-decode-biglm-faster"):
        q = sub.add_parser(name)
        q.add_argument("model")
        q.add_argument("graph")
        q.add_argument("old_g", help="small G (text FST)")
        q.add_argument("new_lm", help="const-arpa npz")
        q.add_argument("rspecifier")
        q.add_argument("--transcription-out", default="")
        q.add_argument("--backoff-symbol", type=int, required=True)
        q.add_argument("--beam", type=float, default=16.0)
        q.add_argument("--lattice-beam", type=float, default=8.0)
        q.add_argument("--max-active", type=int, default=512)
        q.add_argument("--acoustic-scale", type=float, default=0.1)
        q.add_argument("--lm-scale", type=float, default=1.0)
        q.set_defaults(func=cmd_gmm_latgen_biglm_faster)

    q = sub.add_parser("feat-to-post")
    q.add_argument("rspecifier")
    q.add_argument("post_out")
    q.add_argument("--min-value", type=float, default=0.0)
    q.set_defaults(func=cmd_feat_to_post)

    q = sub.add_parser("paste-post")
    q.add_argument("post_a")
    q.add_argument("dim_a", type=int)
    q.add_argument("post_b")
    q.add_argument("post_out")
    q.set_defaults(func=cmd_paste_post)

    q = sub.add_parser("recipe-yesno", help="synthetic yesno: features -> "
                       "mono training -> HCLG -> decode -> WER (exits 1 "
                       "unless WER == 0)")
    q.add_argument("--workdir", default="/tmp/kaldi_tpu_yesno",
                   help="JAX's option, unused there too: this recipe "
                        "writes no files")
    q.set_defaults(func=cmd_recipe_yesno)
    _register_nnet(sub)
    _register_speaker(sub)
    _register_adapt(sub)


def _register_speaker(sub):
    """The fifth slice's (5a) subcommands: speaker recognition, logistic
    regression, LDA / MLLT and the online GMM (kaldi_tpu/cli.py main)."""
    q = sub.add_parser("compute-eer")
    q.add_argument("scores")
    q.set_defaults(func=cmd_compute_eer)

    q = sub.add_parser("train-ubm")
    q.add_argument("rspecifier")
    q.add_argument("ubm_out")
    q.add_argument("--num-gauss", type=int, default=64)
    q.add_argument("--num-iters", type=int, default=4)
    q.add_argument("--full", action="store_true")
    q.add_argument("--full-iters", type=int, default=2)
    q.set_defaults(func=cmd_train_ubm)

    q = sub.add_parser("train-ivector-extractor")
    q.add_argument("ubm")
    q.add_argument("rspecifier")
    q.add_argument("extractor_out")
    q.add_argument("--ivector-dim", type=int, default=100)
    q.add_argument("--num-iters", type=int, default=5)
    q.add_argument("--num-gselect", type=int, default=20)
    q.set_defaults(func=cmd_train_ivector_extractor)

    q = sub.add_parser("ivector-extract")
    q.add_argument("extractor")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--spk2utt", default="")
    q.add_argument("--num-gselect", type=int, default=20)
    q.set_defaults(func=cmd_ivector_extract)

    for name in ("train-plda", "ivector-compute-plda"):
        q = sub.add_parser(name)
        q.add_argument("spk2utt")
        q.add_argument("rspecifier")
        q.add_argument("plda_out")
        q.add_argument("--num-iters", type=int, default=10)
        q.set_defaults(func=cmd_train_plda)

    q = sub.add_parser("ivector-extractor-init")
    q.add_argument("ubm")
    q.add_argument("extractor_out")
    q.add_argument("--ivector-dim", type=int, default=100)
    q.add_argument("--prior-offset", type=float, default=100.0)
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(func=cmd_ivector_extractor_init)

    q = sub.add_parser("ivector-extractor-acc-stats")
    q.add_argument("extractor")
    q.add_argument("rspecifier")
    q.add_argument("accs_out")
    q.add_argument("--num-gselect", type=int, default=20)
    q.set_defaults(func=cmd_ivector_extractor_acc_stats)

    q = sub.add_parser("ivector-extractor-sum-accs")
    q.add_argument("accs_out")
    q.add_argument("accs_in", nargs="+")
    q.set_defaults(func=cmd_ivector_extractor_sum_accs)

    q = sub.add_parser("ivector-extractor-est")
    q.add_argument("extractor")
    q.add_argument("accs")
    q.add_argument("extractor_out")
    q.set_defaults(func=cmd_ivector_extractor_est)

    q = sub.add_parser("ivector-compute-lda")
    q.add_argument("rspecifier")
    q.add_argument("utt2spk")
    q.add_argument("matrix_out")
    q.add_argument("--dim", type=int, default=100)
    q.set_defaults(func=cmd_ivector_compute_lda)

    q = sub.add_parser("ivector-transform")
    q.add_argument("transform")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.set_defaults(func=cmd_transform_vec)

    q = sub.add_parser("ivector-compute-dot-products")
    q.add_argument("trials")
    q.add_argument("rspecifier")
    q.set_defaults(func=cmd_ivector_compute_dot_products)

    q = sub.add_parser("ivector-adapt-plda")
    q.add_argument("plda")
    q.add_argument("rspecifier")
    q.add_argument("plda_out")
    q.add_argument("--mean-diff-scale", type=float, default=1.0)
    q.add_argument("--within-covar-scale", type=float, default=0.3)
    q.add_argument("--between-covar-scale", type=float, default=0.7)
    q.set_defaults(func=cmd_ivector_adapt_plda)

    q = sub.add_parser("ivector-copy-plda")
    q.add_argument("plda")
    q.add_argument("plda_out")
    q.add_argument("--smoothing", type=float, default=0.0)
    q.set_defaults(func=cmd_ivector_copy_plda)

    q = sub.add_parser("ivector-plda-scoring")
    q.add_argument("plda")
    q.add_argument("enroll_rspecifier")
    q.add_argument("test_rspecifier")
    q.add_argument("trials")
    q.add_argument("--scores-out", default="")
    q.set_defaults(func=cmd_ivector_plda_scoring)

    q = sub.add_parser("ivector-extract-online2")
    q.add_argument("extractor")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--utt2spk", default="")
    q.add_argument("--ivector-period", type=int, default=10)
    q.add_argument("--num-gselect", type=int, default=5)
    q.set_defaults(func=cmd_ivector_extract_online2)

    q = sub.add_parser("ivector-mean")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--spk2utt", default="")
    q.set_defaults(func=cmd_ivector_mean)

    q = sub.add_parser("ivector-normalize-length")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--scaleup", action="store_true", default=True)
    q.add_argument("--no-scaleup", dest="scaleup", action="store_false")
    q.set_defaults(func=cmd_ivector_normalize_length)

    q = sub.add_parser("ivector-subtract-global-mean")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--mean", default="",
                   help="precomputed mean ark (from ivector-mean)")
    q.set_defaults(func=cmd_ivector_subtract_global_mean)

    q = sub.add_parser("logistic-regression-train")
    q.add_argument("rspecifier")
    q.add_argument("utt2label")
    q.add_argument("model_out")
    q.add_argument("--max-steps", type=int, default=100)
    q.add_argument("--normalizer", type=float, default=0.0025)
    q.set_defaults(func=cmd_logistic_regression_train)

    q = sub.add_parser("logistic-regression-eval")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--utt2label", default="",
                   help="truth labels; prints accuracy")
    q.set_defaults(func=cmd_logistic_regression_eval)

    q = sub.add_parser("logistic-regression-copy")
    q.add_argument("model")
    q.add_argument("model_out")
    q.set_defaults(func=cmd_logistic_regression_copy)

    q = sub.add_parser("copy-gselect")
    q.add_argument("gselect_in")
    q.add_argument("gselect_out")
    q.set_defaults(func=cmd_copy_gselect)

    for name in ("acc-lda", "gmm-acc-mllt"):
        q = sub.add_parser(name)
        q.add_argument("model")
        q.add_argument("rspecifier")
        q.add_argument("post_in")
        q.add_argument("accs_out")
        q.set_defaults(func=cmd_acc_lda if name == "acc-lda"
                       else cmd_gmm_acc_mllt)

    q = sub.add_parser("est-lda")
    q.add_argument("accs")
    q.add_argument("matrix_out")
    q.add_argument("--dim", type=int, default=40)
    q.set_defaults(func=cmd_est_lda)

    q = sub.add_parser("est-mllt")
    q.add_argument("accs")
    q.add_argument("matrix_out")
    q.set_defaults(func=cmd_est_mllt)

    for name, func in (("sum-lda-accs", cmd_sum_lda_accs),
                       ("sum-mllt-accs", cmd_sum_mllt_accs)):
        q = sub.add_parser(name)
        q.add_argument("accs_out")
        q.add_argument("accs_in", nargs="+")
        q.set_defaults(func=func)

    q = sub.add_parser("train-lda-mllt")
    q.add_argument("model", help="alignment system")
    q.add_argument("text")
    q.add_argument("rspecifier", help="raw (unspliced) features")
    q.add_argument("ali_rspecifier",
                   help="features in the alignment model's space")
    q.add_argument("model_out")
    q.add_argument("transform_out", help="composed MLLT*LDA transform ark")
    q.add_argument("--num-iters", type=int, default=15)
    q.add_argument("--totgauss", type=int, default=200)
    q.add_argument("--num-leaves", type=int, default=50)
    q.add_argument("--lda-dim", type=int, default=40)
    q.add_argument("--splice-left", type=int, default=3)
    q.add_argument("--splice-right", type=int, default=3)
    q.set_defaults(func=cmd_train_lda_mllt)

    q = sub.add_parser("online2-wav-gmm-latgen-faster")
    q.add_argument("model")
    q.add_argument("graph")
    q.add_argument("wav_scp")
    q.add_argument("--transcription-out", default="")
    q.add_argument("--utt2spk", default="")
    q.add_argument("--sample-frequency", type=float, default=16000.0)
    q.add_argument("--num-ceps", type=int, default=13)
    q.add_argument("--delta-order", type=int, default=2)
    q.add_argument("--beam", type=float, default=16.0)
    q.add_argument("--max-active", type=int, default=256)
    q.add_argument("--acoustic-scale", type=float, default=0.1)
    q.add_argument("--chunk-secs", type=float, default=0.4)
    q.add_argument("--adaptation-delay", type=float, default=2.0)
    q.add_argument("--fmllr-min-count", type=float, default=100.0)
    q.set_defaults(func=cmd_online2_wav_gmm_latgen_faster)

    q = sub.add_parser("online2-wav-dump-features")
    q.add_argument("wav_scp")
    q.add_argument("wspecifier")
    q.add_argument("--sample-frequency", type=float, default=16000.0)
    q.add_argument("--num-ceps", type=int, default=13)
    q.add_argument("--delta-order", type=int, default=2)
    q.add_argument("--chunk-secs", type=float, default=0.4)
    q.set_defaults(func=cmd_online2_wav_dump_features)

    q = sub.add_parser("post-to-tacc")
    q.add_argument("model")
    q.add_argument("post_in")
    q.add_argument("acc_out")
    q.set_defaults(func=cmd_post_to_tacc)


def _register_nnet(sub):
    """The nnet2, nnet3 and nnet1 subcommands of this module, with JAX's
    argument names and defaults (kaldi_tpu/cli.py main)."""
    q = sub.add_parser("nnet3-info")
    q.add_argument("model")
    q.set_defaults(func=cmd_nnet3_info)

    q = sub.add_parser("nnet3-copy")
    q.add_argument("model")
    q.add_argument("model_out")
    q.add_argument("--scale", type=float, default=1.0)
    q.set_defaults(func=cmd_nnet3_copy)

    q = sub.add_parser("nnet3-compute")
    q.add_argument("model")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--use-priors", action="store_true",
                   help="subtract log-priors (pseudo-loglikes out)")
    q.set_defaults(func=cmd_nnet3_compute)

    q = sub.add_parser("nnet-initialize")
    q.add_argument("proto")
    q.add_argument("nnet_out")
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(func=cmd_nnet1_initialize)

    q = sub.add_parser("nnet-info")
    q.add_argument("nnet")
    q.set_defaults(func=cmd_nnet1_info)

    q = sub.add_parser("nnet-copy")
    q.add_argument("nnet_in")
    q.add_argument("nnet_out")
    q.set_defaults(func=cmd_nnet1_copy)

    q = sub.add_parser("nnet-concat")
    q.add_argument("nnet_out")
    q.add_argument("nnets_in", nargs="+")
    q.set_defaults(func=cmd_nnet1_concat)

    q = sub.add_parser("nnet-forward")
    q.add_argument("nnet")
    q.add_argument("rspecifier")
    q.add_argument("wspecifier")
    q.add_argument("--apply-log", action="store_true")
    q.add_argument("--class-frame-counts", default="")
    q.set_defaults(func=cmd_nnet1_forward)

    q = sub.add_parser("nnet-train-frmshuff")
    q.add_argument("nnet_in")
    q.add_argument("rspecifier")
    q.add_argument("targets_rspecifier", help="pdf alignments ark")
    q.add_argument("nnet_out")
    q.add_argument("--learn-rate", type=float, default=0.008)
    q.add_argument("--minibatch-size", type=int, default=256)
    q.add_argument("--num-epochs", type=int, default=1)
    q.add_argument("--momentum", type=float, default=0.0)
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(func=cmd_nnet1_train_frmshuff)

    q = sub.add_parser("rbm-train-cd1-frmshuff")
    q.add_argument("rspecifier")
    q.add_argument("rbm_out")
    q.add_argument("--hidden-dim", type=int, default=128)
    q.add_argument("--learn-rate", type=float, default=0.01)
    q.add_argument("--minibatch-size", type=int, default=256)
    q.add_argument("--num-epochs", type=int, default=2)
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(func=cmd_rbm_train_cd1_frmshuff)

    q = sub.add_parser("rbm-convert-to-nnet")
    q.add_argument("rbm")
    q.add_argument("nnet_out")
    q.set_defaults(func=cmd_rbm_convert_to_nnet)

    q = sub.add_parser("cmvn-to-nnet")
    q.add_argument("cmvn_rspecifier")
    q.add_argument("nnet_out")
    q.set_defaults(func=cmd_cmvn_to_nnet)

    q = sub.add_parser("transf-to-nnet")
    q.add_argument("transform")
    q.add_argument("nnet_out")
    q.add_argument("--affine", action="store_true")
    q.set_defaults(func=cmd_transf_to_nnet)

    q = sub.add_parser("nnet-kl-hmm-acc")
    q.add_argument("rspecifier", help="posterior-feature matrices")
    q.add_argument("ali_rspecifier")
    q.add_argument("accs_out")
    q.add_argument("--num-states", type=int, required=True)
    q.set_defaults(func=cmd_nnet_kl_hmm_acc)

    q = sub.add_parser("nnet-kl-hmm-sum-accs")
    q.add_argument("accs_out")
    q.add_argument("accs_in", nargs="+")
    q.set_defaults(func=cmd_nnet_kl_hmm_sum_accs)

    q = sub.add_parser("nnet3-init")
    q.add_argument("config")
    q.add_argument("nnet_out")
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(func=cmd_nnet3_init)

    for name, func in (("nnet3-train", cmd_nnet3_train),
                       ("nnet-train-simple", cmd_nnet_train_simple)):
        q = sub.add_parser(name)
        q.add_argument("nnet_in")
        q.add_argument("egs_dir")
        q.add_argument("nnet_out")
        q.add_argument("--initial-lr", type=float, default=0.04)
        q.add_argument("--final-lr", type=float, default=0.004)
        q.add_argument("--num-epochs", type=int, default=4)
        q.add_argument("--minibatch-size", type=int, default=128)
        q.add_argument("--momentum", type=float, default=0.9)
        q.set_defaults(func=func)

    q = sub.add_parser("nnet3-compute-prob")
    q.add_argument("nnet")
    q.add_argument("egs_dir")
    q.set_defaults(func=cmd_nnet3_compute_prob)

    for name, func in (("nnet3-average", cmd_nnet3_average),
                       ("nnet-am-average", cmd_nnet_am_average)):
        q = sub.add_parser(name)
        q.add_argument("nnet_out")
        q.add_argument("nnets_in", nargs="+")
        q.set_defaults(func=func)

    for name, func in (("nnet3-combine", cmd_nnet3_combine),
                       ("nnet-combine-fast", cmd_nnet_combine_fast)):
        q = sub.add_parser(name)
        q.add_argument("valid_egs")
        q.add_argument("nnet_out")
        q.add_argument("nnets_in", nargs="+")
        q.add_argument("--num-steps", type=int, default=50)
        q.set_defaults(func=func)

    for name, func in (("nnet3-am-adjust-priors", cmd_nnet3_adjust_priors),
                       ("nnet-adjust-priors", cmd_nnet_adjust_priors)):
        q = sub.add_parser(name)
        q.add_argument("nnet_in")
        q.add_argument("rspecifier")
        q.add_argument("nnet_out")
        q.set_defaults(func=func)

    for name, func in (("nnet3-latgen-faster", cmd_nnet3_latgen_faster),
                       ("nnet-latgen-faster", cmd_nnet_latgen_faster)):
        q = sub.add_parser(name)
        q.add_argument("model")
        q.add_argument("nnet")
        q.add_argument("graph")
        q.add_argument("rspecifier")
        q.add_argument("--lattice-out", default="")
        q.add_argument("--transcription-out", default="")
        q.add_argument("--determinize-lattice", action="store_true")
        q.add_argument("--beam", type=float, default=16.0)
        q.add_argument("--lattice-beam", type=float, default=8.0)
        q.add_argument("--max-active", type=int, default=512)
        q.add_argument("--acoustic-scale", type=float, default=0.1)
        q.set_defaults(func=func)

    # the nnet3 egs binaries share the nnet2 egs-archive implementation
    # (ref: nnet3bin/nnet3-get-egs.cc, nnet3-shuffle-egs.cc,
    #  nnet3-merge-egs.cc, nnet3-copy-egs.cc, nnet3-subset-egs.cc)
    for name in ("nnet-get-egs", "nnet3-get-egs"):
        q = sub.add_parser(name)
        q.add_argument("model")
        q.add_argument("rspecifier")
        q.add_argument("ali_rspecifier")
        q.add_argument("egs_dir")
        q.add_argument("--left-context", type=int, default=13)
        q.add_argument("--right-context", type=int, default=9)
        q.add_argument("--chunk", type=int, default=8)
        q.add_argument("--num-archives", type=int, default=2)
        q.add_argument("--no-compress", action="store_true")
        q.add_argument("--seed", type=int, default=0)
        q.set_defaults(func=cmd_nnet_get_egs)

    for name, func, archives in (
            ("nnet-copy-egs", cmd_nnet_copy_egs, 2),
            ("nnet3-copy-egs", cmd_nnet_copy_egs, 1),
            ("nnet3-merge-egs", cmd_nnet_copy_egs, 1),
            ("nnet-shuffle-egs", cmd_nnet_shuffle_egs, 1),
            ("nnet3-shuffle-egs", cmd_nnet_shuffle_egs, 1)):
        q = sub.add_parser(name)
        q.add_argument("egs_in")
        q.add_argument("egs_out")
        q.add_argument("--num-archives", type=int, default=archives)
        q.add_argument("--seed", type=int, default=0)
        q.set_defaults(func=func)

    for name in ("nnet-subset-egs", "nnet3-subset-egs"):
        q = sub.add_parser(name)
        q.add_argument("egs_in")
        q.add_argument("egs_out")
        q.add_argument("--n", type=int, default=1000)
        q.add_argument("--randomize", action="store_true")
        q.add_argument("--seed", type=int, default=0)
        q.set_defaults(func=cmd_nnet_subset_egs)

    q = sub.add_parser("nnet-am-init")
    q.add_argument("model")
    q.add_argument("rspecifier", help="features (to size the input dim)")
    q.add_argument("nnet_out")
    q.add_argument("--splice-indexes",
                   default="-2,-1,0,1,2;-1,2;-3,3;0")
    q.add_argument("--hidden-dim", type=int, default=256)
    q.add_argument("--pnorm-output-dim", type=int, default=64)
    q.add_argument("--nonlinearity", default="pnorm",
                   choices=["pnorm", "relu"])
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(func=cmd_nnet_am_init)

    q = sub.add_parser("nnet-am-info")
    q.add_argument("nnet")
    q.set_defaults(func=cmd_nnet_am_info)

    q = sub.add_parser("nnet-am-copy")
    q.add_argument("nnet_in")
    q.add_argument("nnet_out")
    q.set_defaults(func=cmd_nnet_am_copy)


@functools.lru_cache(maxsize=1)
def _parser() -> argparse.ArgumentParser:
    """The CLI's parser, built once per process: its ~470 subparsers take
    about 0.15 s to build, which a recipe's hundreds of in-process calls
    would otherwise pay each time."""
    p = argparse.ArgumentParser(prog="kaldi_tpu_torch.cli",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    _register(sub)
    for module in (cli_nnet, cli_misc, cli_fst, cli_gmm_extra,
                   cli_online_extra, cli_tail, cli_adapt, cli_sgmm):
        module.register(sub)
    for name in DEVICE_COMMANDS:
        sub.choices[name].add_argument("--device", default="cuda",
                                       help="torch device (default: cuda)")
    return p


def main(argv=None) -> int:
    argv = _expand_config_args(argv if argv is not None else sys.argv[1:])
    for _hop in range(4):   # aliases may chain (e.g. *-simple -> *-faster)
        if not (argv and argv[0] in _ALIASES):
            break
        argv = _ALIASES[argv[0]] + argv[1:]
    args = _parser().parse_args(argv)
    rc = args.func(args)
    if rc:
        sys.exit(rc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
