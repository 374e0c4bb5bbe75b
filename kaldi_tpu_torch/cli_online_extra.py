"""Legacy online / onlinebin CLI subcommands of the port.

Counterpart of kaldi_tpu/cli_online_extra.py: TCP audio decode server +
clients, the threaded online2 nnet2 decoder, online nnet2 AM forward,
speex-role codec round-trip, raw-fMLLR estimation, and GMM-from-features
init, over the port's modules and model files (`io/model_io.py`, which
reads the JAX package's files too). Registered into the main parser by
kaldi_tpu_torch.cli.main via register(sub). Every command that touches a
model runs on `--device` (default: cuda).

(ref: onlinebin/*.cc, online2bin/*.cc, gmmbin/gmm-est-fmllr-raw.cc,
 gmmbin/gmm-global-init-from-feats.cc — cited per command.)
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _mfcc_opts(args, **kw):
    from kaldi_tpu_torch.ops.features import MfccOpts
    from kaldi_tpu_torch.ops.window import FrameOpts
    return MfccOpts(frame_opts=FrameOpts(samp_freq=args.sample_frequency,
                                         dither=0.0), **kw)


def cmd_online_server_gmm_decode_faster(args):
    """TCP audio decode server: 16-bit PCM in, partial/final hypothesis
    lines out (ref: onlinebin/online-server-gmm-decode-faster.cc /
    online-audio-server-decode-faster.cc; both UDP/RTP and TCP-wav roles
    collapse onto one TCP PCM protocol here). --num-connections bounds
    the serving loop so scripted use terminates."""
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    from kaldi_tpu_torch.online.decoder import OnlineDecoder
    from kaldi_tpu_torch.online.features import OnlineFeaturePipeline
    from kaldi_tpu_torch.online.server import AudioServer, DecodeSession
    model = load_gmm_system(args.model, device=args.device)
    packed = load_hclg(args.graph)
    base = BeamSearchDecoder(packed, BeamSearchOpts(
        beam=args.beam, max_active=args.max_active,
        acoustic_scale=args.acoustic_scale), device=args.device)
    fo = _mfcc_opts(args)

    def session():
        return DecodeSession(
            make_pipeline=lambda: OnlineFeaturePipeline(
                fo, delta_order=args.delta_order, device=args.device),
            make_decoder=lambda: OnlineDecoder(
                base, chunk_frames=args.chunk_frames),
            am=model.am, words=model.lang.words)

    server = AudioServer(args.host, args.port, session)
    print(f"online-server-gmm-decode-faster: listening on "
          f"{args.host}:{server.port}", file=sys.stderr, flush=True)
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(server.port))
    server.serve(args.num_connections)


def cmd_online_audio_client(args):
    """Stream wav files to a decode server, print the hypothesis lines
    (ref: onlinebin/online-audio-client.cc / online-net-client.cc)."""
    from kaldi_tpu_torch.cli import _read_wav_scp
    from kaldi_tpu_torch.io.wave import read_wave
    from kaldi_tpu_torch.online.server import stream_wave
    n = 0
    for utt, path in _read_wav_scp(args.wav_scp):
        wave, _sr = read_wave(path)
        lines = stream_wave(args.host, args.port, wave[0],
                            chunk_samples=args.chunk_samples)
        final = lines[-1] if lines else ""
        print(f"{utt} {final}")
        n += 1
    print(f"online-audio-client: streamed {n} utts", file=sys.stderr)


def _processed_pipeline(args, fo):
    from kaldi_tpu_torch.online.features import (OnlineFeaturePipeline,
                                                 OnlineProcessedFeature)
    return OnlineProcessedFeature(OnlineFeaturePipeline(
        fo, delta_order=args.delta_order, device=args.device))


def cmd_online2_wav_nnet2_am_compute(args):
    """Forward the nnet2 AM over online-extracted features of a wav.scp
    (ref: online2bin/online2-wav-nnet2-am-compute.cc)."""
    from kaldi_tpu_torch.cli import _read_wav_scp
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_am_nnet
    from kaldi_tpu_torch.io.wave import read_wave
    am = load_am_nnet(args.nnet, device=args.device)
    fo = _mfcc_opts(args, num_ceps=args.num_ceps)
    chunk = int(args.chunk_secs * args.sample_frequency)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, path in _read_wav_scp(args.wav_scp):
            wave, _sr = read_wave(path)
            w = wave[0]
            pipe = _processed_pipeline(args, fo)
            for lo in range(0, len(w), chunk):
                pipe.accept_waveform(w[lo: lo + chunk])
            pipe.input_finished()
            feats = pipe.get_frames(0, pipe.num_frames_ready())
            if feats is None or len(feats) == 0:
                continue
            x = np.asarray(feats, np.float32)[None]
            y = (am.log_posteriors(x).cpu().numpy() if args.apply_log
                 else am.loglikes_np(x))
            out.write(utt, np.asarray(y[0], np.float32))
            n += 1
    print(f"online2-wav-nnet2-am-compute: {n} utts", file=sys.stderr)


def cmd_online2_wav_nnet2_latgen_threaded(args):
    """online2-wav-nnet2-latgen-faster through the threaded
    single-utterance decoder (feature/search pipeline off the caller
    thread) (ref: online2bin/online2-wav-nnet2-latgen-threaded.cc,
    online2/online-nnet2-decoding-threaded.h)."""
    from kaldi_tpu_torch.cli import _read_wav_scp
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.io.model_io import (load_am_nnet, load_gmm_system,
                                             load_hclg)
    from kaldi_tpu_torch.io.wave import read_wave
    from kaldi_tpu_torch.online.nnet2_decoding import (
        OnlineNnet2FeaturePipeline, SingleUtteranceNnet2Decoder)
    from kaldi_tpu_torch.online.threaded import \
        ThreadedSingleUtteranceDecoder
    gmm = load_gmm_system(args.model, device=args.device)
    am = load_am_nnet(args.nnet, device=args.device)
    packed = load_hclg(args.graph)
    base_dec = BeamSearchDecoder(packed, BeamSearchOpts(
        beam=args.beam, max_active=args.max_active,
        acoustic_scale=args.acoustic_scale), device=args.device)
    fo = _mfcc_opts(args, num_ceps=args.num_ceps)
    chunk = int(args.chunk_secs * args.sample_frequency)
    out = open(args.transcription_out, "w") if args.transcription_out \
        else sys.stdout
    n = 0
    for utt, path in _read_wav_scp(args.wav_scp):
        wave, _sr = read_wave(path)
        w = wave[0]
        pipe = OnlineNnet2FeaturePipeline(_processed_pipeline(args, fo))
        sud = SingleUtteranceNnet2Decoder(
            am, gmm.trans_model, base_dec, pipe,
            chunk_frames=args.chunk_frames)
        tsud = ThreadedSingleUtteranceDecoder(sud)
        for lo in range(0, len(w), chunk):
            tsud.accept_waveform(w[lo: lo + chunk])
        tsud.input_finished()
        if not tsud.wait(timeout=120.0):
            print(f"online2-wav-nnet2-latgen-threaded: timeout on "
                  f"{utt}", file=sys.stderr)
            continue
        res = tsud.best_path()
        words = "" if res is None else " ".join(
            gmm.lang.words.sym(x) for x in res[0])
        out.write(f"{utt} {words}\n")
        n += 1
    if args.transcription_out:
        out.close()
    print(f"online2-wav-nnet2-latgen-threaded: decoded {n} utts",
          file=sys.stderr)


def cmd_compress_uncompress_speex(args):
    """Codec round-trip on a wav.scp: streaming ADPCM (the speex role)
    encode + decode, re-synthesized wavs + scp written to a directory
    (ref: featbin/compress-uncompress-speex.cc, online/compress.py)."""
    from kaldi_tpu_torch.cli import _read_wav_scp
    from kaldi_tpu_torch.io.wave import read_wave, write_wave
    from kaldi_tpu_torch.online.compress import (AdpcmState, adpcm_decode,
                                                 adpcm_encode)
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    with open(os.path.join(args.out_dir, "wav.scp"), "w") as scp:
        for utt, path in _read_wav_scp(args.wav_scp):
            wave, sr = read_wave(path)
            outs = []
            for ch in wave:
                enc_state, dec_state = AdpcmState(), AdpcmState()
                chunks = []
                step = args.chunk_samples
                for lo in range(0, len(ch), step):
                    codes, enc_state = adpcm_encode(ch[lo: lo + step],
                                                    enc_state)
                    dec, dec_state = adpcm_decode(codes, dec_state)
                    chunks.append(dec)
                outs.append(np.concatenate(chunks) if chunks
                            else np.zeros(0))
            opath = os.path.join(args.out_dir, f"{utt}.wav")
            write_wave(opath, np.stack(outs), sr)
            scp.write(f"{utt} {opath}\n")
            n += 1
    print(f"compress-uncompress-speex: {n} utts", file=sys.stderr)


def cmd_gmm_global_init_from_feats(args):
    """Train a GMM directly on features: split-and-EM from the global
    moments, on --device (ref: gmmbin/gmm-global-init-from-feats.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import save_ubm
    from kaldi_tpu_torch.steps.ubm import DiagUbmTrainOpts, train_diag_ubm
    pooled = []
    n_frames = 0
    for _utt, feats in open_rspecifier(args.rspecifier):
        pooled.append(np.asarray(feats, np.float64))
        n_frames += len(feats)
        if args.num_frames and n_frames >= args.num_frames:
            break
    x = np.concatenate(pooled)
    if args.num_frames and len(x) > args.num_frames:
        x = x[: args.num_frames]
    ubm = train_diag_ubm(x, DiagUbmTrainOpts(
        num_gauss=args.num_gauss, num_iters=args.num_iters,
        subsample=args.subsample), device=args.device)
    save_ubm(args.model_out, ubm)
    print(f"gmm-global-init-from-feats: {ubm.num_gauss} gauss from "
          f"{len(x)} frames", file=sys.stderr)


def cmd_gmm_est_fmllr_raw(args):
    """Per-speaker fMLLR on PRE-splice/LDA raw features, on --device
    (ref: gmmbin/gmm-est-fmllr-raw.cc; the -gpost variant aliases here).
    """
    from kaldi_tpu_torch.cli import _read_utt2spk
    from kaldi_tpu_torch.io.kaldi_io import (open_rspecifier,
                                             open_wspecifier, read_ark)
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.fmllr_raw import (FmllrRawAccs,
                                                     estimate_fmllr_raw)
    model = load_gmm_system(args.model, device=args.device)
    tm = model.trans_model
    T_mat = np.asarray(next(iter(read_ark(args.full_lda_mat)))[1],
                       np.float64)
    # accept a linear [D, (L+R+1)d] matrix: append a zero offset column
    if T_mat.shape[1] % (args.splice_left + args.splice_right + 1) == 0:
        T_mat = np.concatenate([T_mat, np.zeros((T_mat.shape[0], 1))],
                               axis=1)
    raw = {k: np.asarray(v, np.float64)
           for (k, v) in open_rspecifier(args.rspecifier)}
    utt2spk = _read_utt2spk(args.utt2spk)
    d = next(iter(raw.values())).shape[1]
    by_spk: dict = {}
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        if utt not in raw:
            continue
        pdfs = tm.id2pdf_array[np.asarray(ali, np.int64)]
        spk = utt2spk.get(utt, utt)
        acc = by_spk.setdefault(spk, FmllrRawAccs(
            d, args.splice_left, args.splice_right, device=args.device))
        x = raw[utt]
        T_len = min(len(pdfs), len(x))
        acc.accumulate_from_alignment(model.am, x[:T_len], T_mat,
                                      pdfs[:T_len])
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for spk, acc in sorted(by_spk.items()):
            W, impr = estimate_fmllr_raw(acc, T_mat,
                                         min_count=args.min_count)
            out.write(spk, np.asarray(W, np.float32))
            print(f"gmm-est-fmllr-raw: {spk} impr/frame {impr:.4f}",
                  file=sys.stderr)
            n += 1
    print(f"gmm-est-fmllr-raw: {n} speakers", file=sys.stderr)


# ------------------------------------------------------------ registration

def register(sub):
    def add(name, func, *arg_specs, device=True):
        q = sub.add_parser(name)
        for (a_args, a_kw) in arg_specs:
            q.add_argument(*a_args, **a_kw)
        if device:
            q.add_argument("--device", default="cuda",
                           help="torch device (default: cuda)")
        q.set_defaults(func=func)

    def a(*args, **kw):
        return (args, kw)

    for name in ("online-server-gmm-decode-faster",
                 "online-audio-server-decode-faster"):
        add(name, cmd_online_server_gmm_decode_faster,
            a("model"), a("graph"),
            a("--host", default="127.0.0.1"),
            a("--port", type=int, default=0),
            a("--port-file", default=""),
            a("--num-connections", type=int, default=1),
            a("--beam", type=float, default=16.0),
            a("--max-active", type=int, default=7000),
            a("--acoustic-scale", type=float, default=0.1),
            a("--sample-frequency", type=float, default=16000.0),
            a("--delta-order", type=int, default=2),
            a("--chunk-frames", type=int, default=16))
    for name in ("online-audio-client", "online-net-client"):
        add(name, cmd_online_audio_client,
            a("host"), a("port", type=int), a("wav_scp"),
            a("--chunk-samples", type=int, default=4000), device=False)
    add("online2-wav-nnet2-am-compute", cmd_online2_wav_nnet2_am_compute,
        a("nnet"), a("wav_scp"), a("wspecifier"),
        a("--apply-log", action="store_true"),
        a("--sample-frequency", type=float, default=8000.0),
        a("--num-ceps", type=int, default=13),
        a("--delta-order", type=int, default=2),
        a("--chunk-secs", type=float, default=0.5))
    add("online2-wav-nnet2-latgen-threaded",
        cmd_online2_wav_nnet2_latgen_threaded,
        a("model"), a("nnet"), a("graph"), a("wav_scp"),
        a("--transcription-out", default=""),
        a("--beam", type=float, default=16.0),
        a("--max-active", type=int, default=7000),
        a("--acoustic-scale", type=float, default=0.1),
        a("--sample-frequency", type=float, default=8000.0),
        a("--num-ceps", type=int, default=13),
        a("--delta-order", type=int, default=2),
        a("--chunk-secs", type=float, default=0.5),
        a("--chunk-frames", type=int, default=16))
    add("compress-uncompress-speex", cmd_compress_uncompress_speex,
        a("wav_scp"), a("out_dir"),
        a("--chunk-samples", type=int, default=4000), device=False)
    add("gmm-global-init-from-feats", cmd_gmm_global_init_from_feats,
        a("rspecifier"), a("model_out"),
        a("--num-gauss", type=int, default=64),
        a("--num-iters", type=int, default=4),
        a("--num-frames", type=int, default=0),
        a("--subsample", type=int, default=1))
    for name in ("gmm-est-fmllr-raw", "gmm-est-fmllr-raw-gpost"):
        add(name, cmd_gmm_est_fmllr_raw,
            a("model"), a("full_lda_mat"), a("rspecifier"),
            a("ali_rspecifier"), a("wspecifier"),
            a("--splice-left", type=int, default=4),
            a("--splice-right", type=int, default=4),
            a("--utt2spk", default=""),
            a("--min-count", type=float, default=100.0))
