"""Command-line entry points of the port (counterpart of kaldi_tpu/cli.py).

    python -m kaldi_tpu_torch.cli recipe-yesno [--device cpu]
    python -m kaldi_tpu_torch.cli online-audio-server-decode-faster \
        final.mdl HCLG.npz --port-file port --num-connections 2
    python -m kaldi_tpu_torch.cli online-audio-client 127.0.0.1 PORT wav.scp

Ported so far: `recipe-yesno` and the online / onlinebin subcommands of
kaldi_tpu/cli_online_extra.py (`cli_online_extra.py`), which read and
write the JAX package's model files. Every command that touches a model
runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_tpu_torch import cli_online_extra


def _read_wav_scp(path):
    """wav.scp lines -> (utt, path) pairs."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                yield parts


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
    B = len(tests)
    T = max(f.shape[0] for (_u, f, _w) in tests)
    D = tests[0][1].shape[1]
    feats = np.zeros((B, T, D), np.float32)
    nf = np.zeros(B, np.int32)
    for b, (_u, f, _w) in enumerate(tests):
        feats[b, : f.shape[0]] = f
        nf[b] = f.shape[0]
    results = dec.decode(model.am.loglikes(feats), nf)
    refs, hyps = {}, {}
    for b, (u, _f, ws) in enumerate(tests):
        refs[u] = ws
        hyps[u] = ([lang.words.sym(w) for w in results[b][0]]
                   if results[b] else [])
    stats = compute_wer(refs, hyps)
    print(stats)
    return 1 if stats.wer > 0 else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kaldi_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("recipe-yesno", help="synthetic yesno: features -> "
                       "mono training -> HCLG -> decode -> WER (exits 1 "
                       "unless WER == 0)")
    s.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    s.set_defaults(func=cmd_recipe_yesno)
    cli_online_extra.register(sub)
    args = p.parse_args(argv)
    rc = args.func(args)
    if rc:
        sys.exit(rc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
