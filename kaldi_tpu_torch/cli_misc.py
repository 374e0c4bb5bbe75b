"""Miscellaneous utility CLI subcommands of the port (the bin/ long tail).

Counterpart of kaldi_tpu/cli_misc.py: per-frame weight algebra, silence
probabilities, MCE scaling, matrix plumbing, pfile export, VAD-driven
segmentation, two-channel CMVN statistics, the tree tools (contexts,
compiled questions, GraphViz) and the card probes. All but the probes
are host numpy, writing JAX's bytes. Registered into the main parser by
kaldi_tpu_torch.cli.main via register(sub).

(ref: bin/*.cc, featbin/*.cc, ivectorbin/create-split-from-vad.cc —
 cited per command.)
"""

from __future__ import annotations

import contextlib
import pickle
import sys

import numpy as np


# ------------------------------------------------------ weight / scalar ops

def cmd_dot_weights(args):
    """Per-utterance dot product of two weight vectors
    (ref: bin/dot-weights.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    b = {k: np.asarray(v).reshape(-1)
         for (k, v) in open_rspecifier(args.rspecifier2)}
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier1):
            if k not in b:
                continue
            d = float(np.dot(np.asarray(v).reshape(-1), b[k]))
            out.write(k, np.array([d], np.float32))
            n += 1
    print(f"dot-weights: {n} utts", file=sys.stderr)


def cmd_reverse_weights(args):
    """1.0 - weight per frame (ref: bin/reverse-weights.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.rspecifier):
            w = np.asarray(v, np.float32)
            out.write(k, (1.0 - w) if args.reverse else w)
            n += 1
    print(f"reverse-weights: {n} utts", file=sys.stderr)


def cmd_compute_mce_scale(args):
    """MCE posterior scale 4·σ(α(num−den)+β)(1−σ(·)) per utterance
    (ref: bin/compute-mce-scale.cc:66-78)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    den = {k: float(np.asarray(v).reshape(-1)[0])
           for (k, v) in open_rspecifier(args.den_rspecifier)}
    n, tot_sig = 0, 0.0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.num_rspecifier):
            if k not in den:
                continue
            num = float(np.asarray(v).reshape(-1)[0])
            diff = args.mce_alpha * (num - den[k]) + args.mce_beta
            sig = 1.0 / (1.0 + np.exp(min(diff, 30.0)))
            out.write(k, np.array([4.0 * sig * (1.0 - sig)], np.float32))
            tot_sig += sig
            n += 1
    print(f"compute-mce-scale: {n} utts, avg sigmoid "
          f"{tot_sig / max(n, 1):.4f}", file=sys.stderr)


def cmd_get_silence_probs(args):
    """Per-frame P(silence) by Bayes over silence/non-silence loglikes
    with a prior and optional quantization
    (ref: gmmbin/get-silence-probs.cc:69-118)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    nonsil = {k: np.asarray(v, np.float64).reshape(-1)
              for (k, v) in open_rspecifier(args.nonsil_rspecifier)}
    bias = np.log(args.sil_prior / (1.0 - args.sil_prior))
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, v in open_rspecifier(args.sil_rspecifier):
            if k not in nonsil:
                print(f"get-silence-probs: no non-sil likes for {k}",
                      file=sys.stderr)
                continue
            logodds = (np.asarray(v, np.float64).reshape(-1)
                       - nonsil[k] + bias)
            p = np.where(logodds > 10.0, 1.0,
                         1.0 / (1.0 + np.exp(-np.minimum(logodds, 10.0))))
            if args.quantize:
                p = args.quantize * np.floor(0.5 + p / args.quantize)
            if args.write_nonsil_probs:
                p = 1.0 - p
            out.write(k, p.astype(np.float32))
            n += 1
    print(f"get-silence-probs: {n} utts", file=sys.stderr)


# ------------------------------------------------------------- matrix ops

def cmd_duplicate_matrix(args):
    """Copy a matrix archive to several outputs
    (ref: bin/duplicate-matrix.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    with contextlib.ExitStack() as stack:
        outs = [stack.enter_context(open_wspecifier(w))
                for w in args.wspecifiers]
        n = 0
        for k, v in open_rspecifier(args.rspecifier):
            for o in outs:
                o.write(k, np.asarray(v, np.float32))
            n += 1
    print(f"duplicate-matrix: {n} x {len(args.wspecifiers)}",
          file=sys.stderr)


def cmd_matrix_logprob(args):
    """Sum of matrix[t, ali[t]] over frames, logged per utterance and
    in total; optional pass-through copy (ref: bin/matrix-logprob.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    ali = {k: np.asarray(v, np.int64).reshape(-1)
           for (k, v) in open_rspecifier(args.ali_rspecifier)}
    tot, tot_frames = 0.0, 0
    out = open_wspecifier(args.wspecifier) if args.wspecifier else None
    for k, m in open_rspecifier(args.rspecifier):
        if k not in ali:
            continue
        a = ali[k]
        lp = float(np.asarray(m)[np.arange(len(a)), a].sum())
        print(f"matrix-logprob: {k} logprob/frame "
              f"{lp / max(len(a), 1):.4f}", file=sys.stderr)
        tot += lp
        tot_frames += len(a)
        if out is not None:
            out.write(k, np.asarray(m, np.float32))
    if out is not None:
        out.close()
    print(f"matrix-logprob: total logprob/frame "
          f"{tot / max(tot_frames, 1):.4f} over {tot_frames} frames",
          file=sys.stderr)


def cmd_copy_int_vector_vector(args):
    """Ragged int-vector-vector archives, text format with ';'
    separators (ref: bin/copy-int-vector-vector.cc, the Kaldi text
    format for vector<vector<int32>>)."""
    n = 0
    src = args.rspecifier
    path = src.split(":", 1)[1] if ":" in src else src
    dst = args.wspecifier
    dpath = dst.split(":", 1)[1] if ":" in dst else dst
    with open(path) as f, open(dpath, "w") as g:
        for line in f:
            if line.strip():
                g.write(line if line.endswith("\n") else line + "\n")
                n += 1
    print(f"copy-int-vector-vector: {n} items", file=sys.stderr)


# --------------------------------------------------------- VAD / features

def cmd_create_split_from_vad(args):
    """Voiced-run segments from per-frame VAD decisions, each at most
    max-voiced frames: lines '<dst-utt> <src-utt> <first> <last>'
    (ref: ivectorbin/create-split-from-vad.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    n_segs = 0
    with open(args.segments_out, "w") as out:
        for utt, vad in open_rspecifier(args.vad_rspecifier):
            voiced = np.flatnonzero(np.asarray(vad).reshape(-1) > 0.5)
            if voiced.size == 0:
                continue
            n_chunks = int(np.ceil(voiced.size / args.max_voiced))
            for c in range(n_chunks):
                chunk = voiced[c * args.max_voiced:
                               (c + 1) * args.max_voiced]
                out.write(f"{utt}-{c:04d} {utt} {chunk[0]} "
                          f"{chunk[-1]}\n")
                n_segs += 1
    print(f"create-split-from-vad: {n_segs} segments", file=sys.stderr)


def cmd_compute_cmvn_stats_two_channel(args):
    """CMVN stats for two-channel (telephone) data: per frame the louder
    channel (first coefficient) gets weight 1, the quieter one
    quieter-channel-weight (ref:
    featbin/compute-cmvn-stats-two-channel.cc). reco2file_and_channel
    lines: <utt> <file> <A|B>."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    pairs: dict = {}
    with open(args.reco2file_and_channel) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 3:
                pairs.setdefault(toks[1], {})[toks[2]] = toks[0]
    feats = {k: np.asarray(v, np.float64)
             for (k, v) in open_rspecifier(args.rspecifier)}
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for fname, chans in sorted(pairs.items()):
            utts = sorted(chans.items())
            if len(utts) != 2:
                # single-channel recording: plain CMVN stats
                for _c, utt in utts:
                    if utt not in feats:
                        continue
                    x = feats[utt]
                    out.write(utt, _cmvn_stats(x, np.ones(len(x))))
                    n += 1
                continue
            (_c1, u1), (_c2, u2) = utts
            if u1 not in feats or u2 not in feats:
                continue
            x1, x2 = feats[u1], feats[u2]
            T = min(len(x1), len(x2))
            louder1 = x1[:T, 0] > x2[:T, 0]
            w1 = np.where(louder1, 1.0, args.quieter_channel_weight)
            w2 = np.where(louder1, args.quieter_channel_weight, 1.0)
            out.write(u1, _cmvn_stats(x1[:T], w1))
            out.write(u2, _cmvn_stats(x2[:T], w2))
            n += 2
    print(f"compute-cmvn-stats-two-channel: {n} utts", file=sys.stderr)


def _cmvn_stats(x, w):
    """Weighted CMVN stats in the standard [2, D+1] layout."""
    D = x.shape[1]
    st = np.zeros((2, D + 1))
    st[0, :D] = (w[:, None] * x).sum(axis=0)
    st[0, D] = w.sum()
    st[1, :D] = (w[:, None] * x * x).sum(axis=0)
    return st.astype(np.float32)


# ------------------------------------------------------------ trees

def cmd_build_pfile_from_ali(args):
    """Per-frame '<feat values> <pdf label>' text rows grouped per
    utterance — the ICSI pfile payload the reference pipes into
    pfile_create (ref: bin/build-pfile-from-ali.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    tm = load_gmm_system(args.model, device="cpu").trans_model
    ali = {k: np.asarray(v, np.int64).reshape(-1)
           for (k, v) in open_rspecifier(args.ali_rspecifier)}
    n = 0
    with open(args.pfile_out, "w") as out:
        for sent, (utt, feats) in enumerate(
                open_rspecifier(args.rspecifier)):
            if utt not in ali:
                continue
            pdfs = tm.id2pdf_array[ali[utt]]
            T = min(len(pdfs), feats.shape[0])
            for t in range(T):
                row = " ".join(f"{v:.6g}" for v in feats[t])
                out.write(f"{sent} {t} {row} {pdfs[t]}\n")
            n += 1
    print(f"build-pfile-from-ali: {n} utts", file=sys.stderr)


def cmd_extract_ctx(args):
    """Map phone-in-context events (from tree stats) to pdf-ids: lines
    '<pdf-id> <pdf-class> <left> <center> <right>'
    (ref: bin/extract-ctx.cc)."""
    from kaldi_tpu_torch.io.model_io import load_tree, load_tree_stats
    from kaldi_tpu_torch.tree.build_tree import KPDF_CLASS
    stats, N, P = load_tree_stats(args.tree_stats)
    ctx = load_tree(args.tree)
    syms = {}
    if args.phone_symbols:
        with open(args.phone_symbols) as f:
            for line in f:
                toks = line.split()
                if len(toks) >= 2:
                    syms[int(toks[1])] = toks[0]
    lines = []
    for ev in stats:
        e = dict(ev)
        pdf_class = e.pop(KPDF_CLASS)
        window = [e[pos] for pos in sorted(e)]
        pdf = ctx.event_map.map(dict(ev)) if hasattr(ctx, "event_map") \
            else ctx.compute(window, pdf_class)
        if pdf is None:
            continue
        phones = " ".join(syms.get(p, str(p)) for p in window)
        lines.append((pdf, f"{pdf} {pdf_class} {phones}"))
    for _pdf, line in sorted(lines):
        print(line)
    print(f"extract-ctx: {len(lines)} events", file=sys.stderr)


def cmd_compile_questions(args):
    """Questions text (one phone set per line) + pdf-class refinement
    -> pickled Questions object consumable by build-tree
    (ref: bin/compile-questions.cc)."""
    from kaldi_tpu_torch.io.model_io import JaxNamePickler
    from kaldi_tpu_torch.tree.build_tree import Questions
    qsets = []
    with open(args.questions_text) as f:
        for line in f:
            toks = line.split()
            if toks:
                qsets.append([int(t) for t in toks])
    q = Questions(qsets, num_pdf_classes=args.num_pdf_classes,
                  N=args.context_width, P=args.central_position)
    with open(args.questions_out, "wb") as f:
        JaxNamePickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(q)
    print(f"compile-questions: {len(qsets)} phone questions, "
          f"{args.num_pdf_classes} pdf-classes", file=sys.stderr)


def cmd_draw_tree(args):
    """GraphViz description of the decision tree
    (ref: bin/draw-tree.cc)."""
    from kaldi_tpu_torch.io.model_io import load_tree
    from kaldi_tpu_torch.tree.event_map import (ConstantEventMap,
                                                SplitEventMap,
                                                TableEventMap)
    from kaldi_tpu_torch.tree.build_tree import KPDF_CLASS
    syms = {}
    with open(args.phone_symbols) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                syms[int(toks[1])] = toks[0]
    ctx = load_tree(args.tree)
    em = getattr(ctx, "event_map", None)
    lines = ["digraph tree {", "node [shape=box];"]
    counter = [0]

    def keyname(key):
        return "pdf-class" if key == KPDF_CLASS else f"ctx{key}"

    def phset(s):
        return ",".join(syms.get(p, str(p)) for p in sorted(s))

    def walk(node):
        nid = counter[0]
        counter[0] += 1
        if isinstance(node, ConstantEventMap):
            lines.append(f'n{nid} [label="pdf {node.answer}", '
                         f'shape=ellipse];')
        elif isinstance(node, SplitEventMap):
            lines.append(f'n{nid} [label="{keyname(node.key)} in '
                         f'{{{phset(node.yes_set)}}}?"];')
            yid = walk(node.yes)
            lines.append(f'n{nid} -> n{yid} [label="yes"];')
            nid2 = walk(node.no)
            lines.append(f'n{nid} -> n{nid2} [label="no"];')
        elif isinstance(node, TableEventMap):
            lines.append(f'n{nid} [label="table on '
                         f'{keyname(node.key)}"];')
            for val, child in sorted(node.table.items()):
                cid = walk(child)
                lines.append(
                    f'n{nid} -> n{cid} '
                    f'[label="{syms.get(val, str(val))}"];')
        else:
            lines.append(f'n{nid} [label="{type(node).__name__}"];')
        return nid

    if em is not None:
        walk(em)
    else:
        # monophone tree: one leaf block per phone
        lines.append('n0 [label="monophone tree"];')
    lines.append("}")
    print("\n".join(lines))


# --------------------------------------------------------- device probes

def cmd_cuda_compiled(args):
    """Exit 0 iff this torch was built with CUDA
    (ref: bin/cuda-compiled.cc)."""
    import torch
    print(f"cuda-compiled: torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", file=sys.stderr)
    raise SystemExit(0 if torch.version.cuda else 1)


def cmd_cuda_gpu_available(args):
    """Exit 0 iff a tensor can be made on cuda:0 right now
    (ref: nnet2bin/cuda-gpu-available.cc)."""
    import torch
    try:
        x = torch.zeros(1, device="cuda:0")
        torch.cuda.synchronize()
        print(f"cuda-gpu-available: {x.device} "
              f"{torch.cuda.get_device_name(0)}", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 — probe must not crash
        print(f"cuda-gpu-available: probe failed: {e}", file=sys.stderr)
        raise SystemExit(1)
    raise SystemExit(0)


# ------------------------------------------------------------ registration

def cmd_ivector_randomize(args):
    """With probability p, replace online-ivector row t by a row drawn
    uniformly from [t, T) — training-time robustness to the amount of
    accumulated context (ref: online2bin/ivector-randomize.cc); numpy's
    RandomState, so JAX's draws."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    rng = np.random.RandomState(args.srand)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for k, m in open_rspecifier(args.rspecifier):
            m = np.asarray(m, np.float32)
            T = m.shape[0]
            res = m.copy()
            for t in range(T):
                if rng.uniform() <= args.randomize_prob:
                    res[t] = m[rng.randint(t, T)]
            out.write(k, res)
            n += 1
    print(f"ivector-randomize: {n} matrices", file=sys.stderr)


def register(sub):
    def add(name, func, *arg_specs):
        q = sub.add_parser(name)
        for (a_args, a_kw) in arg_specs:
            q.add_argument(*a_args, **a_kw)
        q.set_defaults(func=func)

    def a(*args, **kw):
        return (args, kw)

    add("ivector-randomize", cmd_ivector_randomize,
        a("rspecifier"), a("wspecifier"),
        a("--randomize-prob", type=float, default=0.5),
        a("--srand", type=int, default=0))
    add("dot-weights", cmd_dot_weights,
        a("rspecifier1"), a("rspecifier2"), a("wspecifier"))
    add("reverse-weights", cmd_reverse_weights,
        a("rspecifier"), a("wspecifier"),
        a("--reverse", type=lambda s: s != "false", default=True))
    add("compute-mce-scale", cmd_compute_mce_scale,
        a("num_rspecifier"), a("den_rspecifier"), a("wspecifier"),
        a("--mce-alpha", type=float, default=1.0),
        a("--mce-beta", type=float, default=0.0))
    add("get-silence-probs", cmd_get_silence_probs,
        a("sil_rspecifier"), a("nonsil_rspecifier"), a("wspecifier"),
        a("--sil-prior", type=float, default=0.5),
        a("--quantize", type=float, default=0.0),
        a("--write-nonsil-probs", action="store_true"))
    add("duplicate-matrix", cmd_duplicate_matrix,
        a("rspecifier"), a("wspecifiers", nargs="+"))
    add("matrix-logprob", cmd_matrix_logprob,
        a("rspecifier"), a("ali_rspecifier"),
        a("wspecifier", nargs="?", default=""))
    add("copy-int-vector-vector", cmd_copy_int_vector_vector,
        a("rspecifier"), a("wspecifier"))
    add("create-split-from-vad", cmd_create_split_from_vad,
        a("vad_rspecifier"), a("segments_out"),
        a("--max-voiced", type=int, default=9000))
    add("compute-cmvn-stats-two-channel",
        cmd_compute_cmvn_stats_two_channel,
        a("reco2file_and_channel"), a("rspecifier"), a("wspecifier"),
        a("--quieter-channel-weight", type=float, default=0.01))
    add("build-pfile-from-ali", cmd_build_pfile_from_ali,
        a("model"), a("ali_rspecifier"), a("rspecifier"), a("pfile_out"))
    add("extract-ctx", cmd_extract_ctx,
        a("tree_stats"), a("tree"),
        a("--phone-symbols", default=""))
    add("compile-questions", cmd_compile_questions,
        a("questions_text"), a("questions_out"),
        a("--num-pdf-classes", type=int, default=3),
        a("--context-width", type=int, default=3),
        a("--central-position", type=int, default=1))
    add("draw-tree", cmd_draw_tree, a("phone_symbols"), a("tree"))
    add("cuda-compiled", cmd_cuda_compiled)
    add("cuda-gpu-available", cmd_cuda_gpu_available)
