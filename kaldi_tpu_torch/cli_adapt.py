"""Adaptation and decode-variant CLI subcommands (counterpart of
kaldi_tpu/cli_adapt.py), registered into the main parser by
kaldi_tpu_torch.cli.main via register(sub).

Global-GMM fMLLR / LVTLN / MLLT, HLDA, fMLLR-basis accumulation,
regression-tree MLLR / fMLLR estimation and decoding, N-best decoding,
MAP-adapted decoding and lattice-tracking decoding. The global-GMM
statistics and the fMLLR solves are host f64 as in JAX (the UBM scores on
the host there too), and so are get-full-lda-mat and lattice-arcgraph;
every command that scores an acoustic model, accumulates on one or solves
a device class (LVTLN, HLDA, the basis, the regression tree) or searches
takes `--device` (default: cuda, `DEVICE_COMMANDS`).

(ref: gmmbin/*.cc, featbin/get-full-lda-mat.cc — cited per command.)
"""

from __future__ import annotations

import sys

import numpy as np

from kaldi_tpu_torch.device import resolve_device

# the subcommands that build a device object (`--device`)
DEVICE_COMMANDS = (
    "gmm-global-est-lvtln-trans", "gmm-acc-hlda", "gmm-est-hlda",
    "gmm-basis-fmllr-accs", "gmm-basis-fmllr-accs-gpost",
    "gmm-est-regtree-mllr", "gmm-est-regtree-fmllr-ali",
    "gmm-decode-faster-regtree-fmllr", "gmm-decode-faster-regtree-mllr",
    "gmm-latgen-faster-regtree-fmllr", "gmm-decode-nbest", "gmm-latgen-map",
    "gmm-latgen-tracking", "latgen-tracking-mapped")


def _ubm_diag(path):
    """load_ubm as a DiagGmm (full covariances diagonalized: the fMLLR /
    MLLT stats here are diagonal-model statistics)."""
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(path)
    return ubm.to_diag() if isinstance(ubm, FullGmm) else ubm


def _by_spk_global_fmllr_stats(ubm, rspecifier, utt2spk_path):
    """Per-speaker FmllrStats against a global GMM, host f64."""
    from kaldi_tpu_torch.cli import _read_utt2spk
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.transform.fmllr import FmllrStats
    utt2spk = _read_utt2spk(utt2spk_path)
    by_spk: dict = {}
    for utt, feats in open_rspecifier(rspecifier):
        x = np.asarray(feats, np.float64)
        spk = utt2spk.get(utt, utt)
        st = by_spk.setdefault(spk, FmllrStats(x.shape[1]))
        post = np.asarray(ubm.posteriors(x.astype(np.float32)), np.float64)
        st.accumulate(x, ubm.means, ubm.vars, post)
    return by_spk


def cmd_gmm_est_fmllr_global(args):
    """Per-speaker fMLLR against a single global GMM — posteriors come
    from the GMM itself, no alignment needed; host f64
    (ref: gmmbin/gmm-est-fmllr-global.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.transform.fmllr import estimate_fmllr
    ubm = _ubm_diag(args.model)
    by_spk = _by_spk_global_fmllr_stats(ubm, args.rspecifier, args.utt2spk)
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for spk, st in sorted(by_spk.items()):
            W, impr, count = estimate_fmllr(st, min_count=args.min_count)
            out.write(spk, np.asarray(W, np.float32))
            print(f"gmm-est-fmllr-global: {spk} impr/frame "
                  f"{impr / max(count, 1.0):.4f}", file=sys.stderr)
            n += 1
    print(f"gmm-est-fmllr-global: {n} speakers", file=sys.stderr)


def cmd_gmm_global_est_lvtln_trans(args):
    """Per-speaker LVTLN class selection against a global GMM, the
    selection on the device (ref: gmmbin/gmm-global-est-lvtln-trans.cc)."""
    from kaldi_tpu_torch.cli import _load_lvtln, _write_lvtln_choices
    dev = resolve_device(args.device)
    ubm = _ubm_diag(args.model)
    lv = _load_lvtln(args.lvtln, dev)
    by_spk = _by_spk_global_fmllr_stats(ubm, args.rspecifier, args.utt2spk)
    _write_lvtln_choices("gmm-global-est-lvtln-trans", lv, by_spk,
                         args.wspecifier)


def cmd_gmm_acc_mllt_global(args):
    """Global-STC stats from a single GMM, host f64 as in JAX
    (ref: gmmbin/gmm-acc-mllt-global.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.transform.mllt import MlltStats
    ubm = _ubm_diag(args.model)
    stats = MlltStats(ubm.dim)
    n = 0
    for _utt, feats in open_rspecifier(args.rspecifier):
        x = np.asarray(feats, np.float64)
        post = np.asarray(ubm.posteriors(x.astype(np.float32)),
                          np.float64)
        stats.accumulate(x, ubm.means, ubm.vars, post)
        n += 1
    with open(args.accs_out, "wb") as f:
        np.savez(f, G=stats.G, beta=np.float64(stats.beta))
    print(f"gmm-acc-mllt-global: {n} utts, beta {stats.beta:.0f}",
          file=sys.stderr)


def cmd_gmm_acc_hlda(args):
    """HLDA stats from alignments on the device: class = aligned pdf
    (ref: gmmbin/gmm-acc-hlda.cc). Writes JAX's npz."""
    from kaldi_tpu_torch.cli import _to_host
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.hlda import HldaStats
    dev = resolve_device(args.device)
    model = load_gmm_system(args.model, device="cpu")
    tm = model.trans_model
    feats = dict(open_rspecifier(args.rspecifier))
    stats = None
    n = 0
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        if utt not in feats:
            continue
        x = np.asarray(feats[utt], np.float64)
        if stats is None:
            stats = HldaStats(x.shape[1], device=dev)
        pdfs = tm.id2pdf_array[np.asarray(ali, np.int64)]
        T = min(len(pdfs), len(x))
        stats.accumulate(x[:T], pdfs[:T], model.am.num_pdfs)
        n += 1
    if stats is None:
        raise SystemExit("gmm-acc-hlda: no utterances")
    with open(args.accs_out, "wb") as f:
        np.savez(f, beta=np.float64(stats.beta),
                 mean_acc=_to_host(stats.mean_acc),
                 total_2nd=_to_host(stats.total_2nd),
                 class_beta=_to_host(stats.class_beta),
                 class_mean_acc=_to_host(stats.class_mean_acc))
    print(f"gmm-acc-hlda: {n} utts", file=sys.stderr)


def cmd_gmm_est_hlda(args):
    """HLDA transform from summed stats, on the device
    (ref: gmmbin/gmm-est-hlda.cc, transform/hlda.h)."""
    import torch

    from kaldi_tpu_torch.io.kaldi_io import write_ark
    from kaldi_tpu_torch.transform.hlda import HldaStats, estimate_hlda
    dev = resolve_device(args.device)
    stats = None
    for p in args.accs_in:
        z = np.load(p)
        if stats is None:
            stats = HldaStats(z["mean_acc"].shape[0], device=dev)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                      device=stats.device)
        stats.beta += float(z["beta"])
        stats.mean_acc += t(z["mean_acc"])
        stats.total_2nd += t(z["total_2nd"])
        cb, cm = t(z["class_beta"]), t(z["class_mean_acc"])
        extra = len(cb) - len(stats.class_beta)
        if extra > 0:
            stats.class_beta = torch.cat(
                [stats.class_beta, stats.class_beta.new_zeros(extra)])
            stats.class_mean_acc = torch.cat(
                [stats.class_mean_acc,
                 stats.class_mean_acc.new_zeros((extra, stats.dim))])
        stats.class_beta[:len(cb)] += cb
        stats.class_mean_acc[:len(cb)] += cm
    A, impr = estimate_hlda(stats, args.keep_dims)
    write_ark(args.transform_out, {"hlda": np.asarray(A, np.float32)})
    print(f"gmm-est-hlda: [{A.shape[0]} x {A.shape[1]}], objf impr "
          f"{impr:.4f}/frame", file=sys.stderr)


def cmd_gmm_basis_fmllr_accs(args):
    """Per-speaker fMLLR gradient scatter for basis training, on the
    device (ref: gmmbin/gmm-basis-fmllr-accs.cc; the -gpost variant takes
    the same pre-computed posteriors)."""
    from kaldi_tpu_torch.cli import _basis_accus, _fmllr_stats_by_spk, _to_host
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = load_gmm_system(args.model, device=resolve_device(args.device))
    by_spk = _fmllr_stats_by_spk(model, args.rspecifier, args.post_in,
                                 args.utt2spk)
    accus = _basis_accus(model, by_spk)
    with open(args.accs_out, "wb") as f:
        np.savez(f, grad_scatter=_to_host(accus.grad_scatter),
                 H=_to_host(accus.H), beta=np.float64(accus.beta),
                 dim=np.int64(accus.dim))
    print(f"gmm-basis-fmllr-accs: {len(by_spk)} speakers",
          file=sys.stderr)


def cmd_get_full_lda_mat(args):
    """LDA+MLLT rows + the remaining rows of the full LDA matrix, plus
    the inverse (ref: featbin/get-full-lda-mat.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark
    lda_mllt = np.asarray(next(iter(read_ark(args.lda_mllt)))[1],
                          np.float64)
    full = np.asarray(next(iter(read_ark(args.full_lda)))[1], np.float64)
    d = lda_mllt.shape[0]
    D = full.shape[0]
    # accept affine [d, D+1] LDA+MLLT rows: keep the linear part only
    out = np.concatenate([lda_mllt[:, :D], full[d:]], axis=0)
    write_ark(args.full_out, {"full_lda_mllt": out.astype(np.float32)})
    if args.inv_out:
        write_ark(args.inv_out,
                  {"inv": np.linalg.inv(out).astype(np.float32)})
    print(f"get-full-lda-mat: [{D} x {D}]", file=sys.stderr)


# -------------------------------------------------------- regtree tools

def cmd_gmm_est_regtree_mllr(args):
    """Per-speaker regression-tree MLLR mean transforms, statistics and
    row solves on the device (ref: gmmbin/gmm-est-regtree-mllr.cc)."""
    from kaldi_tpu_torch.cli import (_load_regtree, _post_to_pdf_post,
                                     _read_utt2spk, _stack_by_leaf)
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.transform.regtree import (RegtreeMllrStats,
                                                   estimate_regtree_mllr)
    dev = resolve_device(args.device)
    model = load_gmm_system(args.model, device=dev)
    tree = _load_regtree(args.regtree, dev)
    utt2spk = _read_utt2spk(args.utt2spk)
    feats = dict(open_rspecifier(args.rspecifier))
    by_spk: dict = {}
    D = model.am.dim
    for utt, post in read_post_ark(args.post_in):
        if utt not in feats:
            continue
        spk = utt2spk.get(utt, utt)
        acc = by_spk.setdefault(spk, RegtreeMllrStats(tree, D))
        acc.accumulate(model.am, np.asarray(feats[utt], np.float64),
                       _post_to_pdf_post(post, model.trans_model))
    n = 0
    leaves = sorted({int(lf) for lf in tree.gauss2leaf})
    with open_wspecifier(args.wspecifier) as out:
        for spk, acc in sorted(by_spk.items()):
            xf = estimate_regtree_mllr(acc, min_count=args.min_count)
            out.write(spk, _stack_by_leaf(tree, xf, leaves)
                      .astype(np.float32))
            n += 1
    print(f"gmm-est-regtree-mllr: {n} speakers", file=sys.stderr)


def cmd_gmm_est_regtree_fmllr_ali(args):
    """Regression-tree fMLLR from hard alignments
    (ref: gmmbin/gmm-est-regtree-fmllr-ali.cc): alignments -> posts,
    then the posterior-driven estimator."""
    import argparse as _ap
    import tempfile

    from kaldi_tpu_torch.cli import cmd_gmm_est_regtree_fmllr
    from kaldi_tpu_torch.hmm.posterior import write_post_line
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    resolve_device(args.device)
    with tempfile.NamedTemporaryFile("w", suffix=".post",
                                     delete=False) as f:
        for utt, ali in open_rspecifier(args.ali_rspecifier):
            write_post_line(f, utt, [[(int(t), 1.0)]
                                     for t in np.asarray(ali, np.int64)])
        post_path = f.name
    fwd = _ap.Namespace(model=args.model, regtree=args.regtree,
                        rspecifier=args.rspecifier, post_in=post_path,
                        wspecifier=args.wspecifier, utt2spk=args.utt2spk,
                        min_count=args.min_count, device=args.device)
    cmd_gmm_est_regtree_fmllr(fwd)


def _regtree_decode(args, mode: str):
    """Shared regtree-adapted decode: per-speaker transforms give adapted
    loglikes on the device, then the standard latgen tail."""
    from kaldi_tpu_torch.cli import (_latgen_from_loglikes, _load_regtree,
                                     _read_utt2spk, _to_host)
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, read_ark
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    from kaldi_tpu_torch.transform.regtree import (apply_regtree_mllr,
                                                   regtree_fmllr_loglikes,
                                                   unstack_transforms)
    dev = resolve_device(args.device)
    model = load_gmm_system(args.model, device=dev)
    tree = _load_regtree(args.regtree, dev)
    packed = load_hclg(args.graph)
    utt2spk = _read_utt2spk(args.utt2spk)
    trans = {k: np.asarray(v, np.float64)
             for (k, v) in read_ark(args.transforms)}
    items = list(open_rspecifier(args.rspecifier))
    D = model.am.dim
    B = len(items)
    T = max(f.shape[0] for (_k, f) in items)
    ll = np.full((B, T, model.am.num_pdfs), -1e10, np.float32)
    nf = np.zeros(B, np.int32)
    adapted_cache: dict = {}
    for b, (k, f) in enumerate(items):
        spk = utt2spk.get(k, k)
        nf[b] = f.shape[0]
        if spk not in trans:
            ll[b, : nf[b]] = model.am.loglikes_np(
                f.astype(np.float32)[None])[0]
            continue
        by_leaf = unstack_transforms(tree, trans[spk], D)
        if mode == "fmllr":
            ll[b, : nf[b]] = _to_host(regtree_fmllr_loglikes(
                model.am, tree, by_leaf, f)).astype(np.float32)
        else:
            am = adapted_cache.get(spk)
            if am is None:
                am = apply_regtree_mllr(model.am, tree, by_leaf)
                adapted_cache[spk] = am
            ll[b, : nf[b]] = am.loglikes_np(f.astype(np.float32)[None])[0]
    _latgen_from_loglikes(packed, [k for (k, _f) in items], ll, nf, args,
                          dev, sym=model.lang.words.sym)


def cmd_gmm_decode_faster_regtree_fmllr(args):
    """(ref: gmmbin/gmm-decode-faster-regtree-fmllr.cc)"""
    _regtree_decode(args, "fmllr")


def cmd_gmm_decode_faster_regtree_mllr(args):
    """(ref: gmmbin/gmm-decode-faster-regtree-mllr.cc)"""
    _regtree_decode(args, "mllr")


def cmd_gmm_latgen_faster_regtree_fmllr(args):
    """(ref: gmmbin/gmm-latgen-faster-regtree-fmllr.cc)"""
    _regtree_decode(args, "fmllr")


# ------------------------------------------------------- decode variants

def cmd_gmm_decode_nbest(args):
    """N-best decoding on the device: lattices -> top-N paths, keys
    '<utt>-<rank>' (ref: gmmbin/gmm-decode-nbest.cc)."""
    from kaldi_tpu_torch.cli import _beam_opts, _gmm_loglikes
    from kaldi_tpu_torch.decoder.beam_search import BeamSearchDecoder
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    from kaldi_tpu_torch.lat.functions import nbest as lat_nbest
    from kaldi_tpu_torch.lat.generate import decode_to_lattices
    dev = resolve_device(args.device)
    model = load_gmm_system(args.model, device=dev)
    packed = load_hclg(args.graph)
    items = list(open_rspecifier(args.rspecifier))
    ll, nf = _gmm_loglikes(model, items)
    dec = BeamSearchDecoder(packed, _beam_opts(args), device=dev)
    lats = decode_to_lattices(dec, ll, nf, lattice_beam=args.lattice_beam)
    out = open(args.transcription_out, "w") if args.transcription_out \
        else sys.stdout
    for b, (k, _f) in enumerate(items):
        if lats[b] is None:
            continue
        for rank, (words, _tids, _cost) in enumerate(
                lat_nbest(lats[b], args.n)):
            txt = " ".join(model.lang.words.sym(w) for w in words)
            out.write(f"{k}-{rank + 1} {txt}\n")
    if args.transcription_out:
        out.close()
    print(f"gmm-decode-nbest: {len(items)} utts", file=sys.stderr)


def cmd_gmm_latgen_map(args):
    """Latgen on the device with per-speaker MAP-adapted models from a
    gmm-adapt-map output directory (ref: gmmbin/gmm-latgen-map.cc)."""
    import os

    from kaldi_tpu_torch.cli import _latgen_from_loglikes, _read_utt2spk
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_hclg
    dev = resolve_device(args.device)
    model = load_gmm_system(args.model, device=dev)
    packed = load_hclg(args.graph)
    utt2spk = _read_utt2spk(args.utt2spk)
    items = list(open_rspecifier(args.rspecifier))
    B = len(items)
    T = max(f.shape[0] for (_k, f) in items)
    ll = np.full((B, T, model.am.num_pdfs), -1e10, np.float32)
    nf = np.zeros(B, np.int32)
    cache: dict = {}
    for b, (k, f) in enumerate(items):
        spk = utt2spk.get(k, k)
        nf[b] = f.shape[0]
        m = cache.get(spk)
        if m is None:
            p = os.path.join(args.gmms_dir, f"{spk}.npz")
            m = load_gmm_system(p, device=dev) if os.path.exists(p) \
                else model
            cache[spk] = m
        ll[b, : nf[b]] = m.am.loglikes_np(f.astype(np.float32)[None])[0]
    _latgen_from_loglikes(packed, [k for (k, _f) in items], ll, nf, args,
                          dev, sym=model.lang.words.sym)


def cmd_lattice_arcgraph(args):
    """Project lattices onto per-utterance arc graphs (tid acceptors,
    costs dropped) for tracking decodes (ref: latbin/lattice-arcgraph.cc
    — the reference tracks HCLG arc ids; the tid projection spans the
    same search space for the tracking pass)."""
    from kaldi_tpu_torch.cli_fst import _write_fst_ark
    from kaldi_tpu_torch.fst.fst import Fst
    from kaldi_tpu_torch.lat.io import read_lattice_ark
    out = []
    for key, lat in read_lattice_ark(args.lattice_ark):
        f = Fst()
        for _ in range(lat.num_states):
            f.add_state()
        f.start = lat.start
        for s in range(lat.num_states):
            for a in lat.arcs[s]:
                f.add_arc(s, a.ilabel, a.olabel, 0.0, a.nextstate)
        for s in lat.finals:
            f.set_final(s, 0.0)
        out.append((key, f))
    _write_fst_ark(args.arcs_out, out)
    print(f"lattice-arcgraph: {len(out)} graphs", file=sys.stderr)


def _latgen_tracking(args, ll_by_utt, model, dev):
    """Tracking decode on the device: per-utterance graphs from first-pass
    arc graphs (the search restricted to the first pass's arcs, widened
    by the extra beam) (ref: gmmbin/gmm-latgen-tracking.cc,
    decoder/lattice-tracking-decoder.h)."""
    from kaldi_tpu_torch.cli_fst import _read_fst_ark, _strip_ark
    from kaldi_tpu_torch.decoder.beam_search import (BeamSearchDecoder,
                                                     BeamSearchOpts)
    from kaldi_tpu_torch.decoder.graph_pack import pack_graph
    from kaldi_tpu_torch.lat.functions import lattice_best_path
    from kaldi_tpu_torch.lat.generate import decode_to_lattices
    from kaldi_tpu_torch.lat.io import write_lattice_ark
    arcs = dict(_read_fst_ark(_strip_ark(args.arcs_rspecifier)))
    keys = [k for k in ll_by_utt if k in arcs]
    if not keys:
        raise SystemExit("latgen-tracking: no utterances joined")
    opts = BeamSearchOpts(
        beam=args.beam + args.extra_beam, max_active=args.max_active,
        acoustic_scale=args.acoustic_scale)
    lats = []
    for k in keys:
        # the first pass's arc set is the search space: each utterance
        # decodes against its own packed graph
        packed = pack_graph(arcs[k], model.trans_model.id2pdf_array)
        x = ll_by_utt[k][None]
        dec = BeamSearchDecoder(packed, opts, device=dev)
        lats.extend(decode_to_lattices(
            dec, x, np.array([x.shape[1]], np.int32),
            lattice_beam=args.lattice_beam))
    if args.lattice_out:
        write_lattice_ark(args.lattice_out, dict(zip(keys, lats)))
    out = open(args.transcription_out, "w") if args.transcription_out \
        else sys.stdout
    for k, lat in zip(keys, lats):
        if lat is None:
            out.write(f"{k}\n")
            continue
        res = lattice_best_path(lat)
        ws = res[0] if res else []
        out.write(f"{k} " + " ".join(
            model.lang.words.sym(w) for w in ws) + "\n")
    if args.transcription_out:
        out.close()
    print(f"latgen-tracking: {len(keys)} utts", file=sys.stderr)


def cmd_gmm_latgen_tracking(args):
    """(ref: gmmbin/gmm-latgen-tracking.cc) Loglikes on the device."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = resolve_device(args.device)
    model = load_gmm_system(args.model, device=dev)
    ll = {utt: model.am.loglikes_np(np.asarray(f, np.float32)[None])[0]
          for utt, f in open_rspecifier(args.rspecifier)}
    _latgen_tracking(args, ll, model, dev)


def cmd_latgen_tracking_mapped(args):
    """(ref: gmmbin/latgen-tracking-mapped.cc — loglikes in directly)"""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    dev = resolve_device(args.device)
    ll = {utt: np.asarray(x, np.float32)
          for (utt, x) in open_rspecifier(args.rspecifier)}
    _latgen_tracking(args, ll, load_gmm_system(args.model, device="cpu"),
                     dev)


# ------------------------------------------------------------ registration

def register(sub):
    def add(name, func, *arg_specs):
        q = sub.add_parser(name)
        for (a_args, a_kw) in arg_specs:
            q.add_argument(*a_args, **a_kw)
        q.set_defaults(func=func)

    def a(*args, **kw):
        return (args, kw)

    def decode_opts(*extra):
        return (a("--beam", type=float, default=16.0),
                a("--max-active", type=int, default=7000),
                a("--acoustic-scale", type=float, default=0.1),
                a("--lattice-beam", type=float, default=10.0),
                a("--determinize-lattice", action="store_true"),
                a("--lattice-out", default=""),
                a("--transcription-out", default=""), *extra)

    for name in ("gmm-est-fmllr-global", "gmm-global-est-fmllr"):
        add(name, cmd_gmm_est_fmllr_global,
            a("model"), a("rspecifier"), a("wspecifier"),
            a("--utt2spk", default=""),
            a("--min-count", type=float, default=100.0))
    add("gmm-global-est-lvtln-trans", cmd_gmm_global_est_lvtln_trans,
        a("model"), a("lvtln"), a("rspecifier"), a("wspecifier"),
        a("--utt2spk", default=""))
    add("gmm-acc-mllt-global", cmd_gmm_acc_mllt_global,
        a("model"), a("rspecifier"), a("accs_out"))
    add("gmm-acc-hlda", cmd_gmm_acc_hlda,
        a("model"), a("rspecifier"), a("ali_rspecifier"), a("accs_out"))
    add("gmm-est-hlda", cmd_gmm_est_hlda,
        a("transform_out"), a("accs_in", nargs="+"),
        a("--keep-dims", type=int, default=40))
    for name in ("gmm-basis-fmllr-accs", "gmm-basis-fmllr-accs-gpost"):
        add(name, cmd_gmm_basis_fmllr_accs,
            a("model"), a("rspecifier"), a("post_in"), a("accs_out"),
            a("--utt2spk", default=""))
    add("get-full-lda-mat", cmd_get_full_lda_mat,
        a("lda_mllt"), a("full_lda"), a("full_out"),
        a("inv_out", nargs="?", default=""))
    add("gmm-est-regtree-mllr", cmd_gmm_est_regtree_mllr,
        a("model"), a("regtree"), a("rspecifier"), a("post_in"),
        a("wspecifier"),
        a("--utt2spk", default=""),
        a("--min-count", type=float, default=200.0))
    add("gmm-est-regtree-fmllr-ali", cmd_gmm_est_regtree_fmllr_ali,
        a("model"), a("regtree"), a("rspecifier"), a("ali_rspecifier"),
        a("wspecifier"),
        a("--utt2spk", default=""),
        a("--min-count", type=float, default=200.0))
    for name, fn in (
            ("gmm-decode-faster-regtree-fmllr",
             cmd_gmm_decode_faster_regtree_fmllr),
            ("gmm-decode-faster-regtree-mllr",
             cmd_gmm_decode_faster_regtree_mllr),
            ("gmm-latgen-faster-regtree-fmllr",
             cmd_gmm_latgen_faster_regtree_fmllr)):
        add(name, fn,
            a("model"), a("regtree"), a("graph"), a("rspecifier"),
            a("transforms"),
            a("--utt2spk", default=""), *decode_opts())
    add("gmm-decode-nbest", cmd_gmm_decode_nbest,
        a("model"), a("graph"), a("rspecifier"),
        a("--n", type=int, default=10),
        a("--beam", type=float, default=16.0),
        a("--max-active", type=int, default=7000),
        a("--acoustic-scale", type=float, default=0.1),
        a("--lattice-beam", type=float, default=10.0),
        a("--transcription-out", default=""))
    add("gmm-latgen-map", cmd_gmm_latgen_map,
        a("model"), a("gmms_dir"), a("graph"), a("rspecifier"),
        a("--utt2spk", default=""), *decode_opts())
    add("lattice-arcgraph", cmd_lattice_arcgraph,
        a("lattice_ark"), a("arcs_out"))
    for name, fn in (("gmm-latgen-tracking", cmd_gmm_latgen_tracking),
                     ("latgen-tracking-mapped",
                      cmd_latgen_tracking_mapped)):
        add(name, fn,
            a("model"), a("rspecifier"), a("arcs_rspecifier"),
            a("--extra-beam", type=float, default=4.0),
            *decode_opts())
