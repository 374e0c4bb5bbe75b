"""Adaptation and decode-variant CLI subcommands (counterpart of
kaldi_tpu/cli_adapt.py), registered into the main parser by
kaldi_tpu_torch.cli.main via register(sub).

Ported so far (the fifth slice, 5a): global-GMM MLLT statistics,
get-full-lda-mat and lattice-arcgraph, all host numpy writing JAX's
bytes. The global-GMM fMLLR / LVTLN, HLDA, fMLLR-basis, regression-tree
and tracking decodes follow with slice 5b.

(ref: gmmbin/*.cc, featbin/get-full-lda-mat.cc — cited per command.)
"""

from __future__ import annotations

import sys

import numpy as np


def _ubm_diag(path):
    """load_ubm as a DiagGmm (full covariances diagonalized: the MLLT
    stats here are diagonal-model statistics)."""
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(path)
    return ubm.to_diag() if isinstance(ubm, FullGmm) else ubm


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


def register(sub):
    def add(name, func, *arg_specs):
        q = sub.add_parser(name)
        for (a_args, a_kw) in arg_specs:
            q.add_argument(*a_args, **a_kw)
        q.set_defaults(func=func)

    def a(*args, **kw):
        return (args, kw)

    add("gmm-acc-mllt-global", cmd_gmm_acc_mllt_global,
        a("model"), a("rspecifier"), a("accs_out"))
    add("get-full-lda-mat", cmd_get_full_lda_mat,
        a("lda_mllt"), a("full_lda"), a("full_out"),
        a("inv_out", nargs="?", default=""))
    add("lattice-arcgraph", cmd_lattice_arcgraph,
        a("lattice_ark"), a("arcs_out"))
