"""SGMM / SGMM2 CLI subcommands beyond the core train / est / decode loop
in kaldi_tpu_torch.cli (counterpart of kaldi_tpu/cli_sgmm.py): model init,
copy and surgery, gaussian-level posteriors (gpost), fMLLR and fMLLR-basis
estimation, pre-transforms, lattice rescoring, state distances and
normalization. Registered into the main parser by kaldi_tpu_torch.cli.main
via register(sub).

The model and its statistics live on `--device` (default: cuda) wherever a
command scores, accumulates or solves; the file tools (copy, info, the UBM
write-out, normalization, re-initialization over a new tree, projection)
are host code writing JAX's bytes. The legacy sgmm-* names are aliases in
kaldi_tpu_torch.cli._ALIASES (AmSgmm2 without the speaker weights is the
v1 model; its files are tagged kind='sgmm').

(ref: sgmmbin/*.cc, sgmm2bin/*.cc — cited per command.)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.io.kaldi_io import open_rspecifier

F64 = torch.float64

# the subcommands that build a device object (`--device`)
DEVICE_COMMANDS = (
    "sgmm2-init", "sgmm-mixup", "sgmm-calc-distances", "sgmm2-post-to-gpost",
    "sgmm2-acc-stats-gpost", "sgmm2-acc-stats2", "sgmm-acc-stats-ali",
    "sgmm-est-multi", "sgmm2-est-fmllr", "sgmm2-comp-prexform",
    "sgmm-acc-fmllrbasis-ali", "sgmm-est-fmllrbasis", "sgmm2-rescore-lattice")


def _load(path, device="cpu"):
    from kaldi_tpu_torch.io.model_io import load_sgmm2
    return load_sgmm2(path, device=device)


def _save(path, am):
    from kaldi_tpu_torch.io.model_io import save_sgmm2
    save_sgmm2(path, am, kind=getattr(am, "kind", "sgmm2"))


def _occs_from_accs(path):
    from kaldi_tpu_torch.io.model_io import load_sgmm2_accs
    return load_sgmm2_accs(path, device="cpu").state_occs()


def _pdf_posts(gmm_model, post_in):
    """(utt, pdf-level posterior) pairs of a post file, through the GMM
    system's transition model."""
    from kaldi_tpu_torch.cli import _post_to_pdf_post
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    tm = load_gmm_system(gmm_model, device="cpu").trans_model
    for utt, post in read_post_ark(post_in):
        yield utt, _post_to_pdf_post(post, tm)


def _ali_posts(args):
    """(utt, one-hot pdf posterior) of each alignment, through the GMM
    system's transition model."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    tm = load_gmm_system(args.gmm_model, device="cpu").trans_model
    for utt, ali in open_rspecifier(args.ali_rspecifier):
        pdfs = tm.id2pdf_array[np.asarray(ali, np.int64)]
        yield utt, [[(int(p), 1.0)] for p in pdfs]


def _rebuilt(s, **arrays):
    """The port's AmSgmm2 of JAX's per-state lists from `s` with some
    global arrays replaced (host numpy), on the CPU."""
    from types import SimpleNamespace

    from kaldi_tpu_torch.params import sgmm2_from_jax, sgmm2_to_lists
    v, c = sgmm2_to_lists(s)
    lists = SimpleNamespace(
        Sigma_inv=s.Sigma_inv.numpy(), M=s.M.numpy(), w=s.w.numpy(),
        N=None if s.N is None else s.N.numpy(), v=v, c=c,
        norm_set_ids=s.norm_set_ids)
    for k, a in arrays.items():
        setattr(lists, k, a)
    return sgmm2_from_jax(lists, "cpu")


# ----------------------------------------------------------- model tools

def cmd_sgmm2_init(args):
    """Initialize an SGMM from a (full-covariance) UBM on the device; the
    state count from the GMM system's tree (ref: sgmm2bin/sgmm2-init.cc;
    --kind=sgmm writes the legacy-v1 tag)."""
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.io.model_io import load_gmm_system, load_ubm
    from kaldi_tpu_torch.sgmm.model import AmSgmm2
    from kaldi_tpu_torch.steps.sgmm_steps import SgmmAm
    dev = resolve_device(args.device)
    gmm = load_gmm_system(args.gmm_model, device="cpu")
    ubm = load_ubm(args.ubm)
    if isinstance(ubm, DiagGmm):
        ubm = FullGmm.from_diag(ubm.weights, ubm.means, ubm.vars)
    num_states = gmm.am.num_pdfs
    sgmm = AmSgmm2(ubm, num_states, args.phn_dim, spk_dim=args.spk_dim,
                   seed=args.seed, device=dev)
    am = SgmmAm(sgmm, args.num_gselect)
    am.kind = args.kind
    _save(args.sgmm_out, am)
    print(f"sgmm2-init: {num_states} states, {sgmm.num_gauss} gauss, "
          f"phn-dim {args.phn_dim}, spk-dim {args.spk_dim}",
          file=sys.stderr)


def cmd_sgmm2_copy(args):
    """(ref: sgmm2bin/sgmm2-copy.cc)"""
    _save(args.model_out, _load(args.model))
    print("sgmm2-copy: done", file=sys.stderr)


def cmd_sgmm_write_ubm(args):
    """Extract the shared full-covariance UBM: means M_i's first column,
    weights from the first weight-projection column, host f64
    (ref: sgmmbin/sgmm-write-ubm.cc)."""
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.io.model_io import save_ubm
    s = _load(args.model).sgmm
    w0 = s.w.numpy()[:, 0]
    w = np.exp(w0 - np.logaddexp.reduce(w0))
    ubm = FullGmm(w, s.M.numpy()[:, :, 0], np.linalg.inv(s.Sigma_inv.numpy()))
    save_ubm(args.ubm_out, ubm)
    print(f"sgmm-write-ubm: {s.num_gauss} gauss, dim {s.dim}",
          file=sys.stderr)


def cmd_sgmm_mixup(args):
    """Substate splitting and subspace-dimension surgery on the device,
    JAX's draws (ref: sgmmbin/sgmm-mixup.cc)."""
    am = _load(args.model, resolve_device(args.device))
    s = am.sgmm
    if args.increase_phn_dim:
        s.increase_phn_dim(args.increase_phn_dim, seed=args.seed)
    if args.increase_spk_dim:
        s.increase_spk_dim(args.increase_spk_dim, seed=args.seed)
    if args.remove_speaker_space:
        s.remove_speaker_space()
    if args.num_substates:
        occs = _occs_from_accs(args.read_occs) if args.read_occs else None
        s.split_substates(args.num_substates, perturb=args.perturb_factor,
                          state_occs=occs, seed=args.seed)
    _save(args.model_out, am)
    print(f"sgmm-mixup: {int(s.offsets[-1])} substates, phn-dim "
          f"{s.phn_dim}, spk-dim {s.spk_dim}", file=sys.stderr)


def cmd_sgmm_normalize(args):
    """Renormalize weights within subsets of UBM Gaussians (typically
    gender): subset masses sum to one per substate
    (ref: sgmmbin/sgmm-normalize.cc, am-sgmm.cc:782
    ComputeNormalizersNormalized)."""
    am = _load(args.model)
    I = am.sgmm.num_gauss
    set_ids = np.full(I, -1, np.int64)
    for n, (_name, idx) in enumerate(open_rspecifier(
            args.gaussians_rspecifier)):
        ii = np.asarray(idx, np.int64).reshape(-1)
        if np.any(set_ids[ii] >= 0):
            raise SystemExit("sgmm-normalize: sets are not disjoint")
        set_ids[ii] = n
    if np.any(set_ids < 0):
        raise SystemExit("sgmm-normalize: sets do not cover all Gaussians")
    am.sgmm.norm_set_ids = set_ids
    _save(args.model_out, am)
    print(f"sgmm-normalize: {set_ids.max() + 1} subsets over {I} "
          f"Gaussians", file=sys.stderr)


def cmd_sgmm_calc_distances(args):
    """Approximate inter-state KL divergence matrix on the device
    (ref: sgmmbin/sgmm-calc-distances.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import write_ark
    from kaldi_tpu_torch.sgmm.prexform import state_distances
    am = _load(args.model, resolve_device(args.device))
    d = state_distances(am.sgmm, _occs_from_accs(args.occs)).cpu().numpy()
    write_ark(args.distances_out, {"distances": d.astype(np.float32)})
    print(f"sgmm-calc-distances: [{d.shape[0]} x {d.shape[1]}]",
          file=sys.stderr)


def cmd_sgmm_init_from_tree_stats(args):
    """New SGMM over a (re-built) tree, globals carried from an existing
    SGMM (ref: sgmmbin/sgmm-init-from-tree-stats.cc — states restart at
    v = e1 so the new model is the carried UBM tied across the new
    tree's leaves)."""
    from kaldi_tpu_torch.io.model_io import load_tree
    from kaldi_tpu_torch.steps.sgmm_steps import SgmmAm
    old = _load(args.old_sgmm)
    J = load_tree(args.tree).num_pdfs
    S = old.sgmm.phn_dim
    s = _rebuilt(old.sgmm, v=[[np.eye(S)[0].copy()] for _ in range(J)],
                 c=[np.ones(1) for _ in range(J)], norm_set_ids=None)
    am = SgmmAm(s, old.num_gselect)
    am.kind = getattr(old, "kind", "sgmm")
    _save(args.sgmm_out, am)
    print(f"sgmm-init-from-tree-stats: {J} states", file=sys.stderr)


def cmd_sgmm2_project(args):
    """Apply a (rectangular slice of a) full LDA-type transform to the
    model, host f64: Sigma -> T Sigma T', M -> T M, N -> T N; writes the
    projection used (ref: sgmm2bin/sgmm2-project.cc)."""
    from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark
    am = _load(args.model)
    s = am.sgmm
    T_full = np.asarray(next(iter(read_ark(args.lda_mat)))[1], np.float64)
    end = args.end_dim if args.end_dim > 0 else T_full.shape[0]
    T = T_full[args.start_dim:end, :s.dim]
    Sigma = np.linalg.inv(s.Sigma_inv.numpy())
    N = None if s.N is None else np.einsum("ab,ibt->iat", T, s.N.numpy())
    am.sgmm = _rebuilt(
        s, Sigma_inv=np.linalg.inv(np.einsum("ab,ibc,dc->iad", T, Sigma, T)),
        M=np.einsum("ab,ibs->ias", T, s.M.numpy()), N=N)
    _save(args.model_out, am)
    write_ark(args.proj_out, {"proj": T.astype(np.float32)})
    print(f"sgmm2-project: dims [{args.start_dim}, {end}) -> "
          f"feature dim {T.shape[0]}", file=sys.stderr)


# ----------------------------------------------------------- gpost tools

def cmd_sgmm2_post_to_gpost(args):
    """State posteriors -> Gaussian-level posteriors, on the device
    (ref: sgmm2bin/sgmm2-post-to-gpost.cc)."""
    from kaldi_tpu_torch.sgmm.gpost import compute_gpost, write_gpost_ark
    am = _load(args.model, resolve_device(args.device))
    feats = dict(open_rspecifier(args.rspecifier))
    out = {}
    for utt, pdf_post in _pdf_posts(args.gmm_model, args.post_in):
        if utt not in feats:
            continue
        out[utt] = compute_gpost(am.sgmm, feats[utt].astype(np.float64),
                                 pdf_post, num_gselect=am.num_gselect)
    write_gpost_ark(args.gpost_out, out)
    print(f"sgmm2-post-to-gpost: {len(out)} utts", file=sys.stderr)


def cmd_sgmm2_acc_stats_gpost(args):
    """EM stats from precomputed Gaussian-level posteriors, on the device
    (ref: sgmm2bin/sgmm2-acc-stats-gpost.cc)."""
    from kaldi_tpu_torch.io.model_io import save_sgmm2_accs
    from kaldi_tpu_torch.sgmm.estimate import Sgmm2Accs
    from kaldi_tpu_torch.sgmm.gpost import read_gpost_ark
    am = _load(args.model, resolve_device(args.device))
    feats = dict(open_rspecifier(args.rspecifier))
    accs = Sgmm2Accs(am.sgmm)
    n = 0
    for utt, gpost in read_gpost_ark(args.gpost_in):
        if utt not in feats:
            continue
        accs.accumulate_gpost(am.sgmm, feats[utt].astype(np.float64), gpost)
        n += 1
    save_sgmm2_accs(args.accs_out, accs)
    print(f"sgmm2-acc-stats-gpost: {n} utts", file=sys.stderr)


def cmd_sgmm2_acc_stats2(args):
    """Numerator and denominator stats in one pass, on the device:
    positive posterior weights feed the num accs, negative weights
    (absolute value) the den accs (ref: sgmm2bin/sgmm2-acc-stats2.cc)."""
    from kaldi_tpu_torch.io.model_io import save_sgmm2_accs
    from kaldi_tpu_torch.sgmm.estimate import Sgmm2Accs
    am = _load(args.model, resolve_device(args.device))
    feats = dict(open_rspecifier(args.rspecifier))
    num = Sgmm2Accs(am.sgmm)
    den = Sgmm2Accs(am.sgmm)
    n = 0
    for utt, pdf_post in _pdf_posts(args.gmm_model, args.post_in):
        if utt not in feats:
            continue
        f = feats[utt].astype(np.float64)
        pos = [[(j, w) for (j, w) in fr if w > 0] for fr in pdf_post]
        neg = [[(j, -w) for (j, w) in fr if w < 0] for fr in pdf_post]
        num.accumulate(am.sgmm, f, pos, num_gselect=am.num_gselect)
        if any(neg):
            den.accumulate(am.sgmm, f, neg, num_gselect=am.num_gselect)
        n += 1
    save_sgmm2_accs(args.num_accs_out, num)
    save_sgmm2_accs(args.den_accs_out, den)
    print(f"sgmm2-acc-stats2: {n} utts", file=sys.stderr)


def cmd_sgmm_acc_stats_ali(args):
    """EM stats from a hard alignment (transition-ids), on the device
    (ref: sgmmbin/sgmm-acc-stats-ali.cc)."""
    from kaldi_tpu_torch.io.model_io import save_sgmm2_accs
    from kaldi_tpu_torch.sgmm.estimate import Sgmm2Accs
    am = _load(args.model, resolve_device(args.device))
    feats = dict(open_rspecifier(args.rspecifier))
    accs = Sgmm2Accs(am.sgmm)
    n = 0
    for utt, post in _ali_posts(args):
        if utt not in feats:
            continue
        accs.accumulate(am.sgmm, feats[utt].astype(np.float64), post,
                        num_gselect=am.num_gselect)
        n += 1
    save_sgmm2_accs(args.accs_out, accs)
    print(f"sgmm-acc-stats-ali: {n} utts, avg loglike/frame "
          f"{accs.tot_like / max(accs.tot_frames, 1.0):.4f}",
          file=sys.stderr)


def cmd_sgmm_est_multi(args):
    """Update several SGMMs whose global parameters are tied, on the
    device: global stats (Y/Q/S) pooled across models, per-state stats
    per model (ref: sgmmbin/sgmm-est-multi.cc)."""
    from kaldi_tpu_torch.io.model_io import load_sgmm2_accs
    from kaldi_tpu_torch.sgmm.estimate import update_sgmm2
    dev = resolve_device(args.device)
    trip = args.models_accs_outs
    if len(trip) % 3 != 0:
        raise SystemExit("sgmm-est-multi: need model,accs,out triples")
    loaded = [(_load(trip[i], dev), load_sgmm2_accs(trip[i + 1], device=dev),
               trip[i + 2]) for i in range(0, len(trip), 3)]
    # pool the global stats
    Y = sum(a.Y for (_m, a, _o) in loaded)
    Q = sum(a.Q for (_m, a, _o) in loaded)
    S = sum(a.S_centered for (_m, a, _o) in loaded)
    for am, accs, out in loaded:
        accs.Y, accs.Q = Y, Q
        accs._S2, accs._Sx = S.reshape(S.shape[0], -1), torch.zeros_like(S)
        am.sgmm = update_sgmm2(am.sgmm, accs, update_flags=args.update_flags)
        _save(out, am)
    # tie the updated globals: copy the first model's into the rest
    first = _load(loaded[0][2], dev)
    for _am, _accs, out in loaded[1:]:
        am = _load(out, dev)
        am.sgmm.M = first.sgmm.M.clone()
        am.sgmm.w = first.sgmm.w.clone()
        am.sgmm.Sigma_inv = first.sgmm.Sigma_inv.clone()
        am.sgmm._update_derived()
        _save(out, am)
    print(f"sgmm-est-multi: {len(loaded)} models", file=sys.stderr)


# ----------------------------------------------------------- fMLLR tools

def _fmllr_accs_by_spk(args, am, posts):
    from kaldi_tpu_torch.cli import _read_utt2spk
    from kaldi_tpu_torch.sgmm.fmllr import FmllrSgmm2Accs
    utt2spk = _read_utt2spk(args.utt2spk)
    feats = dict(open_rspecifier(args.rspecifier))
    by_spk: dict = {}
    for utt, post in posts:
        if utt not in feats:
            continue
        st = by_spk.setdefault(utt2spk.get(utt, utt), FmllrSgmm2Accs(am.sgmm))
        st.accumulate(am.sgmm, feats[utt].astype(np.float64), post,
                      num_gselect=am.num_gselect)
    return by_spk


def cmd_sgmm2_est_fmllr(args):
    """Per-speaker fMLLR transforms under the SGMM, on the device
    (ref: sgmm2bin/sgmm2-est-fmllr.cc, fmllr-sgmm2.h)."""
    from kaldi_tpu_torch.io.kaldi_io import open_wspecifier
    from kaldi_tpu_torch.sgmm.fmllr import estimate_sgmm2_fmllr
    am = _load(args.model, resolve_device(args.device))
    by_spk = _fmllr_accs_by_spk(args, am,
                                _pdf_posts(args.gmm_model, args.post_in))
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for spk, st in sorted(by_spk.items()):
            W, impr = estimate_sgmm2_fmllr(st, am.sgmm,
                                           min_count=args.fmllr_min_count)
            out.write(spk, W.cpu().numpy().astype(np.float32))
            print(f"sgmm2-est-fmllr: {spk} auxf impr/frame {impr:.4f} "
                  f"over {st.beta:.0f} frames", file=sys.stderr)
            n += 1
    print(f"sgmm2-est-fmllr: {n} speakers", file=sys.stderr)


def cmd_sgmm2_comp_prexform(args):
    """Compute the fMLLR pre-transform / inverse / mean scatter on the
    device and store them with the model
    (ref: sgmm2bin/sgmm2-comp-prexform.cc)."""
    from kaldi_tpu_torch.sgmm.prexform import compute_prexform
    am = _load(args.model, resolve_device(args.device))
    pre, inv, scat = compute_prexform(am.sgmm, _occs_from_accs(args.occs))
    am.pre_xform, am.inv_xform, am.mean_scatter = \
        pre.cpu().numpy(), inv.cpu().numpy(), scat.cpu().numpy()
    _save(args.model_out, am)
    print(f"sgmm2-comp-prexform: dim {pre.shape[0]}", file=sys.stderr)


def cmd_sgmm_acc_fmllrbasis_ali(args):
    """Per-speaker fMLLR stats for basis training, from alignments, on
    the device (ref: sgmmbin/sgmm-acc-fmllrbasis-ali.cc). Writes JAX's
    pickle of per-speaker (beta, K, G) stats."""
    import pickle
    am = _load(args.model, resolve_device(args.device))
    by_spk = _fmllr_accs_by_spk(args, am, _ali_posts(args))
    with open(args.stats_out, "wb") as f:
        pickle.dump({s: (st.beta, st.K.cpu().numpy(), st.G.cpu().numpy())
                     for s, st in by_spk.items()}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    print(f"sgmm-acc-fmllrbasis-ali: {len(by_spk)} speakers",
          file=sys.stderr)


def cmd_sgmm_est_fmllrbasis(args):
    """Estimate the fMLLR basis from per-speaker stats on the device and
    store it in the model (ref: sgmmbin/sgmm-est-fmllrbasis.cc)."""
    import pickle

    from kaldi_tpu_torch.sgmm.fmllr import FmllrSgmm2Accs
    from kaldi_tpu_torch.sgmm.prexform import estimate_fmllr_basis
    dev = resolve_device(args.device)
    am = _load(args.model, dev)
    spk_accs = []
    for p in args.stats_in:
        with open(p, "rb") as f:
            for _spk, (beta, K, G) in pickle.load(f).items():
                st = FmllrSgmm2Accs(am.sgmm)
                st._beta = torch.tensor(beta, dtype=F64, device=dev)
                st.K = torch.as_tensor(K, dtype=F64, device=dev)
                st.G = torch.as_tensor(G, dtype=F64, device=dev)
                spk_accs.append(st)
    basis = estimate_fmllr_basis(am.sgmm, spk_accs,
                                 num_bases=args.num_bases).cpu().numpy()
    am.fmllr_basis = basis
    _save(args.model_out, am)
    print(f"sgmm-est-fmllrbasis: {basis.shape[0]} bases from "
          f"{len(spk_accs)} speakers", file=sys.stderr)


# --------------------------------------------------------------- rescore

def cmd_sgmm2_rescore_lattice(args):
    """Replace lattice acoustic costs with SGMM likelihoods scored on the
    device (ref: sgmm2bin/sgmm2-rescore-lattice.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    from kaldi_tpu_torch.lat.io import read_lattice_ark, write_lattice_ark
    from kaldi_tpu_torch.lat.posteriors import rescore_lattice
    am = _load(args.model, resolve_device(args.device))
    tm = load_gmm_system(args.gmm_model, device="cpu").trans_model
    feats = dict(open_rspecifier(args.rspecifier))
    out = {}
    for key, lat in read_lattice_ark(args.lattice_ark):
        if key not in feats:
            continue
        ll = am.loglikes_np(feats[key].astype(np.float32)[None])[0]
        out[key] = rescore_lattice(lat, ll.astype(np.float64), tm,
                                   acoustic_scale=args.acoustic_scale)
    write_lattice_ark(args.out_ark, out)
    print(f"sgmm2-rescore-lattice: {len(out)}", file=sys.stderr)


# ------------------------------------------------------------ registration

def register(sub):
    def add(name, func, *arg_specs):
        q = sub.add_parser(name)
        for (a_args, a_kw) in arg_specs:
            q.add_argument(*a_args, **a_kw)
        q.set_defaults(func=func)

    def a(*args, **kw):
        return (args, kw)

    add("sgmm2-init", cmd_sgmm2_init,
        a("gmm_model"), a("ubm"), a("sgmm_out"),
        a("--phn-dim", type=int, default=10),
        a("--spk-dim", type=int, default=0),
        a("--num-gselect", type=int, default=8),
        a("--seed", type=int, default=0),
        a("--kind", default="sgmm2", choices=["sgmm2", "sgmm"]))
    add("sgmm2-copy", cmd_sgmm2_copy, a("model"), a("model_out"))
    add("sgmm-write-ubm", cmd_sgmm_write_ubm, a("model"), a("ubm_out"))
    add("sgmm-mixup", cmd_sgmm_mixup,
        a("model"), a("model_out"),
        a("--num-substates", type=int, default=0),
        a("--read-occs", default=""),
        a("--increase-phn-dim", type=int, default=0),
        a("--increase-spk-dim", type=int, default=0),
        a("--remove-speaker-space", action="store_true"),
        a("--perturb-factor", type=float, default=0.01),
        a("--seed", type=int, default=0))
    add("sgmm-normalize", cmd_sgmm_normalize,
        a("model"), a("gaussians_rspecifier"), a("model_out"))
    add("sgmm-calc-distances", cmd_sgmm_calc_distances,
        a("model"), a("occs"), a("distances_out"))
    add("sgmm-init-from-tree-stats", cmd_sgmm_init_from_tree_stats,
        a("old_sgmm"), a("tree"), a("sgmm_out"))
    add("sgmm2-project", cmd_sgmm2_project,
        a("model"), a("lda_mat"), a("model_out"), a("proj_out"),
        a("--start-dim", type=int, default=0),
        a("--end-dim", type=int, default=-1))
    add("sgmm2-post-to-gpost", cmd_sgmm2_post_to_gpost,
        a("model"), a("gmm_model"), a("rspecifier"), a("post_in"),
        a("gpost_out"))
    add("sgmm2-acc-stats-gpost", cmd_sgmm2_acc_stats_gpost,
        a("model"), a("rspecifier"), a("gpost_in"), a("accs_out"))
    add("sgmm2-acc-stats2", cmd_sgmm2_acc_stats2,
        a("model"), a("gmm_model"), a("rspecifier"), a("post_in"),
        a("num_accs_out"), a("den_accs_out"))
    add("sgmm-acc-stats-ali", cmd_sgmm_acc_stats_ali,
        a("model"), a("gmm_model"), a("rspecifier"),
        a("ali_rspecifier"), a("accs_out"))
    add("sgmm-est-multi", cmd_sgmm_est_multi,
        a("models_accs_outs", nargs="+"),
        a("--update-flags", default="vMwSc"))
    add("sgmm2-est-fmllr", cmd_sgmm2_est_fmllr,
        a("model"), a("gmm_model"), a("rspecifier"), a("post_in"),
        a("wspecifier"),
        a("--utt2spk", default=""),
        a("--fmllr-min-count", type=float, default=100.0))
    add("sgmm2-comp-prexform", cmd_sgmm2_comp_prexform,
        a("model"), a("occs"), a("model_out"))
    add("sgmm-acc-fmllrbasis-ali", cmd_sgmm_acc_fmllrbasis_ali,
        a("model"), a("gmm_model"), a("rspecifier"),
        a("ali_rspecifier"), a("stats_out"),
        a("--utt2spk", default=""))
    add("sgmm-est-fmllrbasis", cmd_sgmm_est_fmllrbasis,
        a("model"), a("model_out"), a("stats_in", nargs="+"),
        a("--num-bases", type=int, default=50))
    add("sgmm2-rescore-lattice", cmd_sgmm2_rescore_lattice,
        a("model"), a("gmm_model"), a("lattice_ark"), a("rspecifier"),
        a("out_ark"),
        a("--acoustic-scale", type=float, default=0.1))
