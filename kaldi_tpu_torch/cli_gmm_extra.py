"""GMM / fgmm long-tail CLI subcommands of the port.

Counterpart of kaldi_tpu/cli_gmm_extra.py, holding the ported ones:
global-GMM gselect-to-post and two-feature stats, UBM clustering from an
acoustic model, flat and transition-only model init, accumulator
algebra (diff, rescale), gaussian-level posteriors and the fMPE
derivatives (feature, statistics and transform). All are host
numpy, as in JAX (the UBMs and the per-pdf DiagGmms score on the host),
writing JAX's files; `gmm-init-model-flat` builds its AM for `--device`
(default: cuda), as `gmm-init-mono` does. Registered into the main
parser by kaldi_tpu_torch.cli.main via register(sub).

(ref: gmmbin/*.cc, fgmmbin/*.cc — cited per command.)
"""

from __future__ import annotations

import pickle
import sys

import numpy as np


def _read_gselect(path: str):
    """'utt i i ; i i ; ...' text lines -> {utt: [frame -> [int]]}."""
    out = {}
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            frames: list = [[]]
            for t in toks[1:]:
                if t == ";":
                    frames.append([])
                else:
                    frames[-1].append(int(t))
            if frames and not frames[-1]:
                frames.pop()
            out[toks[0]] = frames
    return out


# ------------------------------------------------------- global GMM tools

def cmd_gmm_global_gselect_to_post(args):
    """Component posteriors restricted to preselected gaussians
    (ref: gmmbin/gmm-global-gselect-to-post.cc /
    fgmmbin/fgmm-global-gselect-to-post.cc)."""
    from kaldi_tpu_torch.hmm.posterior import write_post_line
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(args.model)
    gsel = _read_gselect(args.gselect_in)
    n = 0
    with open(args.post_out, "w") as out:
        for utt, feats in open_rspecifier(args.rspecifier):
            if utt not in gsel:
                continue
            x = np.asarray(feats, np.float64)
            ll = ubm.loglikes(x)                        # [T, I]
            lines = []
            for t, idx in enumerate(gsel[utt][: len(x)]):
                li = ll[t, idx]
                li = np.exp(li - li.max())
                li /= li.sum()
                sel = [(int(i), float(w)) for i, w in zip(idx, li)
                       if w >= args.min_post]
                tot = sum(w for (_i, w) in sel) or 1.0
                lines.append([(i, w / tot) for (i, w) in sel])
            write_post_line(out, utt, lines)
            n += 1
    print(f"gmm-global-gselect-to-post: {n} utts", file=sys.stderr)


def cmd_gmm_global_acc_stats_twofeats(args):
    """Posteriors from one feature stream, stats over another: the
    two-feature GMM conversion (ref:
    gmmbin/gmm-global-acc-stats-twofeats.cc and the fgmm variant)."""
    from kaldi_tpu_torch.cli import _global_acc, _save_global_accs
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_ubm
    ubm = load_ubm(args.model)
    feats2 = {k: np.asarray(v, np.float64)
              for (k, v) in open_rspecifier(args.rspecifier2)}
    acc, full = None, False
    n_frames, tot_like = 0, 0.0
    for utt, feats in open_rspecifier(args.rspecifier):
        if utt not in feats2:
            continue
        x1 = np.asarray(feats, np.float64)
        x2 = feats2[utt]
        T = min(len(x1), len(x2))
        if acc is None:
            acc, full = _global_acc(ubm, x2.shape[1])
        post = ubm.posteriors(x1[:T].astype(np.float32))
        acc.accumulate_from_posteriors(x2[:T],
                                       np.asarray(post, np.float64))
        tot_like += float(ubm.loglike(x1[:T]).sum())
        n_frames += T
    if acc is None:
        raise SystemExit("gmm-global-acc-stats-twofeats: no utterances")
    _save_global_accs(args.accs_out, acc, full, tot_like, n_frames)
    print(f"gmm-global-acc-stats-twofeats: {n_frames} frames",
          file=sys.stderr)


# ------------------------------------------------ acoustic-model GMM tools

def cmd_init_ubm(args):
    """An acoustic model's gaussians (weighted by state occupancies from a
    gmm accs file) clustered into one UBM (ref: gmmbin/init-ubm.cc,
    gmm/mle-full-gmm.h ClusterGaussiansToUbm): weighted k-means on the
    means from JAX's numpy draws, then each cluster's merged moments."""
    from kaldi_tpu_torch.cli import _occs
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    from kaldi_tpu_torch.io.model_io import (load_gmm_accs,
                                             load_gmm_system, save_ubm)
    model = load_gmm_system(args.model, device="cpu")
    occs = _occs(load_gmm_accs(args.occs)[0])
    ws, ms, vs = [], [], []
    for j, pdf in enumerate(model.am.pdfs):
        for g in range(pdf.num_gauss):
            ws.append(max(occs[j], 1e-3) * pdf.weights[g])
            ms.append(pdf.means[g])
            vs.append(pdf.vars[g])
    ws = np.asarray(ws)
    ms = np.stack(ms)
    vs = np.stack(vs)
    K = min(args.ubm_num_gauss, len(ws))
    rng = np.random.RandomState(0)
    centers = ms[rng.choice(len(ws), K, replace=False, p=ws / ws.sum())]
    assign = None
    for _ in range(args.cluster_iters):
        d = ((ms[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for k in range(K):
            sel = assign == k
            if sel.any():
                centers[k] = np.average(ms[sel], axis=0, weights=ws[sel])
    w_out, m_out, v_out = [], [], []
    for k in range(K):
        sel = assign == k
        if not sel.any():
            continue
        mk = np.average(ms[sel], axis=0, weights=ws[sel])
        second = np.average(vs[sel] + ms[sel] ** 2, axis=0,
                            weights=ws[sel])
        w_out.append(ws[sel].sum())
        m_out.append(mk)
        v_out.append(np.maximum(second - mk ** 2, 1e-6))
    w_out = np.asarray(w_out) / np.sum(w_out)
    if args.fullcov_ubm:
        ubm = FullGmm.from_diag(w_out, np.stack(m_out), np.stack(v_out))
    else:
        ubm = DiagGmm(w_out, np.stack(m_out), np.stack(v_out))
    save_ubm(args.gmm_out, ubm)
    print(f"init-ubm: {len(w_out)} components from "
          f"{len(ws)} Gaussians", file=sys.stderr)


def cmd_gmm_init_model_flat(args):
    """Flat GMM system over a tree: every leaf one gaussian at the data's
    global mean and variance (0 and 1 without data)
    (ref: gmmbin/gmm-init-model-flat.cc); the AM is built for the
    device."""
    from kaldi_tpu_torch.cli import _device
    from kaldi_tpu_torch.gmm.am_gmm import AmDiagGmm
    from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import (load_gmm_system, load_tree,
                                             save_gmm_system)
    from kaldi_tpu_torch.steps.deltas import transition_model_from_tree
    from kaldi_tpu_torch.steps.mono import MonoModel
    dev = _device(args)
    src = load_gmm_system(args.model, device="cpu")
    ctx = load_tree(args.tree)
    if args.rspecifier:
        tot, s1, s2 = 0.0, None, None
        for _utt, feats in open_rspecifier(args.rspecifier):
            x = np.asarray(feats, np.float64)
            s1 = x.sum(0) if s1 is None else s1 + x.sum(0)
            s2 = (x * x).sum(0) if s2 is None else s2 + (x * x).sum(0)
            tot += len(x)
        mean = s1 / tot
        var = np.maximum(s2 / tot - mean ** 2, 1e-6)
    else:
        mean = np.zeros(args.dim)
        var = np.ones(args.dim)
    tm = transition_model_from_tree(src.lang, ctx)
    pdfs = [DiagGmm(np.ones(1), mean[None].copy(), var[None].copy())
            for _ in range(ctx.num_pdfs)]
    save_gmm_system(args.model_out,
                    MonoModel(AmDiagGmm(pdfs, dev), tm, ctx, src.lang))
    print(f"gmm-init-model-flat: {ctx.num_pdfs} pdfs, dim {len(mean)}",
          file=sys.stderr)


def cmd_gmm_init_trans(args):
    """Transition model from the topology + a tree, gaussians carried from
    an existing system (ref: gmmbin/gmm-init-trans.cc)."""
    from kaldi_tpu_torch.io.model_io import (load_gmm_system, load_tree,
                                             save_gmm_system)
    from kaldi_tpu_torch.steps.deltas import transition_model_from_tree
    from kaldi_tpu_torch.steps.mono import MonoModel
    src = load_gmm_system(args.model, device="cpu")
    ctx = load_tree(args.tree)
    tm = transition_model_from_tree(src.lang, ctx)
    save_gmm_system(args.model_out, MonoModel(src.am, tm, ctx, src.lang))
    print(f"gmm-init-trans: {tm.num_transition_ids} transition ids",
          file=sys.stderr)


def cmd_gmm_diff_accs(args):
    """plus-stats - minus-stats (ref: gmmbin/gmm-diff-accs.cc)."""
    from kaldi_tpu_torch.io.model_io import load_gmm_accs, save_gmm_accs
    plus, tc = load_gmm_accs(args.plus)
    minus, _tc2 = load_gmm_accs(args.minus)
    for a, b in zip(plus.accs, minus.accs):
        a.occ -= b.occ
        a.mean_acc -= b.mean_acc
        a.var_acc -= b.var_acc
    plus.tot_like -= minus.tot_like
    plus.tot_frames -= minus.tot_frames
    save_gmm_accs(args.accs_out, plus, tc)
    print("gmm-diff-accs: done", file=sys.stderr)


def cmd_gmm_est_rescale(args):
    """Means shifted and variances rescaled by the change between two
    stats sets, discriminatively trained offsets kept
    (ref: gmmbin/gmm-est-rescale.cc)."""
    from kaldi_tpu_torch.io.model_io import (load_gmm_accs,
                                             load_gmm_system,
                                             save_gmm_system)
    model = load_gmm_system(args.model, device="cpu")
    old = load_gmm_accs(args.old_stats)[0]
    new = load_gmm_accs(args.new_stats)[0]
    n_upd = 0
    for pdf, oa, na in zip(model.am.pdfs, old.accs, new.accs):
        for g in range(pdf.num_gauss):
            if oa.occ[g] < args.min_count or na.occ[g] < args.min_count:
                continue
            om = oa.mean_acc[g] / oa.occ[g]
            nm = na.mean_acc[g] / na.occ[g]
            ov = np.maximum(oa.var_acc[g] / oa.occ[g] - om ** 2,
                            args.min_variance)
            nv = np.maximum(na.var_acc[g] / na.occ[g] - nm ** 2,
                            args.min_variance)
            pdf.means[g] += nm - om
            pdf.vars[g] = np.maximum(pdf.vars[g] * nv / ov,
                                     args.min_variance)
            n_upd += 1
    model.am.invalidate()
    save_gmm_system(args.model_out, model)
    print(f"gmm-est-rescale: {n_upd} Gaussians rescaled", file=sys.stderr)


def cmd_gmm_post_to_gpost(args):
    """State posteriors -> gaussian-level posteriors, a pickle archive
    {utt: [frame -> [(pdf, component posteriors [M])]]}
    (ref: gmmbin/gmm-post-to-gpost.cc)."""
    from kaldi_tpu_torch.cli import _post_to_pdf_post
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    feats = dict(open_rspecifier(args.rspecifier))
    out = {}
    for utt, post in read_post_ark(args.post_in):
        if utt not in feats:
            continue
        x = np.asarray(feats[utt], np.float64)
        gp = []
        for t, frame in enumerate(_post_to_pdf_post(post,
                                                    model.trans_model)):
            gp.append([(int(pdf), (w * model.am.pdfs[pdf].posteriors(
                x[t][None])[0]).astype(np.float32)) for pdf, w in frame])
        out[utt] = gp
    with open(args.gpost_out, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"gmm-post-to-gpost: {len(out)} utts", file=sys.stderr)


def cmd_gmm_acc_stats_twofeats(args):
    """Posteriors from feature stream 1, stats over stream 2 (accs of
    stream 2's dimension; ref: gmmbin/gmm-acc-stats-twofeats.cc)."""
    from kaldi_tpu_torch.cli import _post_to_pdf_post
    from kaldi_tpu_torch.gmm.estimation import AccumAmDiagGmm, AccumDiagGmm
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system, save_gmm_accs
    model = load_gmm_system(args.model, device="cpu")
    feats1 = dict(open_rspecifier(args.rspecifier1))
    feats2 = dict(open_rspecifier(args.rspecifier2))
    acc = AccumAmDiagGmm.__new__(AccumAmDiagGmm)
    acc.tot_like = 0.0
    acc.tot_frames = 0.0
    acc.accs = None
    n = 0
    for utt, post in read_post_ark(args.post_in):
        if utt not in feats1 or utt not in feats2:
            continue
        x1 = np.asarray(feats1[utt], np.float64)
        x2 = np.asarray(feats2[utt], np.float64)
        if acc.accs is None:
            acc.accs = [AccumDiagGmm(p.num_gauss, x2.shape[1])
                        for p in model.am.pdfs]
        for t, frame in enumerate(_post_to_pdf_post(
                post, model.trans_model)):
            for pdf, w in frame:
                cp = model.am.pdfs[pdf].posteriors(x1[t][None])[0] * w
                a = acc.accs[pdf]
                a.occ += cp
                a.mean_acc += np.outer(cp, x2[t])
                a.var_acc += np.outer(cp, x2[t] * x2[t])
                acc.tot_frames += w
        n += 1
    if acc.accs is None:
        raise SystemExit("gmm-acc-stats-twofeats: no utterances")
    save_gmm_accs(args.accs_out, acc)
    print(f"gmm-acc-stats-twofeats: {n} utts", file=sys.stderr)


# ------------------------------------------------------------ registration

def cmd_fgmm_global_init_from_accs(args):
    """Full GMM straight from accumulated stats
    (ref: fgmmbin/fgmm-global-init-from-accs.cc)."""
    from kaldi_tpu_torch.io.model_io import save_ubm
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    z = np.load(args.accs_in)
    occ = z["occ"]
    D = z["mean_acc"].shape[1]
    keep = occ > max(args.min_gaussian_occupancy, 1e-10)
    occ_k = occ[keep]
    means = z["mean_acc"][keep] / occ_k[:, None]
    cov = (z["cov_acc"][keep] / occ_k[:, None, None]
           - np.einsum("md,me->mde", means, means))
    cov += np.eye(D)[None] * args.variance_floor
    weights = occ_k / occ_k.sum()
    ncomp = int(args.num_components)
    if ncomp and ncomp < len(weights):
        order = np.argsort(-occ_k)[:ncomp]
        weights = weights[order] / weights[order].sum()
        means, cov = means[order], cov[order]
    save_ubm(args.model_out, FullGmm(weights, means, cov))
    print(f"fgmm-global-init-from-accs: {len(weights)} components",
          file=sys.stderr)


def cmd_fgmm_global_merge(args):
    """Concatenate several full GMMs, proportionally reweighted; writes
    the sizes file (ref: fgmmbin/fgmm-global-merge.cc)."""
    from kaldi_tpu_torch.io.model_io import load_ubm, save_ubm
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    parts = [load_ubm(p) for p in args.fgmm_in]
    parts = [p if isinstance(p, FullGmm)
             else FullGmm.from_diag(p.weights, p.means, p.vars)
             for p in parts]
    n = len(parts)
    weights = np.concatenate([p.weights / n for p in parts])
    means = np.concatenate([p.means for p in parts])
    covars = np.concatenate([p.covars for p in parts])
    save_ubm(args.fgmm_out, FullGmm(weights / weights.sum(), means,
                                    covars))
    with open(args.sizes_out, "w") as f:
        f.write(" ".join(str(p.num_gauss) for p in parts) + "\n")
    print(f"fgmm-global-merge: {len(weights)} total components",
          file=sys.stderr)


def _merge_cost(w1, m1, c1, w2, m2, c2):
    """Likelihood loss of merging two weighted full Gaussians."""
    w = w1 + w2
    m = (w1 * m1 + w2 * m2) / w
    c = (w1 * (c1 + np.outer(m1, m1)) + w2 * (c2 + np.outer(m2, m2))) / w \
        - np.outer(m, m)
    def ld(c_):
        sign, v = np.linalg.slogdet(c_ + 1e-8 * np.eye(len(m)))
        return v
    return 0.5 * (w * ld(c) - w1 * ld(c1) - w2 * ld(c2)), (w, m, c)


def cmd_fgmm_global_mixdown(args):
    """Greedy pair merging down to --mixdown-target components; gselect
    co-occurrence proposes candidate pairs when given
    (ref: fgmmbin/fgmm-global-mixdown.cc)."""
    from kaldi_tpu_torch.io.model_io import load_ubm, save_ubm
    from kaldi_tpu_torch.gmm.full_gmm import FullGmm
    ubm = load_ubm(args.model)
    if not isinstance(ubm, FullGmm):
        ubm = FullGmm.from_diag(ubm.weights, ubm.means, ubm.vars)
    if args.mixdown_target <= 0:
        raise SystemExit("fgmm-global-mixdown: --mixdown-target required")
    w = list(ubm.weights)
    m = list(ubm.means)
    c = list(ubm.covars)
    co = None
    if args.gselect:
        I = len(w)
        co = np.zeros((I, I))
        for _utt, frames in _read_gselect(args.gselect).items():
            for idx in frames:
                for a in idx:
                    for b in idx:
                        if a < b:
                            co[a, b] += 1
    while len(w) > args.mixdown_target:
        if co is not None and co.any():
            cand = np.argwhere(co > 0)
            order = np.argsort(-co[cand[:, 0], cand[:, 1]])
            cand = [tuple(x) for x in cand[order[: args.num_pairs]]]
        else:
            cand = [(i, j) for i in range(len(w))
                    for j in range(i + 1, len(w))]
        best = None
        for (i, j) in cand:
            if i >= len(w) or j >= len(w) or i == j:
                continue
            cost, merged = _merge_cost(w[i], m[i], c[i], w[j], m[j], c[j])
            if best is None or cost < best[0]:
                best = (cost, i, j, merged)
        if best is None:
            break
        _cost, i, j, (wm, mm, cm) = best
        for lst in (w, m, c):
            lst[i] = None
        w[i], m[i], c[i] = wm, mm, cm
        w.pop(j), m.pop(j), c.pop(j)
        if co is not None:
            co = np.delete(np.delete(co, j, 0), j, 1)
    save_ubm(args.model_out, FullGmm(np.array(w) / np.sum(w),
                                     np.stack(m), np.stack(c)))
    print(f"fgmm-global-mixdown: -> {len(w)} components", file=sys.stderr)


# ------------------------------------------------------- fMPE derivatives

def cmd_gmm_get_feat_deriv(args):
    """Per-frame feature derivative of the (signed-posterior) objective,
    host f64 as in JAX (ref: gmmbin/gmm-get-feat-deriv.cc)."""
    from kaldi_tpu_torch.cli import _post_to_pdf_post
    from kaldi_tpu_torch.hmm.posterior import read_post_ark
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    feats = dict(open_rspecifier(args.rspecifier))
    n = 0
    with open_wspecifier(args.wspecifier) as out:
        for utt, post in read_post_ark(args.post_in):
            if utt not in feats:
                continue
            x = np.asarray(feats[utt], np.float64)
            pdf_post = _post_to_pdf_post(post, model.trans_model)
            deriv = np.zeros_like(x)
            for t, frame in enumerate(pdf_post):
                for pdf, w in frame:
                    g = model.am.pdfs[pdf]
                    cp = g.posteriors(x[t][None])[0]
                    deriv[t] += w * (cp[:, None] * (g.means - x[t])
                                     / g.vars).sum(0)
            out.write(utt, deriv.astype(np.float32))
            n += 1
    print(f"gmm-get-feat-deriv: {n} utts", file=sys.stderr)


def cmd_gmm_fmpe_acc_stats(args):
    """fMPE transform stats straight from pre-fMPE features: apply the
    transform, take the direct differential, project onto the
    context-expanded posteriors (ref: gmmbin/gmm-fmpe-acc-stats.cc)."""
    from kaldi_tpu_torch.cli import _fmpe_acc, _load_fmpe, _save_fmpe_accs
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    acc, frames = _fmpe_acc(load_gmm_system(args.model, device="cpu"),
                            _load_fmpe(args.fmpe), args.rspecifier,
                            args.post_in)
    _save_fmpe_accs(args.accs_out, acc, frames)
    print(f"gmm-fmpe-acc-stats: {frames} frames", file=sys.stderr)


def cmd_gmm_get_stats_deriv(args):
    """Model derivative for indirect fMPE/fMMI: d(objective)/d(mean,var)
    from num/den/ml stats, host f64 (ref: gmmbin/gmm-get-stats-deriv.cc,
    transform/fmpe.h ComputeModelDiff). Writes per-pdf mean/var
    derivative arrays."""
    from kaldi_tpu_torch.io.model_io import load_gmm_accs, load_gmm_system
    model = load_gmm_system(args.model, device="cpu")
    num, _t1 = load_gmm_accs(args.num_stats)
    den, _t2 = load_gmm_accs(args.den_stats)
    ml, _t3 = load_gmm_accs(args.ml_stats)
    blobs = {}
    for j, (pdf, an, ad, am_) in enumerate(
            zip(model.am.pdfs, num.accs, den.accs, ml.accs)):
        occ_d = an.occ - ad.occ                       # discriminative gamma
        x_d = an.mean_acc - ad.mean_acc
        x2_d = an.var_acc - ad.var_acc
        mu, var = pdf.means, pdf.vars
        # dF/dmu = (x_d - gamma_d mu) / var (diag-covariance MMI)
        dmu = (x_d - occ_d[:, None] * mu) / var
        # dF/dvar = (x2_d - 2 mu x_d + gamma_d mu^2 - gamma_d var) / 2var^2
        dvar = (x2_d - 2 * mu * x_d + occ_d[:, None] * mu ** 2
                - occ_d[:, None] * var) / (2 * var ** 2)
        blobs[f"dmu{j}"] = dmu
        blobs[f"dvar{j}"] = dvar
        blobs[f"ml_occ{j}"] = am_.occ
    blobs["num_pdfs"] = np.int64(model.am.num_pdfs)
    with open(args.deriv_out, "wb") as f:
        np.savez(f, **blobs)
    print(f"gmm-get-stats-deriv: {model.am.num_pdfs} pdfs",
          file=sys.stderr)


def register(sub):
    def add(name, func, *arg_specs):
        q = sub.add_parser(name)
        for (a_args, a_kw) in arg_specs:
            q.add_argument(*a_args, **a_kw)
        q.set_defaults(func=func)

    def a(*args, **kw):
        return (args, kw)

    for name in ("gmm-global-gselect-to-post",
                 "fgmm-global-gselect-to-post"):
        add(name, cmd_gmm_global_gselect_to_post,
            a("model"), a("rspecifier"), a("gselect_in"), a("post_out"),
            a("--min-post", type=float, default=0.0))
    for name in ("gmm-global-acc-stats-twofeats",
                 "fgmm-global-acc-stats-twofeats"):
        add(name, cmd_gmm_global_acc_stats_twofeats,
            a("model"), a("rspecifier"), a("rspecifier2"), a("accs_out"))
    add("fgmm-global-init-from-accs", cmd_fgmm_global_init_from_accs,
        a("accs_in"), a("num_components", type=int), a("model_out"),
        a("--min-gaussian-occupancy", type=float, default=10.0),
        a("--variance-floor", type=float, default=1e-3))
    add("fgmm-global-merge", cmd_fgmm_global_merge,
        a("fgmm_out"), a("sizes_out"), a("fgmm_in", nargs="+"))
    add("fgmm-global-mixdown", cmd_fgmm_global_mixdown,
        a("model"), a("model_out"),
        a("--mixdown-target", type=int, default=-1),
        a("--gselect", default=""),
        a("--num-pairs", type=int, default=20000))
    add("init-ubm", cmd_init_ubm,
        a("model"), a("occs"), a("gmm_out"),
        a("--ubm-num-gauss", type=int, default=400),
        a("--fullcov-ubm", type=lambda s: s != "false", default=True),
        a("--cluster-iters", type=int, default=5))
    add("gmm-init-model-flat", cmd_gmm_init_model_flat,
        a("model"), a("tree"), a("model_out"),
        a("rspecifier", nargs="?", default=""),
        a("--dim", type=int, default=40))
    add("gmm-init-trans", cmd_gmm_init_trans,
        a("model"), a("tree"), a("model_out"))
    add("gmm-diff-accs", cmd_gmm_diff_accs,
        a("plus"), a("minus"), a("accs_out"))
    add("gmm-est-rescale", cmd_gmm_est_rescale,
        a("model"), a("old_stats"), a("new_stats"), a("model_out"),
        a("--min-count", type=float, default=1.0),
        a("--min-variance", type=float, default=1e-3))
    add("gmm-post-to-gpost", cmd_gmm_post_to_gpost,
        a("model"), a("rspecifier"), a("post_in"), a("gpost_out"))
    add("gmm-acc-stats-twofeats", cmd_gmm_acc_stats_twofeats,
        a("model"), a("rspecifier1"), a("rspecifier2"), a("post_in"),
        a("accs_out"))
    add("gmm-get-feat-deriv", cmd_gmm_get_feat_deriv,
        a("model"), a("rspecifier"), a("post_in"), a("wspecifier"))
    add("gmm-fmpe-acc-stats", cmd_gmm_fmpe_acc_stats,
        a("model"), a("fmpe"), a("rspecifier"), a("post_in"),
        a("accs_out"))
    add("gmm-get-stats-deriv", cmd_gmm_get_stats_deriv,
        a("model"), a("num_stats"), a("den_stats"), a("ml_stats"),
        a("deriv_out"))
