"""Port parity: the CLI's fourth slice, kaldi_tpu_torch/cli_nnet.py's
surgery, raw-network, egs, compute and training tools and cli_misc.py's
two nnet helpers against kaldi_tpu's CLI, on the CPU, over files that
JAX wrote (test_torch_cli_nnet2's `nnet2_system` plus a relu TDNN, a raw
nnet, an nnet1 sigmoid net, LDA statistics of the egs, pdf posteriors,
frame weights, a cholesky factor and JAX's raw lattices of three
utterances).
- Host commands write JAX's bytes and print JAX's lines (HOST_CASES):
  mixup, limit-rank, limit-rank-final, replace-last-layers, insert,
  normalize-stddev, switch-preconditioning, modify-learning-rates, the
  raw-network tools,
  nnet1-to-raw-nnet, nnet2-boost-silence, the egs selectors and
  perturbers, the feature transform, the discriminative egs tools,
  compute-mce-scale and build-pfile-from-ali.
- nnet-am-widen draws its new units from a torch.Generator: held by
  outcome, the old units JAX's to 1e-6 of their scale, the widened net's
  outputs those of the input within 2e-5 (tests/test_torch_surgery.py's
  widen bound), the new units' stddev within `std_ratio_ok`'s bound.
- Forwards within 1e-5 (tests/test_torch_am_nnet.py): nnet-compute,
  nnet-logprob, nnet-logprob2 (and the -parallel names),
  nnet-compute-from-egs; nnet-gradient within 1e-5 of each leaf's
  largest |value|; the printed objectives and statistics (compute-prob,
  am-stats, show-progress, limit-degradation) at 4 decimals within
  1.5e-4, a host line equal.
- nnet-am-reinitialize draws a zero output layer (stddev 0 times a
  draw): every array equal, the zeros' signs aside.
- Fitted on the device: nnet-am-shrink (and nnet-shrink) by
  tests/test_torch_surgery.py's shrink contract (`test_shrink_...`);
  nnet-am-fix within 1e-5; nnet-am-rescale with JAX's dtypes (f64
  scaled layers: numpy promotes the f32 weights by the clipped f64
  scale) within 1e-5 of each leaf; trainers within 1e-5
  (chip_smoke.TRAIN_LIMITS["f32"]); nnet-train-discriminative-simple's
  update within 1e-3 of its largest |value| (posteriors of lattices
  rescored with loglikes 1e-5 apart, as in test_torch_cli_nnet1).
- nnet-align-compiled: JAX's alignments.
"""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.io.kaldi_io import read_ark, write_ark
from test_torch_cli_features import run_both, same_arks, same_bytes, tol
from test_torch_cli_gmm import rel_close, same_files, same_leaves
from test_torch_cli_nnet1 import SEQ_UPDATE_REL, proto
from test_torch_cli_nnet2 import (SEARCH, TRAIN_REL, jok, nnet2_system,
                                  std_ratio_ok)
from test_torch_cli_nnet3 import PRINTED, _numbers

torch.set_num_threads(2)

FWD = dict(rtol=1e-5, atol=1e-5)     # tests/test_torch_am_nnet.py
SHRINK_REL = 1e-4                    # tests/test_torch_surgery.py
WIDEN_ATOL = 2e-5                    # tests/test_torch_surgery.py


def tools_system(root):
    """nnet2_system plus the inputs of the tools -> P(name) -> path."""
    P = nnet2_system(root)
    feats = f"ark:{P('feats.ark')}"
    from kaldi_tpu_torch.io.model_io import load_gmm_system
    pdfs = load_gmm_system(P("mono.npz"), device="cpu").am.num_pdfs
    with open(P("net.proto"), "w") as f:
        f.write(proto(("AffineTransform", 39, 16), ("Sigmoid", 16, 16),
                      ("AffineTransform", 16, pdfs), ("Softmax", pdfs, pdfs)))
    for argv in (
            ["nnet-am-init", P("mono.npz"), feats, P("nr0.npz"),
             "--splice-indexes=-1,0,1;0", "--hidden-dim", "16",
             "--nonlinearity", "relu"],
            ["nnet-to-raw-nnet", P("nn2.npz"), P("raw.npz")],
            ["nnet-initialize", P("net.proto"), P("init.nnet")],
            ["nnet3-acc-lda-stats", P("egs"), P("lda.npz")],
            ["ali-to-pdf", P("mono.npz"), f"ark:{P('ali.ark')}",
             f"ark:{P('pdf.ark')}"],
            ["ali-to-post", f"ark:{P('pdf.ark')}", P("post.txt")],
            ["gmm-latgen-faster", P("mono.npz"), P("hclg.npz"),
             f"ark:{P('few.ark')}", "--lattice-out", P("lat.ark")] + SEARCH):
        jok(argv)
    rng = np.random.RandomState(1)
    write_ark(P("wts.ark"), {k: rng.rand(v.shape[0]).astype(np.float32)
                             for k, v in read_ark(P("feats.ark"))})
    write_ark(P("chol.ark"), {"L": np.tril(rng.randn(39, 39) * 0.1)
                              .astype(np.float32)})
    keys = [k for k, _v in read_ark(P("feats.ark"))]
    write_ark(P("num.ark"), {k: rng.randn(1).astype(np.float32)
                             for k in keys})
    write_ark(P("den.ark"), {k: rng.randn(1).astype(np.float32)
                             for k in keys[1:]})
    raw_nets(P, pdfs)
    jok(["nnet-get-egs-discriminative", P("nn1.npz"), f"ark:{P('few.ark')}",
         f"ark:{P('ali.ark')}", P("lat.ark"), P("degs"), "--num-archives",
         "2"])
    return P


def raw_nets(P, pdfs: int):
    """JAX-written raw nets that stack on nn1.npz (hidden 32, p-norm 8):
    raw8.npz (8 inputs, nn1's p-norm width, -> the pdfs) and rawa.npz
    (39 -> 8 outputs, raw8's input)."""
    from kaldi_tpu.io.model_io import save_raw_nnet
    from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu_torch.params import random_tdnn_params
    rng = np.random.default_rng(2)
    for name, feat, out, splice in (("raw8.npz", 8, pdfs, ((0,),)),
                                    ("rawa.npz", 39, 8, ((-1, 0, 1),))):
        cfg = TdnnConfig(feat_dim=feat, num_pdfs=out, splice_indexes=splice,
                         hidden_dim=32, pnorm_output_dim=8)
        save_raw_nnet(P(name), Tdnn(cfg), random_tdnn_params(cfg, rng))


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    return tools_system(tmp_path_factory.mktemp("nnet_tools_sys"))


def _run(sysd, tmp, argv_fn, device=False):
    return run_both(str(tmp), lambda O: argv_fn(sysd, O), device)


def _o(O, *n):
    return os.path.join(O, *n)


def _f(P, name="feats.ark"):
    return f"ark:{P(name)}"


HOST_CASES = {
    "nnet-am-mixup": lambda P, O: [
        "nnet-am-mixup", P("nn1.npz"), _o(O, "m.npz"), "--num-mixtures",
        "40", "--seed", "2"],
    "nnet-am-limit-rank": lambda P, O: [
        "nnet-am-limit-rank", P("nn1.npz"), _o(O, "r.npz"), "--rank", "5"],
    "nnet-am-limit-rank-final": lambda P, O: [
        "nnet-am-limit-rank-final", P("nn1.npz"), _o(O, "r.npz"),
        "--rank", "3"],
    "nnet-replace-last-layers": lambda P, O: [
        "nnet-replace-last-layers", P("nn1.npz"), P("raw8.npz"),
        _o(O, "r.npz"), "--remove-layers", "1"],
    "nnet-insert": lambda P, O: [
        "nnet-insert", P("nn1.npz"), P("raw8.npz"), _o(O, "i.npz"),
        "--insert-at", "1"],
    "nnet-normalize-stddev": lambda P, O: [
        "nnet-normalize-stddev", P("nn1.npz"), _o(O, "n.npz"), "--stddev",
        "0.3"],
    "nnet-normalize-stddev --stddev-from": lambda P, O: [
        "nnet-normalize-stddev", P("nn1.npz"), _o(O, "n.npz"),
        "--stddev-from", P("nn2.npz")],
    "nnet-am-switch-preconditioning": lambda P, O: [
        "nnet-am-switch-preconditioning", P("nn1.npz"), _o(O, "p.npz"),
        "--rank-in", "7"],
    "nnet-modify-learning-rates": lambda P, O: [
        "nnet-modify-learning-rates", P("nn0.npz"), P("nn1.npz"),
        _o(O, "m.npz"), "--last-layer-factor", "0.5"],
    "nnet-to-raw-nnet": lambda P, O: [
        "nnet-to-raw-nnet", P("nn1.npz"), _o(O, "raw.npz")],
    "nnet-to-raw-nnet --truncate": lambda P, O: [
        "nnet-to-raw-nnet", P("nn1.npz"), _o(O, "raw.npz"), "--truncate",
        "1"],
    "raw-nnet-copy": lambda P, O: ["raw-nnet-copy", P("raw.npz"),
                                   _o(O, "c.npz")],
    "raw-nnet-info": lambda P, O: ["raw-nnet-info", P("raw.npz")],
    "raw-nnet-concat": lambda P, O: [
        "raw-nnet-concat", P("rawa.npz"), P("raw8.npz"), _o(O, "c.npz")],
    "nnet1-to-raw-nnet": lambda P, O: [
        "nnet1-to-raw-nnet", P("init.nnet"), _o(O, "r.npz")],
    "nnet2-boost-silence": lambda P, O: [
        "nnet2-boost-silence", "1", P("mono.npz"), P("nn1.npz"),
        _o(O, "b.npz"), "--boost", "2.0"],
    "nnet-select-egs": lambda P, O: [
        "nnet-select-egs", P("egs"), _o(O, "e"), "--n", "3", "--k", "1",
        "--num-archives", "2"],
    "nnet-relabel-egs": lambda P, O: [
        "nnet-relabel-egs", _f(P, "pdf.ark"), P("egs"), _o(O, "e")],
    "nnet-get-weighted-egs": lambda P, O: [
        "nnet-get-weighted-egs", _f(P), P("post.txt"), _f(P, "wts.ark"),
        _o(O, "e"), "--left-context", "2", "--right-context", "2"],
    "nnet-perturb-egs": lambda P, O: [
        "nnet-perturb-egs", P("chol.ark"), P("egs"), _o(O, "e"),
        "--seed", "3"],
    "nnet-perturb-egs-fmllr": lambda P, O: [
        "nnet-perturb-egs-fmllr", P("chol.ark"), P("egs"), _o(O, "e"),
        "--noise-factor", "0.5"],
    "nnet-get-feature-transform": lambda P, O: [
        "nnet-get-feature-transform", _o(O, "t.ark"), P("lda.npz"),
        "--dim", "20"],
    "nnet-get-feature-transform-multi": lambda P, O: [
        "nnet-get-feature-transform-multi", _o(O, "t.ark"), P("lda.npz"),
        P("lda.npz")],
    "nnet-get-egs-discriminative": lambda P, O: [
        "nnet-get-egs-discriminative", P("nn1.npz"), _f(P, "few.ark"),
        _f(P, "ali.ark"), P("lat.ark"), _o(O, "d")],
    "nnet-copy-egs-discriminative": lambda P, O: [
        "nnet-copy-egs-discriminative", P("degs"), _o(O, "d")],
    "nnet-shuffle-egs-discriminative": lambda P, O: [
        "nnet-shuffle-egs-discriminative", P("degs"), _o(O, "d"),
        "--seed", "4", "--num-archives", "2"],
    "nnet-combine-egs-discriminative": lambda P, O: [
        "nnet-combine-egs-discriminative", _o(O, "d"), P("degs"),
        P("degs")],
    "nnet-compare-hash-discriminative": lambda P, O: [
        "nnet-compare-hash-discriminative", P("degs"), P("degs")],
    "compute-mce-scale": lambda P, O: [
        "compute-mce-scale", _f(P, "num.ark"), _f(P, "den.ark"),
        f"ark:{_o(O, 's.ark')}", "--mce-alpha", "2.0"],
    "build-pfile-from-ali": lambda P, O: [
        "build-pfile-from-ali", P("mono.npz"), _f(P, "ali.ark"),
        _f(P, "few.ark"), _o(O, "pfile.txt")],
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_commands_write_jax_bytes(sysd, tmp_path, name):
    same_bytes(_run(sysd, tmp_path, HOST_CASES[name]))


def test_widen_matches_jax_by_outcome(sysd, tmp_path):
    """The old units' weights JAX's, the output preserved, the new units
    drawn at JAX's stddev (their outgoing rows zero)."""
    from kaldi_tpu_torch.io.model_io import load_am_nnet
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet-am-widen", P("nr0.npz"), _o(O, "w.npz"), "--hidden-dim",
        "128", "--seed", "1"])
    (jd, jout, jc), (td, tout, tc) = res["jax"], res["port"]
    assert jc == tc == 0 and jout == tout
    zj, zt = np.load(_o(jd, "w.npz")), np.load(_o(td, "w.npz"))
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
        if k.endswith(".w") and k.startswith("layer"):
            old = zj[k][:, :16]
            rel_close(1e-6)(k, zt[k][:, :16], old)
            assert std_ratio_ok(zt[k][:, 16:], zj[k][:, 16:]), k
        elif zj[k].dtype.kind == "f":
            rel_close(1e-6)(k, zt[k], zj[k])
        else:
            assert np.array_equal(zt[k], zj[k]), k
    x = np.stack([v for _k, v in read_ark(sysd("few.ark"))][:1])
    before = load_am_nnet(sysd("nr0.npz"), "cpu").log_posteriors(x)
    after = load_am_nnet(_o(td, "w.npz"), "cpu").log_posteriors(x)
    torch.testing.assert_close(after, before, rtol=0, atol=WIDEN_ATOL)


FWD_CASES = {
    "nnet-compute": (lambda P, O: [
        "nnet-compute", P("raw.npz"), _f(P, "few.ark"),
        f"ark:{_o(O, 'y.ark')}", "--apply-exp"], ["y.ark"]),
    "nnet-compute (am)": (lambda P, O: [
        "nnet-compute", P("nn1.npz"), _f(P, "few.ark"),
        f"ark:{_o(O, 'y.ark')}"], ["y.ark"]),
    "nnet-logprob": (lambda P, O: [
        "nnet-logprob", P("nn1.npz"), _f(P, "few.ark"),
        f"ark:{_o(O, 'y.ark')}"], ["y.ark"]),
    "nnet-logprob-parallel": (lambda P, O: [
        "nnet-logprob-parallel", P("nn2.npz"), _f(P, "few.ark"),
        f"ark:{_o(O, 'y.ark')}"], ["y.ark"]),
    "nnet-logprob2": (lambda P, O: [
        "nnet-logprob2", P("nn1.npz"), _f(P, "few.ark"),
        f"ark:{_o(O, 'p.ark')}", f"ark:{_o(O, 'l.ark')}"],
        ["p.ark", "l.ark"]),
    "nnet-logprob2-parallel": (lambda P, O: [
        "nnet-logprob2-parallel", P("nn2.npz"), _f(P, "few.ark"),
        f"ark:{_o(O, 'p.ark')}", f"ark:{_o(O, 'l.ark')}"],
        ["p.ark", "l.ark"]),
    "nnet-compute-from-egs": (lambda P, O: [
        "nnet-compute-from-egs", P("nn1.npz"), P("valid"),
        f"ark:{_o(O, 'y.ark')}", "--max-examples", "6"], ["y.ark"]),
}


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_forwards_within_bound(sysd, tmp_path, name):
    argv, arks = FWD_CASES[name]
    res = _run(sysd, tmp_path, argv, device=True)
    for a in arks:
        same_arks(res, a, tol(**FWD))


PRINT_CASES = {
    "nnet-compute-prob": lambda P, O: [
        "nnet-compute-prob", P("nn1.npz"), P("valid")],
    "nnet-am-stats": lambda P, O: [
        "nnet-am-stats", P("nn1.npz"), "--egs", P("valid")],
    "nnet-show-progress": lambda P, O: [
        "nnet-show-progress", P("nn0.npz"), P("nn1.npz"), P("valid")],
}


@pytest.mark.parametrize("name", sorted(PRINT_CASES))
def test_printed_numbers_within_bound(sysd, tmp_path, name):
    res = _run(sysd, tmp_path, PRINT_CASES[name], device=True)
    (_jd, jout, jc), (_td, tout, tc) = res["jax"], res["port"]
    assert jc == tc == 0
    jl, tl = jout.splitlines(), tout.splitlines()
    assert len(jl) == len(tl) and jl
    for a, b in zip(jl, tl):
        if "param-change" in a or ": w (" in a:
            assert a == b                     # host lines
        np.testing.assert_allclose(_numbers(b), _numbers(a), rtol=0,
                                   atol=PRINTED)


@pytest.mark.parametrize("name", ["nnet-am-shrink", "nnet-shrink"])
def test_shrink_within_bound(sysd, tmp_path, name):
    """tests/test_torch_surgery.py's shrink contract: the output layer
    within 1e-4 and the log-posteriors within 1e-5. The hidden layers'
    scales are free: the RMS normalize after each p-norm cancels them,
    so their gradient is rounding noise that Adam steps on by its sign,
    in JAX as in the port."""
    from kaldi_tpu_torch.io.model_io import load_am_nnet
    from kaldi_tpu_torch.cli import _read_egs_dir
    res = _run(sysd, tmp_path, lambda P, O: [
        name, P("nn1.npz"), P("valid"), _o(O, "s.npz"), "--num-steps",
        "10"], device=True)
    (jd, _jo, jc), (td, _to, tc) = res["jax"], res["port"]
    assert jc == tc == 0
    zj, zt = np.load(_o(jd, "s.npz")), np.load(_o(td, "s.npz"))
    same_leaves(zj, zt)
    for k in ("final_w", "final_b"):
        rel_close(SHRINK_REL)(k, zt[k], zj[k])
    x = _read_egs_dir(sysd("valid"))["feats"]
    got, want = (load_am_nnet(_o(d, "s.npz"), "cpu").log_posteriors(
        x, pad_context=False) for d in (td, jd))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_reinitialize_equals_jax(sysd, tmp_path):
    """A zero output layer from a draw times stddev 0: every array JAX's,
    the signs of its zeros aside (the draws differ)."""
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet-am-reinitialize", P("nn1.npz"), P("mono.npz"),
        _o(O, "r.npz")])
    same_files(res)


MODEL_CASES = {
    "nnet-am-fix": (lambda P, O: [
        "nnet-am-fix", P("nn1.npz"), P("valid"), _o(O, "f.npz"),
        "--min-average", "0.5", "--max-average", "1.5"], 1e-5),
    "nnet-gradient": (lambda P, O: [
        "nnet-gradient", P("nn1.npz"), P("valid"), _o(O, "g.npz")], 1e-5),
    "nnet-limit-degradation": (lambda P, O: [
        "nnet-limit-degradation", P("nn1.npz"), P("nn0.npz"), P("valid"),
        _o(O, "l.npz"), "--max-degradation", "0.01"], 1e-5),
    "nnet-train-simple-perturbed": (lambda P, O: [
        "nnet-train-simple-perturbed", P("nn0.npz"), P("valid"),
        _o(O, "t.npz"), "--num-epochs", "2", "--minibatch-size", "8"],
        TRAIN_REL),
    "nnet-train-parallel-perturbed": (lambda P, O: [
        "nnet-train-parallel-perturbed", P("nn0.npz"), P("valid"),
        _o(O, "t.npz"), "--num-epochs", "1", "--minibatch-size", "8",
        "--noise-factor", "0.5"], TRAIN_REL),
    "nnet-train-ensemble": (lambda P, O: [
        "nnet-train-ensemble", P("valid"), P("nn0.npz"), P("nn1.npz"),
        _o(O, "e0.npz"), _o(O, "e1.npz"), "--num-epochs", "2",
        "--minibatch-size", "8"], TRAIN_REL),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_commands_within_bound(sysd, tmp_path, name):
    argv, rel = MODEL_CASES[name]
    res = _run(sysd, tmp_path, argv, device=True)
    same_files(res, close=rel_close(rel), printed=False)


def test_rescale_within_bound(sysd, tmp_path):
    """JAX's file holds f64 layers (numpy promotes the f32 weights by the
    clipped f64 scale), and so does the port's: each leaf has JAX's dtype
    and shape, within 1e-5 of its largest |value|."""
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet-am-rescale", P("nn1.npz"), P("valid"), _o(O, "r.npz"),
        "--num-iters", "2"], device=True)
    same_files(res, close=rel_close(1e-5), printed=False)
    z = np.load(_o(res["port"][0], "r.npz"))
    assert {z[k].dtype for k in z.files if k.startswith("layer")} >= {
        np.dtype(np.float64)}
    from kaldi_tpu.io.model_io import load_am_nnet as jax_load_am_nnet
    jax_load_am_nnet(_o(res["port"][0], "r.npz"))


@pytest.mark.parametrize("name", ["nnet-train-discriminative-simple",
                                  "nnet-train-discriminative-parallel"])
def test_discriminative_within_the_posteriors_bound(sysd, tmp_path, name):
    res = _run(sysd, tmp_path, lambda P, O: [
        name, P("nn1.npz"), P("mono.npz"), P("degs"), _o(O, "d.npz"),
        "--criterion", "mmi", "--learning-rate", "1e-3"], device=True)
    (jd, _jo, jc), (td, _to, tc) = res["jax"], res["port"]
    assert jc == tc == 0
    z0 = np.load(sysd("nn1.npz"))
    zj, zt = np.load(_o(jd, "d.npz")), np.load(_o(td, "d.npz"))
    same_leaves(zj, zt)
    for k in zj.files:
        if zj[k].dtype.kind != "f" or k == "priors":
            assert np.array_equal(zt[k], zj[k]), k
            continue
        step = zj[k].astype(np.float64) - z0[k]
        assert np.abs((zt[k] - z0[k]) - step).max() <= SEQ_UPDATE_REL * max(
            np.abs(step).max(), 1e-30), k


def test_align_compiled_matches_jax(sysd, tmp_path):
    res = _run(sysd, tmp_path, lambda P, O: [
        "nnet-align-compiled", P("mono.npz"), P("nn1.npz"), P("text"),
        _f(P, "few.ark"), f"ark:{_o(O, 'a.ark')}"], device=True)
    same_bytes(res)
