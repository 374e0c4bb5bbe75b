"""Port parity: the CLI's last slice (5b), its 9 fMPE subcommands
(kaldi_tpu_torch/cli.py's fmpe-* and cli_gmm_extra.py's fMPE
derivatives) against kaldi_tpu's CLI, on the CPU.

fMPE is host code in both packages (the UBM's posteriors and the
per-pdf DiagGmms score on the host, the products are numpy f64), so every
command writes JAX's bytes and prints JAX's lines. The inputs are
test_torch_cli_gmm.py's `jax_system` (JAX's mono model, posteriors plain
and signed, accumulators and a diagonal UBM) plus JAX's fMPE transform
after one update and its accumulators. The fMPE file (`M`, the UBM,
int64 dim, f64 post_scale and learning_rate, the context windows as JSON
bytes) and the accumulator file (`acc`, f64 frames) load in the other
package both ways, and the transform's training loop runs through the
port's files alone. test_feat_lattice_extras_cli.py's,
test_util_cli.py's and test_gmm_extras_cli.py's fMPE cases, on the port.
"""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu import cli as jcli
from kaldi_tpu.cli import main as jmain
from kaldi_tpu_torch import cli as tcli
from kaldi_tpu_torch.io.kaldi_io import read_ark
from test_torch_cli_features import _call, run_both, same_bytes
from test_torch_cli_gmm import jax_system

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    """`jax_system` plus JAX's fMPE transform before (fmpe0) and after
    (fmpe1) one update, its accumulators, and denominator GMM stats."""
    root = tmp_path_factory.mktemp("fmpe")
    P = jax_system(root)
    feats = f"ark:{P('feats.ark')}"
    for argv in (
            ["fmpe-init", P("dubm.npz"), P("fmpe0.npz")],
            ["fmpe-acc-stats", P("mono.npz"), P("fmpe0.npz"), feats,
             P("signed.txt"), P("facc.npz")],
            ["fmpe-est", P("fmpe0.npz"), P("facc.npz"), P("fmpe1.npz")],
            ["gmm-acc-stats", P("mono.npz"), feats, P("signed.txt"),
             P("den.npz")]):
        assert _call(jmain, argv)[1] == 0, argv
    return P


def _cases(P, d):
    feats = f"ark:{P('feats.ark')}"
    o = lambda n: os.path.join(d, n)                         # noqa: E731
    return {
        "fmpe-init": ["fmpe-init", P("dubm.npz"), o("f.npz"),
                      "--post-scale", "4.0", "--learning-rate", "0.01"],
        "fmpe-copy": ["fmpe-copy", P("fmpe1.npz"), o("f.npz")],
        "fmpe-acc-stats": ["fmpe-acc-stats", P("mono.npz"), P("fmpe1.npz"),
                           feats, P("signed.txt"), o("a.npz")],
        "fmpe-sum-accs": ["fmpe-sum-accs", o("a.npz"), P("facc.npz"),
                          P("facc.npz")],
        "fmpe-est": ["fmpe-est", P("fmpe1.npz"), P("facc.npz"), o("f.npz")],
        "fmpe-apply-transform": ["fmpe-apply-transform", P("fmpe1.npz"),
                                 feats, f"ark:{o('x.ark')}"],
        "gmm-get-feat-deriv": ["gmm-get-feat-deriv", P("mono.npz"), feats,
                               P("signed.txt"), f"ark:{o('x.ark')}"],
        "gmm-fmpe-acc-stats": ["gmm-fmpe-acc-stats", P("mono.npz"),
                               P("fmpe1.npz"), feats, P("signed.txt"),
                               o("a.npz")],
        "gmm-get-stats-deriv": ["gmm-get-stats-deriv", P("mono.npz"),
                                P("acc.npz"), P("den.npz"), P("acc.npz"),
                                o("a.npz")],
    }


@pytest.mark.parametrize("name", sorted(_cases(lambda n: n, "")))
def test_fmpe_command_writes_jax_bytes(sysd, tmp_path, name):
    """Each fMPE command (host code): JAX's files byte for byte and
    JAX's printed lines."""
    same_bytes(run_both(str(tmp_path), lambda d: _cases(sysd, d)[name],
                        device=False))


def test_fmpe_files_load_both_ways(sysd, tmp_path):
    """The port's fMPE and accumulator files are JAX's: JAX loads the
    port's transform and applies it as the port does; the port loads
    JAX's, keys, dtypes and values intact."""
    P = sysd
    out = str(tmp_path / "f.npz")
    assert _call(tcli.main, ["fmpe-est", P("fmpe1.npz"), P("facc.npz"),
                             out])[1] == 0
    x = next(iter(read_ark(P("feats.ark"))))[1].astype(np.float64)
    jf, tf = jcli._load_fmpe(out), tcli._load_fmpe(out)
    np.testing.assert_array_equal(np.asarray(jf.apply(x)), tf.apply(x))
    z = np.load(out)
    assert z["dim"].dtype == np.int64 and z["post_scale"].dtype == np.float64
    assert z["context_windows"].dtype == np.uint8
    t = tcli._load_fmpe(P("fmpe1.npz"))
    j = jcli._load_fmpe(P("fmpe1.npz"))
    np.testing.assert_array_equal(t.M, j.M)
    assert t.opts == type(t.opts)(**vars(j.opts)) and t.dim == j.dim
    za = np.load(P("facc.npz"))
    assert za["acc"].dtype == np.float64 and za["frames"].dtype == np.float64


def test_fmpe_training_loop_through_port_files(sysd, tmp_path):
    """fMPE training as primitives on the port alone (init, two sharded
    accumulations summed, an update, the features transformed): the
    shards sum to one unsharded accumulation and the transform moves the
    features, finitely."""
    P = sysd
    o = lambda n: str(tmp_path / n)                          # noqa: E731
    feats = f"ark:{P('feats.ark')}"
    utts = [line.split()[0] for line in open(P("text"))]
    halves = [utts[::2], utts[1::2]]
    for i, keep in enumerate(halves):
        with open(P("signed.txt")) as f, open(o(f"post{i}.txt"), "w") as g:
            g.writelines(line for line in f if line.split()[0] in keep)
    for argv in (["fmpe-init", P("dubm.npz"), o("f0.npz")],
                 ["fmpe-acc-stats", P("mono.npz"), o("f0.npz"), feats,
                  P("signed.txt"), o("all.npz")],
                 ["fmpe-acc-stats", P("mono.npz"), o("f0.npz"), feats,
                  o("post0.txt"), o("a0.npz")],
                 ["fmpe-acc-stats", P("mono.npz"), o("f0.npz"), feats,
                  o("post1.txt"), o("a1.npz")],
                 ["fmpe-sum-accs", o("sum.npz"), o("a0.npz"), o("a1.npz")],
                 ["fmpe-est", o("f0.npz"), o("sum.npz"), o("f1.npz")],
                 ["fmpe-apply-transform", o("f1.npz"), feats,
                  f"ark:{o('x.ark')}"]):
        assert _call(tcli.main, argv)[1] == 0, argv
    s, a = np.load(o("sum.npz")), np.load(o("all.npz"))
    assert float(s["frames"]) == float(a["frames"])
    np.testing.assert_allclose(s["acc"], a["acc"], rtol=1e-9,
                               atol=1e-12 * np.abs(a["acc"]).max())
    before = dict(read_ark(P("feats.ark")))
    after = dict(read_ark(o("x.ark")))
    assert list(after) == list(before)
    moved = max(np.abs(after[k] - before[k]).max() for k in before)
    assert np.isfinite(moved) and moved > 0
