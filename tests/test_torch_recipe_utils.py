"""Port parity: the recipe utilities (kaldi_tpu_torch/steps/egs.py,
utils/optimization.py, gpsr.py, data_dir.py, jobs.py, experiment.py,
profiling.py) against kaldi_tpu's on the CPU, mirroring
tests/test_egs_pipeline.py, test_optim_posterior.py, test_gpsr_klhmm.py,
test_data_dir.py and test_utils_aux.py: egs archives byte-equal and the
same minibatches; L-BFGS, CGD and PCA within 1e-6 of JAX's; the GPSR
solve; data directories read, validated, fixed and written alike;
`Experiment` stages resumed alike; `run_jobs` with run.pl's failure
marker, waiting for every job, and retries; `check_finite` naming bad
leaves with `jax.tree_util.keystr`'s path strings.
"""

import dataclasses
import os
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.steps import egs as jegs
from kaldi_tpu.utils import data_dir as jdd
from kaldi_tpu.utils import experiment as jexp
from kaldi_tpu.utils import gpsr as jgpsr
from kaldi_tpu.utils import jobs as jjobs
from kaldi_tpu.utils import optimization as jopt
from kaldi_tpu.utils import profiling as jprof
from kaldi_tpu_torch.steps import egs as tegs
from kaldi_tpu_torch.utils import data_dir as tdd
from kaldi_tpu_torch.utils import experiment as texp
from kaldi_tpu_torch.utils import gpsr as tgpsr
from kaldi_tpu_torch.utils import jobs as tjobs
from kaldi_tpu_torch.utils import optimization as topt
from kaldi_tpu_torch.utils import profiling as tprof


def _aligned(rng, n_utts=6, T=40, D=5):
    return [(rng.randn(T, D).astype(np.float32), rng.randint(0, 4, T))
            for _ in range(n_utts)]


@pytest.mark.parametrize("compress", [False, True])
def test_egs_archives_byte_equal_and_same_minibatches(tmp_path, compress):
    aligned = _aligned(np.random.RandomState(0))
    dirs = {}
    for side, mod in (("j", jegs), ("t", tegs)):
        d = str(tmp_path / side)
        assert mod.dump_egs(aligned, left_context=2, right_context=2,
                            chunk=8, out_dir=d, num_archives=3,
                            compress=compress, seed=4) == 3
        dirs[side] = d
    names = sorted(os.listdir(dirs["j"]))
    assert names == sorted(os.listdir(dirs["t"])) and names
    for n in names:
        with open(os.path.join(dirs["j"], n), "rb") as a, \
                open(os.path.join(dirs["t"], n), "rb") as b:
            assert a.read() == b.read(), n
    for epochs, seed in ((1, 0), (2, 1)):
        kw = dict(minibatch=5, num_archives=3, num_epochs=epochs,
                  buffer_size=16, seed=seed)
        jb = list(jegs.egs_minibatches(dirs["j"], **kw))
        tb = list(tegs.egs_minibatches(dirs["t"], **kw))
        assert len(tb) == len(jb) == 6 * epochs
        for (tx, ty), (jx, jy) in zip(tb, jb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            assert ty.dtype == jy.dtype == np.int32


def test_lbfgs_cgd_pca_equal_jax():
    rng = np.random.RandomState(0)
    A = rng.randn(6, 6)
    A = A @ A.T + 0.1 * np.eye(6)
    b = rng.randn(6)

    def fq(x):
        return 0.5 * x @ A @ x - b @ x, A @ x - b

    def rosen(x):
        f = 100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2
        g = np.array([-400 * x[0] * (x[1] - x[0] ** 2) - 2 * (1 - x[0]),
                      200 * (x[1] - x[0] ** 2)])
        return f, g
    for f, x0, kw in ((fq, np.zeros(6), {}),
                      (rosen, np.array([-1.2, 1.0]), dict(max_iters=500))):
        tx, tf, ti = topt.lbfgs(f, x0, **kw)
        jx, jf, ji = jopt.lbfgs(f, x0, **kw)
        np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
        assert tf == pytest.approx(jf, abs=1e-6) and ti == ji
    A = rng.randn(20, 20)
    A = A @ A.T + np.eye(20)
    b = rng.randn(20)
    d = np.diag(A)
    for kw in ({}, dict(precond=lambda v: v / d)):
        (tx, ti), (jx, ji) = topt.linear_cgd(A, b, **kw), \
            jopt.linear_cgd(A, b, **kw)
        np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
        assert ti == ji
    basis = rng.randn(2, 6)
    data = rng.randn(500, 2) * np.array([5.0, 2.0]) @ basis \
        + rng.randn(500, 6) * 0.1 + 3.0
    for nv in (False, True):
        np.testing.assert_allclose(
            topt.est_pca(data, 2, normalize_variance=nv),
            jopt.est_pca(data, 2, normalize_variance=nv), rtol=0, atol=1e-6)


def test_gpsr_equal_jax():
    rng = np.random.RandomState(0)
    for trial in range(5):
        n = 8
        A = rng.randn(n + 4, n)
        H = A.T @ A + 0.1 * np.eye(n)
        g = rng.randn(n) * 2.0
        x = tgpsr.gpsr(H, g, 0.5)
        np.testing.assert_allclose(x, jgpsr.gpsr(H, g, 0.5), rtol=0,
                                   atol=1e-9)
        assert tgpsr.gpsr_optimality_gap(H, g, 0.5, x) == pytest.approx(
            jgpsr.gpsr_optimality_gap(H, g, 0.5, x), abs=1e-12)
        assert tgpsr.gpsr_optimality_gap(H, g, 0.5, x) < 1e-4, trial
    np.testing.assert_allclose(
        tgpsr.gpsr(np.eye(3), np.array([2.0, 0.05, -0.5]), tau=0.3),
        [1.7, 0.0, -0.2], atol=1e-6)


DATA_DIRS = {
    "valid": {"wav.scp": "u1 /a.wav\nu2 /b.wav\n",
              "text": "u1 HELLO WORLD\nu2 BYE\n",
              "utt2spk": "u1 s1\nu2 s2\n"},
    "problems": {"wav.scp": "u2 /b.wav\nu1 /a.wav\n", "text": "u1 HI\n",
                 "utt2spk": "u1 s1\nu2 s2\n"},
    "fix": {"wav.scp": "u1 /a.wav\nu2 /b.wav\nu3 /c.wav\n",
            "text": "u1 HI\nu2 YO\n", "utt2spk": "u1 s1\nu2 s1\nu3 s2\n"},
    "segments": {"wav.scp": "rec1 /a.wav\n",
                 "segments": "u1 rec1 0.0 1.5\nu2 rec1 2.0 1.0\n",
                 "text": "u1 A\nu2 B\n", "utt2spk": "u1 s1\nu2 s1\n"},
}


@pytest.mark.parametrize("name", list(DATA_DIRS))
def test_data_dir_equal_jax(tmp_path, name):
    src = tmp_path / "data"
    src.mkdir()
    for f, content in DATA_DIRS[name].items():
        (src / f).write_text(content)
    td, jd = tdd.read_data_dir(str(src)), jdd.read_data_dir(str(src))
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert tdd.validate_data_dir(td) == jdd.validate_data_dir(jd)
    tf, jf = tdd.fix_data_dir(td), jdd.fix_data_dir(jd)
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    assert tdd.validate_data_dir(tf) == jdd.validate_data_dir(jf)
    outs = {}
    for side, mod, d in (("t", tdd, tf), ("j", jdd, jf)):
        out = str(tmp_path / f"out_{side}")
        mod.write_data_dir(d, out)
        outs[side] = {n: open(os.path.join(out, n)).read()
                      for n in sorted(os.listdir(out))}
    assert outs["t"] == outs["j"] and "spk2utt" in outs["t"]


def _stages(mod, d, runs, tag, **kw):
    exp = mod.Experiment(d, **kw)
    for name in ("prep", "train", "decode"):
        exp.stage(name, lambda n=name: runs.append(n + tag))
    return exp


def test_experiment_resume_equal_jax(tmp_path):
    logs = {}
    for side, mod in (("t", texp), ("j", jexp)):
        d = str(tmp_path / side)
        runs = []
        _stages(mod, d, runs, "1", config={"beam": 13.0})
        _stages(mod, d, runs, "2")
        _stages(mod, d, runs, "3", from_stage="train")
        logs[side] = runs
        cfg = open(os.path.join(d, "config.json")).read()
        assert "13.0" in cfg
        logs[side + "files"] = sorted(os.listdir(d))
    assert logs["t"] == logs["j"] == ["prep1", "train1", "decode1",
                                      "train3", "decode3"]
    assert logs["tfiles"] == logs["jfiles"]


def _logs(d, name, n):
    """Each job log with its timings cut out."""
    return [re.sub(r"in [0-9.]+s", "in _s",
                   open(os.path.join(d, f"{name}.{j}.log")).read())
            for j in range(1, n + 1)]


def test_run_jobs_failure_marker_and_retries_equal_jax(tmp_path):
    out = {}
    for side, mod in (("t", tjobs), ("j", jjobs)):
        d = str(tmp_path / side)
        t0 = time.time()
        with pytest.raises(mod.JobFailure) as e:
            mod.run_jobs(3, "sleep 0.$((JOB % 2)); exit $((JOB - 1))",
                         log_dir=d, name="t")
        assert time.time() - t0 >= 0.1        # waited for every job
        seen = []

        def flaky(job, seen=seen):
            seen.append(job)
            if job == 2 and seen.count(2) == 1:
                raise RuntimeError("transient")
            return job * 10
        res = mod.run_jobs(3, flaky, log_dir=d, name="f", max_retries=1)
        out[side] = (str(e.value).replace(d, "DIR"), _logs(d, "t", 3), res,
                     sorted(seen),
                     _logs(d, "f", 3))
    assert out["t"] == out["j"]
    assert "FAILED rc=1" in out["t"][1][1] and "FAILED rc=2" in \
        out["t"][1][2]
    assert out["t"][2] == [10, 20, 30]
    assert "recovered on retry 1" in out["t"][4][1]


def _with_nan(kind, shape=(3,)):
    a = np.ones(shape, np.float32)
    a.flat[-1] = np.nan if kind == "nan" else np.inf
    return a


TREES = [
    {"a": np.ones(3), "b": _with_nan("nan")},
    {"layer0": {"w": _with_nan("inf", (2, 2)), "b": np.ones(2)},
     "layer1": {"w": np.ones(2), "b": _with_nan("nan")}},
    [np.ones(2), (_with_nan("nan"), np.ones(1)), {"x": _with_nan("inf")}],
    (np.ones(2), _with_nan("nan")),
    {"ok": np.ones(2), "ints": np.array([1, 2])},
]


@pytest.mark.parametrize("i", range(len(TREES)))
def test_check_finite_paths_equal_jax(i):
    def conv(tree, leaf):
        if isinstance(tree, dict):
            return {k: conv(v, leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(conv(v, leaf) for v in tree)
        return leaf(tree)
    jt = conv(TREES[i], jnp.asarray)
    tt = conv(TREES[i], torch.from_numpy)
    try:
        jprof.check_finite(jt, name="params")
        want = None
    except FloatingPointError as e:
        want = str(e)
    if want is None:
        assert tprof.check_finite(tt, name="params") is tt
        return
    with pytest.raises(FloatingPointError) as e:
        tprof.check_finite(tt, name="params")
    assert str(e.value) == want


def test_profiling_timer_accu_and_trace(tmp_path):
    t = tprof.Timer()
    time.sleep(0.01)
    assert t.elapsed() >= 0.01
    prof = tprof.AccuProfiler()
    with prof.track("gemm"):
        time.sleep(0.005)
    with prof.track("gemm"):
        pass
    prof.accu("io", 0.5)
    assert prof.counts["gemm"] == 2 and prof.seconds["gemm"] >= 0.005
    assert "gemm" in prof.report() and "io" in prof.report()

    @dataclasses.dataclass
    class Params:
        w: torch.Tensor
        b: torch.Tensor
    with pytest.raises(FloatingPointError, match=r"\.b"):
        tprof.check_finite(Params(torch.ones(2),
                                  torch.tensor([1.0, float("nan")])))
    log = str(tmp_path / "trace")
    with tprof.device_trace(log):
        torch.ones(64, 64) @ torch.ones(64, 64)
    text = open(os.path.join(log, "trace.json")).read()
    assert "aten::mm" in text
