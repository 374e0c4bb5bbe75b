"""The check that neither JAX nor the JAX package is loaded compares the
top-level module name whole, and a run's imports pass it."""

import subprocess
import sys
import types

import harness
from conftest import BENCH, ROOT


def test_top_level_name_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kaldi_tpu_torch_like",
                        types.ModuleType("kaldi_tpu_torch_like"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    assert harness.forbidden_modules() == [] or \
        set(harness.forbidden_modules()) <= {"jax", "jaxlib", "flax",
                                             "kaldi_tpu"}
    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "kaldi_tpu.x",
                        types.ModuleType("kaldi_tpu.x"))
    assert set(harness.forbidden_modules()) == base | {"kaldi_tpu"}


def test_a_run_loads_neither():
    """Every module a run imports (the harness, each runner with the
    program it drives, each metric reader) leaves sys.modules free of
    jax, jaxlib, flax and kaldi_tpu."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import os, harness, run\n"
        "m = harness.load_json(os.path.join(sys.argv[2], 'BENCHMARK.json'))\n"
        "for w in m['workloads']:\n"
        "    c = harness.resolve_cell(m, sys.argv[2], w['name'])\n"
        "    d = harness.runner_of(c)\n"
        "    for x in c.per_layer: harness.metric_reader(x['name'])\n"
        "import kaldi_tpu_torch.decoder.batching, kaldi_tpu_torch.steps.sre\n"
        "import kaldi_tpu_torch.nnet.train, kaldi_tpu_torch.recognize\n"
        "bad = harness.forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'kaldi_tpu_torch' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code, BENCH, ROOT],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_references_and_inputs_import_no_program():
    """The yardstick (reference/, inputs/, metrics/) imports nothing of
    the program."""
    code = (
        "import sys, os; sys.path[:0] = [sys.argv[1]]\n"
        "sys.path.append(os.path.join(sys.argv[1], 'metrics'))\n"
        "import importlib, glob\n"
        "for sub in ('reference', 'inputs'):\n"
        "    for f in sorted(glob.glob(os.path.join(sys.argv[1], sub, "
        "'*.py'))):\n"
        "        name = os.path.basename(f)[:-3]\n"
        "        importlib.import_module(sub + '.' + name)\n"
        "import harness\n"
        "for f in glob.glob(os.path.join(sys.argv[1], 'metrics', '*.py')):\n"
        "    harness.load_module(f, 'm_' + os.path.basename(f)[:-3]"
        ".replace('.', '_'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('kaldi_tpu_torch', 'kaldi_tpu', 'jax', 'jaxlib', 'flax')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code, BENCH],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_run_refuses_without_a_card(tmp_path):
    """run.py exits non-zero and prints no result when it finds no card
    (or, in a folder without the program, fails to import it)."""
    import torch
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, BENCH + "/run.py", "--workload",
                        "asr_offline_b32", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
