"""Card-only: each cell run once with a short window, its result line in
the contract's shape and correct; the control at the cell's own size
fails one of its limits. Skips without a CUDA card (the `card` fixture
decides when the test runs)."""

import json
import os
import subprocess
import sys

import pytest

import harness
from conftest import BENCH, ROOT

CELLS = [w["name"] for w in harness.load_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", cell, "--seed", "2147483659",
                        "--seconds", "5", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["correct"], res["checks"]
    assert "setup_s" in res["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(card, cell):
    r = subprocess.run([sys.executable, os.path.join(BENCH, "control.py"),
                        "--workload", cell, "--seeds", "2147483701"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["fails"]
