"""BENCHMARK.json against the contract: every cell resolves its
configuration, traffic mix, runner and metric files; names, units and
lines keep to their characters; a new configuration, mix and metric are
added as files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def manifest():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def line_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes():
    m = manifest()
    assert set(m) == TOP_KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert m["paths"] == ["benchmark"]
    assert all(line_ok(w) for w in m["command"]) and len(m["command"]) <= 32
    assert 1 <= m["run_seconds"] <= 51
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    cells = len(m["workloads"])
    assert 2 + 14 * 24 * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells >= 1


def test_names_units_and_lines():
    m = manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in m[k]}) == len(m[k])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(r) for r in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line_ok(w["why"])
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) \
        == len(m["workloads"])


def test_metrics_keep_the_contract():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    layers = {}
    for x in m["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(x["layer"]) and x["moves"] in e2e
        mv = e2e[x["moves"]]
        for w in x["workloads"]:
            assert w in mv.get("workloads", [w])
        layers.setdefault(x["layer"], []).append(x["name"])
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"
    for w in m["workloads"]:
        mine = [x for x in m["end_to_end"]
                if w["name"] in x.get("workloads", [w["name"]])]
        assert "setup_s" in [x["name"] for x in mine] and len(mine) >= 2
        assert any(w["name"] in x["workloads"] for x in m["per_layer"])
        moved = {x["moves"] for x in m["per_layer"]
                 if w["name"] in x["workloads"]}
        assert any("mfu" in x["name"] for x in m["per_layer"]
                   if w["name"] in x["workloads"]), w["name"]
        assert moved <= {x["name"] for x in mine}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_json(os.path.join(
                                      ROOT, "BENCHMARK.json"))["workloads"]])
def test_cell_resolves(cell):
    c = harness.resolve_cell(manifest(), ROOT, cell)
    drv = harness.runner_of(c)
    for fn in ("setup", "run_window", "check", "control_numbers"):
        assert callable(getattr(drv, fn))
    for x in c.per_layer:
        assert callable(harness.metric_reader(x["name"]).read)
    assert set(c.mix["limits"])


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _dirs, files in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_new_entries_need_no_edit(tmp_path):
    """A throwaway configuration, mix and metric added as new files and
    new manifest entries resolve and read, in a copy of the folder."""
    root = tmp_path / "co"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest()
    cfg = json.load(open(os.path.join(BENCH, "configs",
                                      "tdnn1024_hclg60k.json")))
    cfg["search"]["beam"] = 11.0
    (root / "benchmark" / "configs" / "throwaway_cfg.json").write_text(
        json.dumps(cfg))
    mix = json.load(open(os.path.join(BENCH, "traffic",
                                      "offline_lognormal_b32.json")))
    mix["pool_utts"] = 32
    (root / "benchmark" / "traffic" / "throwaway_mix.json").write_text(
        json.dumps(mix))
    (root / "benchmark" / "metrics" / "throwaway_count.decode.py"
     ).write_text("def read(run):\n    return run['counters'].get('x')\n")
    m["configs"].append({"name": "throwaway_cfg", "source": "a paper",
                         "file": "benchmark/configs/throwaway_cfg.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "throwaway_cell",
                           "config": "throwaway_cfg",
                           "traffic": "throwaway_mix", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "throwaway_count.decode", "unit": "n",
                           "better": "lower", "source": "program_counter",
                           "layer": "a test", "moves": "audio_s_per_s",
                           "workloads": ["throwaway_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    code = (
        "import sys; sys.path[:0] = [sys.argv[1] + '/benchmark']\n"
        "import harness, json\n"
        "m = harness.load_json(sys.argv[1] + '/BENCHMARK.json')\n"
        "c = harness.resolve_cell(m, sys.argv[1], 'throwaway_cell')\n"
        "assert c.config['search']['beam'] == 11.0\n"
        "assert c.mix['pool_utts'] == 32\n"
        "assert [x['name'] for x in c.per_layer] == "
        "['throwaway_count.decode']\n"
        "r = harness.metric_reader('throwaway_count.decode')\n"
        "assert r.read({'counters': {'x': 3}}) == 3\n"
        "assert harness.runner_of(c).__name__.endswith('offline_decode')\n")
    r = subprocess.run([sys.executable, "-c", code, str(root)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
