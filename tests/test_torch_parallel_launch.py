"""Port parity: kaldi_tpu_torch.parallel.launch against kaldi_tpu's.

`host_shard` gives JAX's shards; `launch_local` gang-restarts and writes
the accounting lines as JAX's does (tests/test_multihost_launch.py:63-101);
two gloo ranks brought up through the env contract reduce host-sharded
data to the same global sum on both; `init_distributed` with one process
is a no-op returning (0, 1), as JAX's is. Every gang runs on a free port
with a time limit.
"""

import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from kaldi_tpu.parallel.launch import host_shard as j_host_shard
from kaldi_tpu_torch.parallel import launch as tl
from kaldi_tpu_torch.parallel.launch import free_port

from torch_gang import ROOT, run_gang


@pytest.mark.parametrize("n_keys,n", [(11, 3), (8, 2), (5, 4), (16, 1), (3, 5)])
def test_host_shard_matches_jax(n_keys, n):
    keys = [f"utt{i:03d}" for i in range(n_keys)][::-1]
    shards = [tl.host_shard(keys, pid, n) for pid in range(n)]
    assert shards == [j_host_shard(keys, pid, n) for pid in range(n)]
    assert sorted(x for s in shards for x in s) == sorted(keys)
    assert max(map(len, shards)) - min(map(len, shards)) <= 1


def test_single_process_is_a_noop():
    """One process: (0, 1), no process group; host_shard's defaults are
    then rank 0 of a world of 1 (everything, sorted)."""
    assert tl.init_distributed(num_processes=1, device="cpu") == (0, 1)
    assert not dist.is_initialized()
    assert tl.host_shard(["b", "c", "a"]) == ["a", "b", "c"]
    with pytest.raises(ValueError, match="one process drives one device"):
        tl.init_distributed(local_device_count=2, device="cpu")


def test_gang_restart_on_preemption(tmp_path):
    """test_multihost_launch.py's gang restart on the port's launcher: a
    worker that dies on the first attempt brings the gang down, the gang
    is relaunched and completes; the logs carry run.pl's lines."""
    flag = tmp_path / "preempted_once"
    script = (
        "import os, sys\n"
        f"flag = {str(flag)!r}\n"
        "pid = os.environ.get('KALDI_TPU_PROCESS_ID')\n"
        "if pid == '1' and not os.path.exists(flag):\n"
        "    open(flag, 'w').close()\n"
        "    sys.exit(17)   # simulated preemption\n"
        "print('worker', pid, 'done')\n"
    )
    log_dir = str(tmp_path / "logs")
    codes = tl.launch_local([sys.executable, "-c", script], 2, log_dir,
                            coordinator_port=free_port(), timeout=60.0,
                            max_gang_restarts=1)
    assert codes == [0, 0]
    assert flag.exists()
    log1 = open(os.path.join(log_dir, "worker.1.log")).read()
    assert "status 17" in log1          # first attempt recorded failed
    assert "gang restart 1" in log1     # relaunch recorded
    assert "# Accounting: time=" in log1
    assert log1.rstrip().endswith("status 0")

    # without restarts the same failure surfaces
    flag2 = tmp_path / "no_restart_flag"
    codes2 = tl.launch_local(
        [sys.executable, "-c", script.replace(str(flag), str(flag2))], 2,
        str(tmp_path / "logs2"), coordinator_port=free_port(), timeout=60.0)
    assert 17 in codes2


def test_hung_rank_is_killed_at_the_time_limit(tmp_path):
    """A rank that never ends is killed at the gang's time limit (-9) and
    its log says so; the launcher returns."""
    codes = tl.launch_local(
        [sys.executable, "-c", "import time; time.sleep(60)"], 2,
        str(tmp_path / "logs"), coordinator_port=free_port(), timeout=1.0)
    assert codes == [-9, -9]
    log0 = (tmp_path / "logs" / "worker.0.log").read_text()
    assert log0.rstrip().endswith("status -9")


REDUCE = r'''
from kaldi_tpu_torch.parallel.launch import global_mesh, host_shard
assert WORLD == 2 and dist.get_world_size() == 2
mesh = global_mesh(data=2, model=1, device="cpu")
utts = [f"utt{i:02d}" for i in range(8)]
mine = host_shard(utts)
local = torch.tensor(sum(float(u[3:]) for u in mine))
dist.all_reduce(local, group=mesh.get_group("data"))
save({"rank": RANK, "shard": mine, "global": float(local),
      "coordinate": mesh.get_local_rank("data")})
'''


def test_two_process_global_reduction(tmp_path):
    """test_multihost_launch.py's reduction through the port's env
    contract: each rank sums its host shard, the all-reduce gives every
    rank the global sum; the shards are JAX's."""
    out = run_gang(tmp_path, "reduce", REDUCE, 2)
    utts = [f"utt{i:02d}" for i in range(8)]
    for r, o in enumerate(out):
        assert o["rank"] == o["coordinate"] == r
        assert o["global"] == 28.0
        assert o["shard"] == j_host_shard(utts, r, 2)


def test_module_main_runs_a_gang(tmp_path):
    """`python -m kaldi_tpu_torch.parallel.launch N -- worker.py` runs N
    ranks with the env contract and exits with their worst code."""
    worker = tmp_path / "w.py"
    worker.write_text("import os, sys\n"
                      "sys.exit(3 if os.environ['KALDI_TPU_PROCESS_ID'] == '1' "
                      "else 0)\n")
    r = subprocess.run([sys.executable, "-m", "kaldi_tpu_torch.parallel.launch",
                        "2", "--", str(worker)], cwd=tmp_path, timeout=60,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 3
    assert (tmp_path / "launch_logs" / "worker.1.log").exists()
