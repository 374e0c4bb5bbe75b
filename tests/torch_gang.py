"""Run a worker script as a gang of gloo ranks for the port's parallel tests.

`run_gang` writes the script after a prelude that brings up the rank
(kaldi_tpu_torch.parallel.launch.init_distributed on the CPU, one thread;
the repo and tests/ on sys.path),
launches it through the port's `launch_local` on a free localhost port
with a time limit, and returns each rank's result: the object the script
passed to `save`. The worker imports the port only (no jax).
"""

import os
import pickle
import sys

from kaldi_tpu_torch.parallel.launch import free_port, launch_local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r'''
import os, pickle, sys
sys.path[:0] = [{root!r}, os.path.join({root!r}, "tests")]
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from kaldi_tpu_torch.parallel.launch import init_distributed
RANK, WORLD = init_distributed(device="cpu")
OUT = {out!r}
ARGS = pickle.load(open(os.path.join(OUT, "args.pkl"), "rb"))


def save(obj):
    with open(os.path.join(OUT, f"rank.{{RANK}}.pkl"), "wb") as f:
        pickle.dump(obj, f)
'''

EPILOGUE = r'''
dist.barrier()
dist.destroy_process_group()
'''


def run_gang(tmp_path, name: str, script: str, n: int, args=None,
             timeout: float = 120.0) -> list:
    """Run `script` as n ranks (ARGS = `args` in the worker). -> the
    objects the ranks saved, in rank order; fails with the logs if a rank
    fails."""
    out = tmp_path / name
    out.mkdir()
    with open(out / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    worker = out / "worker.py"
    worker.write_text(PRELUDE.format(root=ROOT, out=str(out)) + script
                      + EPILOGUE)
    codes = launch_local([sys.executable, str(worker)], n,
                         log_dir=str(out / "logs"),
                         coordinator_port=free_port(),
                         env={"OMP_NUM_THREADS": "1"}, timeout=timeout)
    logs = [(out / "logs" / f"worker.{i}.log").read_text() for i in range(n)]
    assert codes == [0] * n, "\n".join(logs)
    results = []
    for i in range(n):
        with open(out / f"rank.{i}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results
