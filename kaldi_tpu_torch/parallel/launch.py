"""Multi-process launch: the queue.pl / multi-host role over torch.distributed.

Counterpart of kaldi_tpu/parallel/launch.py (ref: egs/wsj/s5/utils/queue.pl:15-58
and run.pl). The JAX package runs one controller per host over a global
device mesh; here one process drives one device, PyTorch's own idiom and
what NCCL requires on a multi-GPU host. Every process runs the SAME script
(SPMD): each holds its shard of the batch and the collectives of
`torch.distributed` reduce between them.

Three pieces, with the JAX package's env contract (KALDI_TPU_COORDINATOR /
_NUM_PROCESSES / _PROCESS_ID):
  - init_distributed(): the per-process entry. It brings up the default
    process group at tcp://<coordinator>: NCCL for CUDA, gloo for the CPU,
    or the backend the caller names (gloo with CUDA tensors lets two ranks
    share one card, which NCCL refuses).
  - host_shard(): deterministic utterance sharding per process (the role
    of split_scp.pl), sorted round-robin.
  - launch_local(): spawns N local processes of a worker with the env
    contract set, waits, gang-restarts on a failure and writes run.pl-style
    accounting logs (the JAX package's launcher, which is subprocess code,
    with one time limit for the gang and every process killed on exit).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

COORD_ENV = "KALDI_TPU_COORDINATOR"
NPROC_ENV = "KALDI_TPU_NUM_PROCESSES"
PID_ENV = "KALDI_TPU_PROCESS_ID"


def free_port() -> int:
    """A free TCP port on localhost (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_count: int | None = None,
                     device="cuda", backend: str | None = None):
    """Bring up the default process group from args or env.
    -> (process_id, num_processes).

    With one process it is a no-op that returns (0, 1), as JAX's is (a
    one-rank mesh makes its own group, parallel.mesh.make_mesh). On CUDA
    each rank first selects card `rank % device_count`, so ranks beyond the
    card count share cards (over gloo only: NCCL refuses two ranks on one
    card).

    local_device_count is JAX's count of virtual CPU devices per process;
    one process drives one device here, so it must be None or 1."""
    if local_device_count not in (None, 1):
        raise ValueError(
            f"local_device_count={local_device_count}: one process drives one "
            f"device in kaldi_tpu_torch (launch N processes instead of N "
            f"virtual devices per process)")
    coordinator = coordinator or os.environ.get(COORD_ENV)
    num_processes = num_processes or int(os.environ.get(NPROC_ENV, "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get(PID_ENV, "0")))
    if num_processes <= 1:
        return 0, 1
    if not coordinator:
        raise ValueError(f"multi-process launch needs {COORD_ENV} (host:port)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend=backend or default_backend(dev),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return process_id, num_processes


def global_mesh(data: int | None = None, model: int = 1, device="cuda"):
    """2-D ('data', 'model') mesh over every process of the world."""
    from kaldi_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(data=data, model=model, device=device)


def host_shard(keys, process_id: int | None = None,
               num_processes: int | None = None):
    """Deterministic per-process utterance shard (split_scp.pl's role):
    sorted round-robin, so every process gets a near-equal share and the
    union over processes is exactly the input. The defaults are this
    process's rank and the world size (0 and 1 without a process group)."""
    on = dist.is_available() and dist.is_initialized()
    pid = process_id if process_id is not None else (
        dist.get_rank() if on else 0)
    n = num_processes if num_processes is not None else (
        dist.get_world_size() if on else 1)
    return sorted(keys)[pid::n]


def launch_local(worker: list[str], num_processes: int,
                 log_dir: str, coordinator_port: int = 29411,
                 env: dict | None = None, timeout: float = 600.0,
                 max_gang_restarts: int = 0):
    """Run `worker` (argv list) as num_processes local processes with the
    distributed env contract; -> list of return codes. Writes run.pl-style
    accounting to <log_dir>/worker.<pid>.log.

    max_gang_restarts: an SPMD program is all-or-nothing (one dead rank
    hangs the others' collectives), so when ANY worker exits nonzero the
    whole gang is killed and relaunched on a fresh coordinator port (the
    workers resume from their checkpoints), up to this many times.
    `timeout` bounds each attempt as a whole."""
    os.makedirs(log_dir, exist_ok=True)
    for attempt in range(max_gang_restarts + 1):
        codes: list[int] = []
        base_env = dict(os.environ)
        # fresh port per attempt: a dead coordinator's socket may linger
        base_env[COORD_ENV] = f"localhost:{coordinator_port + attempt}"
        base_env[NPROC_ENV] = str(num_processes)
        if env:
            base_env.update(env)
        procs, logs = [], []
        t0 = time.time()
        mode = "w" if attempt == 0 else "a"
        try:
            for i in range(num_processes):
                e = dict(base_env)
                e[PID_ENV] = str(i)
                log = open(os.path.join(log_dir, f"worker.{i}.log"), mode)
                logs.append(log)
                log.write(f"# Running on {os.uname().nodename}"
                          + (f" (gang restart {attempt})" if attempt else "")
                          + f"\n# Started at {time.ctime()}\n"
                          f"# {' '.join(worker)}\n")
                log.flush()
                procs.append(subprocess.Popen(worker, env=e, stdout=log,
                                              stderr=subprocess.STDOUT))
            codes = _wait_gang(procs, t0 + timeout)
        finally:
            for p in procs:           # nothing outlives the launcher
                if p.poll() is None:
                    p.kill()
                    p.wait()
            dt = time.time() - t0
            for i, log in enumerate(logs):
                # run.pl accounting line (ref: utils/run.pl's epilogue)
                status = codes[i] if i < len(codes) else "killed"
                log.write(f"# Accounting: time={dt:.0f} threads=1\n"
                          f"# Finished at {time.ctime()} with status "
                          f"{status}\n")
                log.close()
        if all(c == 0 for c in codes) or attempt == max_gang_restarts:
            break
    return codes


def _wait_gang(procs, deadline: float) -> list[int]:
    """Wait for every process until `deadline`; the first one that exits
    nonzero (or the deadline) kills the rest. -> return codes (-9 for a
    killed process)."""
    codes: list[int | None] = [None] * len(procs)
    while any(c is None for c in codes):
        failed = False
        for i, p in enumerate(procs):
            if codes[i] is None:
                codes[i] = p.poll()
                failed |= codes[i] not in (None, 0)
        if failed or time.time() > deadline:
            # one rank down = the SPMD program cannot finish: kill the rest
            # of the gang now, don't wait out their hung collectives
            for i, p in enumerate(procs):
                if codes[i] is None:
                    p.kill()
                    p.wait()
                    codes[i] = -9
            break
        time.sleep(0.02)
    return codes


def main():
    """`python -m kaldi_tpu_torch.parallel.launch N -- worker.py args...`"""
    argv = sys.argv[1:]
    n = int(argv[0])
    if argv[1] != "--":
        raise SystemExit("usage: launch N -- worker.py args...")
    worker = [sys.executable] + argv[2:]
    codes = launch_local(worker, n, log_dir="launch_logs",
                         coordinator_port=free_port())
    sys.exit(max(codes, default=0))


if __name__ == "__main__":
    main()
