"""Local job scheduler: the run.pl / queue.pl contract.

(ref: egs/wsj/s5/utils/run.pl — `run.pl JOB=1:N log.JOB.log command...`
 spawns N local processes, writes per-job logs, exit status = any-failed;
 utils/queue.pl:15-58 shares the same JOB=1:N contract over SGE. Here the
 same contract drives Python callables or shell commands with a
 max-jobs-run throttle; cluster backends plug in by replacing the
 executor, exactly as queue.pl is a drop-in for run.pl.)

The port's copy of kaldi_tpu/utils/jobs.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests/test_torch_*.py hold the two
equal.
"""

from __future__ import annotations

import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor


class JobFailure(RuntimeError):
    pass


def run_jobs(n_jobs: int, task, log_dir: str | None = None,
             name: str = "job", max_jobs_run: int | None = None,
             max_retries: int = 0, retry_backoff_s: float = 0.0):
    """Run task(job) for job in 1..n_jobs, in parallel.

    task: callable(job_number) -> result, or a shell-command string
    containing the literal JOB placeholder. Per-job logs are written to
    `{log_dir}/{name}.{job}.log` like the reference. Raises JobFailure if
    any job fails (after all complete — same semantics as run.pl which
    waits for every job before reporting).
    Returns the list of results (None for shell tasks).

    max_retries: failed jobs are re-run up to this many extra times
    (transient-failure / preemption recovery — the role SGE requeueing
    plays behind queue.pl; the retry count is recorded in the job log).
    """
    max_workers = min(n_jobs, max_jobs_run or n_jobs)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)

    def one(job: int):
        log_path = (os.path.join(log_dir, f"{name}.{job}.log")
                    if log_dir else None)
        t0 = time.time()
        try:
            if callable(task):
                result = task(job)
                if log_path:
                    with open(log_path, "w") as f:
                        f.write(f"# job {job} ok in "
                                f"{time.time() - t0:.2f}s\n")
                return (True, result)
            cmd = task.replace("JOB", str(job))
            with open(log_path, "w") if log_path else open(os.devnull,
                                                           "w") as f:
                f.write(f"# {cmd}\n")
                f.flush()
                rc = subprocess.run(cmd, shell=True, stdout=f,
                                    stderr=subprocess.STDOUT).returncode
                # accounting line like run.pl: a failed job's log must be
                # distinguishable even when the command wrote no output
                f.write(f"# job {job} "
                        + ("ok" if rc == 0 else f"FAILED rc={rc}")
                        + f" in {time.time() - t0:.2f}s\n")
            return (rc == 0, None)
        except Exception as e:  # noqa: BLE001 — job isolation
            if log_path:
                with open(log_path, "a") as f:
                    f.write(f"# job {job} FAILED: {e}\n")
            return (False, e)

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        outcomes = list(ex.map(one, range(1, n_jobs + 1)))
    for attempt in range(1, max_retries + 1):
        failed_jobs = [j + 1 for j, (ok, _r) in enumerate(outcomes)
                       if not ok]
        if not failed_jobs:
            break
        if retry_backoff_s:
            time.sleep(retry_backoff_s * attempt)
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            redone = list(ex.map(one, failed_jobs))
        for j, out in zip(failed_jobs, redone):
            outcomes[j - 1] = out
            if log_dir and out[0]:
                with open(os.path.join(log_dir, f"{name}.{j}.log"),
                          "a") as f:
                    f.write(f"# job {j} recovered on retry {attempt}\n")
    failed = [j + 1 for j, (ok, _r) in enumerate(outcomes) if not ok]
    if failed:
        raise JobFailure(
            f"{len(failed)}/{n_jobs} jobs failed (jobs {failed}) after "
            f"{max_retries} retries; "
            + (f"see {log_dir}/{name}.*.log" if log_dir else "no logs"))
    return [r for (_ok, r) in outcomes]
