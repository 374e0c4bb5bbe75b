"""Stage-resumable experiment driver + config snapshots.

(ref: SURVEY.md §5 'failure detection / resume': every steps/*.sh script
 takes --stage N and pipelines resume manually; recipes snapshot configs
 into the experiment dir (steps/online/nnet2/prepare_online_decoding.sh).
 Here: named idempotent stages with .done sentinels — re-running a recipe
 skips completed stages; the config dict is serialized next to them.)

The port's copy of kaldi_tpu/utils/experiment.py (host code), carried
verbatim so the port imports nothing of kaldi_tpu; tests/test_torch_*.py
hold the two equal.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

log = logging.getLogger("kaldi_tpu_torch.experiment")


class Experiment:
    def __init__(self, exp_dir: str, config: dict | None = None,
                 from_stage: str | None = None):
        self.dir = exp_dir
        os.makedirs(exp_dir, exist_ok=True)
        self._from_stage = from_stage
        self._seen_from = False
        if config is not None:
            snap = os.path.join(exp_dir, "config.json")
            with open(snap, "w") as f:
                json.dump(self._jsonable(config), f, indent=2, default=str)

    @staticmethod
    def _jsonable(cfg):
        if dataclasses.is_dataclass(cfg):
            return dataclasses.asdict(cfg)
        return cfg

    def _sentinel(self, name: str) -> str:
        return os.path.join(self.dir, f".done.{name}")

    def stage(self, name: str, fn, *args, **kwargs):
        """Run `fn` unless the stage already completed. Results are NOT
        cached — stages communicate through files in exp_dir, like the
        reference's steps (alignments/models written per stage)."""
        if self._from_stage is not None and name == self._from_stage:
            self._seen_from = True
        skip = os.path.exists(self._sentinel(name)) and not (
            self._from_stage is not None and self._seen_from)
        if skip:
            log.info("stage %s: already done, skipping", name)
            return None
        t0 = time.time()
        log.info("stage %s: running", name)
        out = fn(*args, **kwargs)
        with open(self._sentinel(name), "w") as f:
            f.write(f"{time.time() - t0:.2f}s\n")
        return out

    def reset(self, name: str | None = None):
        if name is not None:
            try:
                os.remove(self._sentinel(name))
            except FileNotFoundError:
                pass
            return
        for fn in os.listdir(self.dir):
            if fn.startswith(".done."):
                os.remove(os.path.join(self.dir, fn))
