"""Tiny versions of the benchmark's configurations and traffic for the
CPU tests, and a stand-in for run.py's context."""

from __future__ import annotations

import copy
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def tiny_asr_config() -> dict:
    cfg = copy.deepcopy(load("configs", "tdnn1024_hclg60k"))
    cfg["graph"].update(vocab=300, avg_bigram_succ=20, num_pdfs=64, seed=1)
    cfg["tdnn"].update(hidden_dim=64, num_pdfs=64)
    cfg["train"].update(utts=4, frames=200, steps=30)
    cfg["search"].update(max_active=512, expand_budget=4096)
    return cfg


def tiny_offline_mix() -> dict:
    mix = load("traffic", "offline_lognormal_b32")
    mix.update(pool_utts=6, median_s=1.0, min_s=0.5, max_s=2.0, batch_size=4,
               warmup_frames=10, check_utts=2)
    return mix


class Ctx:
    """run.py's Context on the CPU: no trace."""

    def __init__(self, config, mix, seed=7, seconds=0.0, device="cpu"):
        import harness
        self.config, self.mix = config, mix
        self.seed, self.seconds, self.trace = seed, seconds, False
        self.spans = harness.Spans(False)
        self.dtrace = harness.DeviceTrace(False, "")
        self.device = device


def tiny_sre_config() -> dict:
    cfg = copy.deepcopy(load("configs", "sre10v1_ubm2048_iv600"))
    cfg["calibration"].update(speakers=2, seconds=3.0)
    cfg["ubm"].update(num_gauss=16)
    cfg["extractor"].update(ivector_dim=8)
    return cfg


def tiny_sre_mix() -> dict:
    mix = load("traffic", "sre_conv_b64")
    mix.update(sides=4, speakers=2, min_s=2.0, max_s=4.0, check_utts=2)
    return mix


def tiny_train_mix() -> dict:
    mix = load("traffic", "train_b16")
    mix.update(pool_utts=8, frames=120, batch_utts=2, log_every=5,
               trace_steps=2, max_steps=2000)
    return mix
