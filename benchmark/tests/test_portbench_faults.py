"""The check catches a broken timed path: each runner's run, without the
look for a card, at a tiny size on the CPU, once sound and once with a
fault planted under the timed path; `correct` (every number within its
limit) comes out false for each fault the cell can have. The limits here
are ten times the sound run's readings (the cells' own limits, in their
traffic files, belong to their full sizes). And the control: the
reference one precision below the configuration's reads above the sound
run at the tiny size too."""

import math

import pytest
import torch

import harness
import tiny

OFF = harness.load_module(tiny.BENCH + "/runners/offline_decode.py", "f_od")
SRE = harness.load_module(tiny.BENCH + "/runners/sre_extract.py", "f_se")
TRN = harness.load_module(tiny.BENCH + "/runners/train_step.py", "f_ts")


def run(runner, cfg, mix, fault=None, seed=7):
    ctx = tiny.Ctx(cfg, mix, seed=seed, seconds=0.0)
    st = runner.setup(ctx)
    if fault:
        fault(st)
    out = runner.run_window(st, ctx)
    checks = runner.check(st, ctx)
    nums = {c["name"]: c["value"] for c in checks}
    return out, dict(nums, unanswered=out["failed"])


def own(lim):
    return {k: v for k, v in lim.items() if k != "unanswered"}


def correct(nums, limits):
    return all(math.isfinite(v) and v <= limits[n] for n, v in nums.items())


def limits_from(nums):
    return {n: 0 if n == "unanswered" else max(10 * v, 1e-9)
            for n, v in nums.items()}


@pytest.fixture(scope="module")
def offline_sound():
    cfg, mix = tiny.tiny_asr_config(), tiny.tiny_offline_mix()
    _out, nums = run(OFF, cfg, mix)
    return cfg, mix, limits_from(nums)


def wrap_decode(change):
    def fault(st):
        dec = st["decoder"]
        real = dec.decode

        def decode(ll, nf):
            return change(real(ll, nf))
        dec.decode = decode
    return fault


def alter_word(res):
    return [None if r is None else ([r[0][0] % 300 + 1] + r[0][1:], r[1],
                                    r[2]) for r in res]


def drop_half(res):
    real = sum(r is not None for r in res)
    return [None if b < (real + 1) // 2 else r for b, r in enumerate(res)]


@pytest.mark.parametrize("fault", [alter_word, drop_half])
def test_offline_fault_fails(offline_sound, fault):
    cfg, mix, lim = offline_sound
    mix = dict(mix, limits=own(lim))
    _out, sound = run(OFF, cfg, mix)
    assert correct(sound, lim)
    _out, nums = run(OFF, cfg, mix, wrap_decode(fault))
    assert not correct(nums, lim)


def test_offline_narrow_search_fails_on_path_gap(offline_sound):
    """A search that prunes the best path away still returns a valid path,
    so only the gap to the reference search's best can catch it."""
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu_torch.decoder.graph_pack import PackedGraph
    cfg, mix, lim = offline_sound
    mix = dict(mix, limits=own(lim))

    def narrow(st):
        st["decoder"] = CsrBeamDecoder(
            PackedGraph(**st["graph"]),
            CsrBeamOpts(**dict(cfg["search"], beam=2.0, max_active=2)),
            device="cpu")
    _out, nums = run(OFF, cfg, mix, narrow)
    assert math.isfinite(nums["cost_err"]) and nums["cost_err"] <= lim[
        "cost_err"], nums
    assert nums["path_gap"] > lim["path_gap"], (nums, lim)


@pytest.fixture(scope="module")
def sre_sound():
    cfg, mix = tiny.tiny_sre_config(), tiny.tiny_sre_mix()
    _out, nums = run(SRE, cfg, mix)
    return cfg, mix, limits_from(nums)


def sre_alter_ivector(st):
    ext = st["system"].extractor
    real = ext.extract_batch

    def extract(stats, device):
        out = real(stats, device)
        out[:, 1] += 1.0
        return out
    ext.extract_batch = extract


def sre_drop_half(st):
    sysm = st["system"]
    real = sysm.stats

    def stats(feats):
        g, X = real(feats)
        g[len(g) // 2:] = 0
        X[len(X) // 2:] = 0
        return g, X
    sysm.stats = stats


@pytest.mark.parametrize("fault", [sre_alter_ivector, sre_drop_half])
def test_sre_fault_fails(sre_sound, fault):
    cfg, mix, lim = sre_sound
    # every side checked, so a fault on any half of the batch shows
    mix = dict(mix, check_utts=mix["sides"], limits=own(lim))
    _out, sound = run(SRE, cfg, mix)
    assert correct(sound, lim)
    _out, nums = run(SRE, cfg, mix, fault)
    assert not correct(nums, lim)


@pytest.fixture(scope="module")
def train_sound():
    cfg, mix = tiny.tiny_asr_config(), tiny.tiny_train_mix()
    _out, nums = run(TRN, cfg, mix)
    return cfg, mix, limits_from(nums)


def frozen_step(real):
    def step(params, opt_state, feats, tgt, w):
        _p, s, loss, acc = real(params, opt_state, feats, tgt, w)
        return params, s, loss, acc
    return step


def half_batch_step(real):
    def step(params, opt_state, feats, tgt, w):
        h = len(feats) // 2
        return real(params, opt_state, feats[:h], tgt[:h], w[:h])
    return step


def altered_update_step(real):
    def step(params, opt_state, feats, tgt, w):
        p, s, loss, acc = real(params, opt_state, feats, tgt, w)
        p = dict(p)
        p["final.b"] = p["final.b"] + 0.01
        return p, s, loss, acc
    return step


@pytest.mark.parametrize("make", [frozen_step, half_batch_step,
                                  altered_update_step])
def test_train_fault_fails(train_sound, monkeypatch, make):
    cfg, mix, lim = train_sound
    mix = dict(mix, limits=own(lim))
    import kaldi_tpu_torch.nnet.train as tr
    real_make = tr.make_train_step

    def broken(*a, **k):
        return make(real_make(*a, **k))
    monkeypatch.setattr(tr, "make_train_step", broken)
    _out, nums = run(TRN, cfg, mix)
    assert not correct(nums, lim)
    monkeypatch.setattr(tr, "make_train_step", real_make)
    _out, sound = run(TRN, cfg, mix)
    assert correct(sound, lim)


@pytest.mark.parametrize("runner,cfg,mix", [
    (OFF, tiny.tiny_asr_config, tiny.tiny_offline_mix),
    (SRE, tiny.tiny_sre_config, tiny.tiny_sre_mix),
    (TRN, tiny.tiny_asr_config, tiny.tiny_train_mix)])
def test_control_reads_above_the_program(runner, cfg, mix):
    """The control reads three times the sound run or more on one of the
    cell's numbers, at the tiny size (TF32 does not exist on the CPU, so
    the features' control reads as the program there)."""
    c, m = cfg(), mix()
    _out, sound = run(runner, c, m)
    ctl = runner.control_numbers(tiny.Ctx(c, m, seed=7), {})
    assert any(ctl[n] >= 3 * sound[n] and ctl[n] > 0
               for n in set(ctl) & set(sound)), (sound, ctl)
