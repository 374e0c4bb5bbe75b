"""Each traffic generator gives the same inputs for the same seed, the
same sizes for every seed, and other content for another seed."""

import numpy as np
import torch

import harness
import tiny
from inputs.corpus import lognormal_frames
from inputs.speech import SpeakerPool, ladder_synth, synth_side

OFF = harness.load_module(tiny.BENCH + "/runners/offline_decode.py", "t_od")
SRE = harness.load_module(tiny.BENCH + "/runners/sre_extract.py", "t_se")
TRN = harness.load_module(tiny.BENCH + "/runners/train_step.py", "t_ts")


def test_lognormal_lengths_are_the_traffics():
    f = lognormal_frames(64, 6.0, 0.645, 2.0, 20.0)
    assert f.min() == 200 and f.max() == 2000 and np.median(f) == 600
    assert np.array_equal(f, lognormal_frames(64, 6.0, 0.645, 2.0, 20.0))


def test_offline_pool_is_seeded():
    cfg, mix = tiny.tiny_asr_config(), tiny.tiny_offline_mix()
    shared = {}
    big = 2 ** 31 + 12345
    a = OFF.make_inputs(tiny.Ctx(cfg, mix, seed=big), shared)
    b = OFF.make_inputs(tiny.Ctx(cfg, mix, seed=big), shared)
    c = OFF.make_inputs(tiny.Ctx(cfg, mix, seed=big + 1), shared)
    assert a["sample"] == b["sample"]
    for k in a["keys"]:
        assert torch.equal(a["waves_dev"][k], b["waves_dev"][k])
    assert sorted(a["frames"].values()) == sorted(c["frames"].values())
    # the same utterances in another order: the same work for every seed
    assert a["keys"] == c["keys"]
    assert any(not torch.equal(a["waves_dev"][k], c["waves_dev"][k])
               for k in a["keys"])
    assert sorted(float(w.sum()) for w in a["waves_dev"].values()) == \
        sorted(float(w.sum()) for w in c["waves_dev"].values())
    longest = max(a["frames"], key=a["frames"].get)
    assert longest in a["sample"]


def test_sre_pool_is_seeded():
    cfg, mix = tiny.tiny_sre_config(), tiny.tiny_sre_mix()
    shared = {}
    big = 2 ** 31 + 777
    a = SRE.make_inputs(tiny.Ctx(cfg, mix, seed=big), shared)
    b = SRE.make_inputs(tiny.Ctx(cfg, mix, seed=big), shared)
    c = SRE.make_inputs(tiny.Ctx(cfg, mix, seed=big + 1), shared)
    assert a["sample"] == b["sample"]
    assert all(torch.equal(x, y) for x, y in zip(a["waves"], b["waves"]))
    assert not all(torch.equal(x, y) for x, y in zip(a["waves"], c["waves"]))
    assert sorted(float(w.sum()) for w in a["waves"]) == \
        sorted(float(w.sum()) for w in c["waves"])
    assert a["audio_s"] == c["audio_s"]


def test_train_batches_are_seeded_and_distinct():
    cfg, mix = tiny.tiny_asr_config(), tiny.tiny_train_mix()
    shared = {}
    a = TRN.make_inputs(tiny.Ctx(cfg, mix, seed=5), shared)
    b = TRN.make_inputs(tiny.Ctx(cfg, mix, seed=5), shared)
    assert torch.equal(a["feats"], b["feats"])
    assert torch.equal(a["order"], b["order"])
    first = a["order"][: mix["check_steps"]].reshape(-1)
    assert len(set(first.tolist())) == len(first)


def test_synth_side_is_ladder_synth():
    pool = SpeakerPool(23, 2)
    ph = [1, 5, 7, 3, 2, 29, 0, 4]
    a = ladder_synth(ph, pool.freqs, np.random.RandomState(5), 1.03, 0.0,
                     0.6, 0.2)
    b = synth_side(ph, pool.freqs, np.random.RandomState(5), 1.03, 0.0,
                   0.6, 0.2).numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()
