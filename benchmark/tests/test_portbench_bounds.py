"""The bound and FLOP arithmetic against hand-worked shapes, and the
trace reduction on a hand-made trace."""

import pytest

import harness
from inputs.bounds import (gather_bound_ms, qaffine_bound_ms,
                           tdnn_gemm_weights, train_flops_per_step)


def test_gather_bound():
    # [8, 2048] table, [8, 30384] indices: 8*8*30384 + 4*8*2048 bytes
    assert gather_bound_ms(8, 2048, 30384) == pytest.approx(
        (1944576 + 65536) / 3.35e12 * 1e3)


def test_qaffine_bound():
    ms, kind = qaffine_bound_ms(8192, 8192, 8192)
    assert kind == "operations"
    assert ms == pytest.approx(2 * 8192 ** 3 / 989e12 * 1e3)
    ms, kind = qaffine_bound_ms(1, 1024, 1024)
    assert kind == "bytes"
    assert ms == pytest.approx((4 * 1024 + 1024 * 1024 + 8 * 1024 + 4 * 1024)
                               / 3.35e12 * 1e3)


def test_tdnn_weights_and_train_flops():
    splice = ((-2, -1, 0, 1, 2), (-1, 2), (-3, 3), (-7, 2), (0,))
    w = tdnn_gemm_weights(40, 1024, 2048, splice)
    assert w == 200 * 1024 + 3 * 2048 * 1024 + 1024 * 1024 + 1024 * 2048
    assert w == 9641984
    assert train_flops_per_step(w, 15616) == 6.0 * 9641984 * 15616


def test_mfu_readers():
    run = dict(window_s=2.0, counters=dict(frames=15616 * 100,
                                           gemm_weights=9641984,
                                           real_frames=1000))
    mfu = harness.metric_reader("train_mfu").read(run)
    assert mfu == pytest.approx(100 * 6 * 9641984 * 1561600 / 2.0 / 989e12)
    dec = harness.metric_reader("decode_mfu").read(run)
    assert dec == pytest.approx(100 * 2 * 9641984 * 1000 / 2.0 / 989e12)
    sre = harness.metric_reader("sre_mfu").read(dict(
        window_s=1.0, counters=dict(voiced_frames=10.0, utts=1, num_gauss=2,
                                    feat_dim=3, ivector_dim=4)))
    f32 = 2 * 10 * 7 * 2
    f64 = 2 * 10 * 2 * 3 + (2 * 2 * 16 + 2 * 2 * 3 * 4 + 64 / 3 + 2 * 16)
    assert sre == pytest.approx(100 * (f32 + f64) / 67e12)


def test_readers_return_none_without_data():
    run = dict(window_s=1.0, counters={}, trace=None)
    for name in ("idle_pct.decode", "table_gather_roofline.decode",
                 "padding_pct.decode", "train_mfu", "sre_mfu"):
        assert harness.metric_reader(name).read(run) is None


def test_reduce_trace():
    ev = [dict(name="bench.window", cat="user_annotation", ts=0, dur=100),
          dict(name="bench.search", cat="user_annotation", ts=10, dur=60),
          dict(name="k1", cat="kernel", ts=20, dur=10),
          dict(name="k2", cat="kernel", ts=25, dur=10),
          dict(name="table_gather_kernel<true,true>", cat="kernel", ts=50,
               dur=5),
          dict(name="k1", cat="kernel", ts=95, dur=10)]
    s = harness.reduce_trace(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((15 + 5 + 5) * 1e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(15e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["search"] == pytest.approx((10 + 15 + 15) * 1e-6)
    assert gaps["outside any span"] == pytest.approx((10 + 25) * 1e-6)
    run = dict(trace=s, counters=dict(gather_shapes=[(8, 2048, 30384)]),
               window_s=1.0)
    roof = harness.metric_reader("table_gather_roofline.decode").read(run)
    assert roof == pytest.approx(100 * gather_bound_ms(8, 2048, 30384)
                                 / 1e3 / 5e-6)
    idle = harness.metric_reader("idle_pct.train").read(run)
    assert idle == pytest.approx(75.0)
