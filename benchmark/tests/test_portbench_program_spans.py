"""The readers of the program's spans (`metrics/program_spans.py` and the
metrics that use it) on synthetic runs: the window filter, None where the
ring dropped spans that may have lain in the window or where the program
has no recorder, and each reader's arithmetic."""

import math

import pytest

import harness
from kaldi_tpu_torch.utils import profiling
from kaldi_tpu_torch.utils.profiling import SpanRecord
from program_spans import program_spans

W0, W1 = 100.0, 110.0          # the window's bounds


def rec(name, start, end, **counts):
    return SpanRecord(name, start, end, 0, None, 0, counts)


def use(monkeypatch, spans, dropped=0):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "dropped", lambda: dropped)


def run_of(trace=None, **counters):
    return {"counters": dict(window_start=W0, window_end=W1, **counters),
            "trace": trace}


def read(name, run):
    return harness.metric_reader(name).read(run)


def test_window_filter_keeps_whole_spans_inside(monkeypatch):
    use(monkeypatch, [rec("a", 99.0, 100.5), rec("a", 100.0, 101.0),
                      rec("b", 102.0, 103.0), rec("a", 109.0, 110.0),
                      rec("a", 109.5, 110.5), rec("a", 111.0, 112.0)])
    got = program_spans(run_of(), "a")
    assert [(s.start, s.end) for s in got] == [(100.0, 101.0),
                                              (109.0, 110.0)]
    after = program_spans(run_of(), "a", lo=W1, hi=math.inf)
    assert [s.start for s in after] == [111.0]
    before = program_spans(run_of(), "a", lo=-math.inf, hi=W0)
    assert before == []


def test_none_where_the_ring_dropped_spans_of_the_interval(monkeypatch):
    kept = [rec("a", 99.0, 99.5), rec("a", 101.0, 102.0)]
    use(monkeypatch, kept, dropped=3)
    # the dropped spans ended by 99.5, before the window: it is whole
    assert len(program_spans(run_of(), "a")) == 1
    # but not for an interval that starts earlier
    assert program_spans(run_of(), "a", lo=-math.inf, hi=W0) is None
    use(monkeypatch, kept[1:], dropped=3)
    assert program_spans(run_of(), "a") is None
    for name in ("search_enqueue_ms_per_frame.decode",
                 "vad_ms_per_audio_min.sre", "step_enqueue_ms.train"):
        assert read(name, run_of(audio_s=60.0, steps=1)) is None


NAMES = ["search_enqueue_ms_per_frame.decode",
         "search_drain_ms_per_frame.decode",
         "search_device_ops_per_frame.decode", "tier_build_s.decode",
         "vad_ms_per_audio_min.sre", "upload_ms_per_audio_min.sre",
         "upload_mb_per_audio_min.sre", "step_enqueue_ms.train",
         "update_enqueue_ms.train"]


@pytest.mark.parametrize("name", NAMES)
def test_readers_give_none_without_a_recorder(monkeypatch, name):
    """A version of the program without the recorder has no `spans` /
    `dropped`: every reader returns None."""
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "dropped")
    run = run_of(trace={"kernels": [("k", 1e-6)] * 10}, audio_s=60.0,
                 steps=4)
    assert read(name, run) is None


@pytest.mark.parametrize("name", NAMES)
def test_readers_give_none_without_their_spans(monkeypatch, name):
    use(monkeypatch, [rec("other", 101.0, 102.0)])
    run = run_of(trace={"kernels": [("k", 1e-6)] * 10}, audio_s=60.0,
                 steps=4)
    assert read(name, run) is None


def test_search_readers(monkeypatch):
    use(monkeypatch, [
        rec("csr_beam.build_tier_tables", 10.0, 13.5, states=5, arcs=9),
        rec("csr_beam.frame_loop", 50.0, 51.0, batch=32, frames=10),
        rec("batching.decode_batched", 100.0, 109.0, utts=64, batches=2),
        rec("csr_beam.frame_loop", 100.5, 102.5, batch=32, frames=200),
        rec("hostpack.fetch_host", 102.6, 102.8, bytes=1000),
        rec("csr_beam.frame_loop", 103.0, 108.0, batch=32, frames=600),
        rec("hostpack.fetch_host", 108.0, 108.2, bytes=1000),
        rec("csr_beam.frame_loop", 111.0, 115.0, batch=32, frames=400)])
    trace = {"kernels": [("k", 1e-6)] * 120000}
    run = run_of(trace=trace)
    assert read("search_enqueue_ms_per_frame.decode", run) == \
        pytest.approx(1e3 * 7.0 / 800)
    assert read("search_drain_ms_per_frame.decode", run) == \
        pytest.approx(1e3 * 0.4 / 800)
    # the segment's frame loop started after the window's end
    assert read("search_device_ops_per_frame.decode", run) == \
        pytest.approx(120000 / 400)
    assert read("search_device_ops_per_frame.decode", run_of()) is None
    assert read("tier_build_s.decode", run) == pytest.approx(3.5)


def test_speaker_readers(monkeypatch):
    use(monkeypatch, [
        rec("sre.vad", 99.0, 99.9, frames_in=10, frames_kept=5),
        rec("sre.vad", 101.0, 101.25, frames_in=100, frames_kept=60),
        rec("ivector.upload", 101.3, 101.8, bytes=2_000_000),
        rec("ivector.upload", 101.9, 102.0, bytes=1_000_000),
        rec("sre.vad", 105.0, 105.25, frames_in=100, frames_kept=60),
        rec("ivector.upload", 105.3, 105.7, bytes=3_000_000)])
    run = run_of(audio_s=120.0)          # two audio minutes
    assert read("vad_ms_per_audio_min.sre", run) == pytest.approx(250.0)
    assert read("upload_ms_per_audio_min.sre", run) == pytest.approx(500.0)
    assert read("upload_mb_per_audio_min.sre", run) == pytest.approx(3.0)
    assert read("vad_ms_per_audio_min.sre", run_of(audio_s=0.0)) is None


def test_train_readers(monkeypatch):
    use(monkeypatch, [
        rec("train.step", 98.0, 98.01),
        rec("train.step", 100.0, 100.004), rec("train.update", 100.003,
                                               100.004),
        rec("train.step", 100.01, 100.016), rec("train.update", 100.014,
                                                100.015),
        rec("train.step", 110.5, 110.6)])
    run = run_of(steps=2)
    assert read("step_enqueue_ms.train", run) == pytest.approx(5.0)
    assert read("update_enqueue_ms.train", run) == pytest.approx(1.0)
    assert read("update_enqueue_ms.train", run) <= \
        read("step_enqueue_ms.train", run)


def test_readers_read_the_process_recorder():
    """Without a stand-in the readers read the program's own recorder:
    spans recorded now fall in a window around them."""
    import time
    t0 = time.perf_counter()
    for _ in range(3):
        with profiling.span("train.step"):
            with profiling.span("train.update"):
                pass
    run = {"counters": dict(window_start=t0, window_end=time.perf_counter(),
                            steps=3), "trace": None}
    step = read("step_enqueue_ms.train", run)
    update = read("update_enqueue_ms.train", run)
    assert step is not None and 0 < update <= step
