"""The port's program spans (`kaldi_tpu_torch/utils/profiling.py`): the
recorder's nesting, thread chains, ring bound, counts and totals, its
annotations on a torch.profiler timeline, and each instrumented site on a
tiny CPU case. One card test puts `csr_beam.frame_loop` around the gather
kernel's launches in a `device_trace` export. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.decoder.batching import decode_batched
from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.csr_beam import (ChunkedCsrBeamDecoder,
                                              CsrBeamDecoder, CsrBeamOpts)
from kaldi_tpu_torch.decoder.hostpack import fetch_host
from kaldi_tpu_torch.gmm.full_gmm import FullGmm
from kaldi_tpu_torch.ivector.extractor import IvectorExtractor
from kaldi_tpu_torch.ivector.vad import VadOpts, compute_vad
from kaldi_tpu_torch.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu_torch.nnet.train import (NnetTrainOpts, make_optimizer,
                                        make_train_step)
from kaldi_tpu_torch.ops import table_gather
from kaldi_tpu_torch.params import random_tdnn_params, tdnn_params_from_jax
from kaldi_tpu_torch.steps.sre import SrePipelineOpts, SreSystem
from kaldi_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)

OPTS = dict(beam=9.0, max_active=256, acoustic_scale=0.1,
            expand_budget=4096, eps_budget=1024)


@pytest.fixture(scope="module")
def graph():
    g, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                        num_pdfs=64, seed=1))
    return g


def loglikes(B=3, T=40, seed=3):
    ll = (np.random.RandomState(seed).randn(B, T, 64) * 3).astype(np.float32)
    return ll, np.array([T, T - 9, T - 23][:B], np.int32)


def newest(name, since=0):
    """The process recorder's spans called `name` that began after the
    clock read `since`, oldest first."""
    return [s for s in prof.spans() if s.name == name and s.start >= since]


def now():
    return time.perf_counter()


# -- the recorder ---------------------------------------------------------

def test_nesting_gives_parent_and_request_ids():
    rec = prof.SpanRecorder(capacity=16)
    with rec.span("outer") as a:
        with rec.span("mid") as b:
            with rec.span("inner") as c:
                pass
        with rec.span("mid2") as d:
            pass
    with rec.span("next") as e:
        pass
    by = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["inner", "mid", "mid2",
                                             "outer", "next"]
    assert by["outer"].parent is None and by["outer"].request == a.id
    assert by["mid"].parent == a.id and by["mid"].request == a.id
    assert by["inner"].parent == b.id and by["inner"].request == a.id
    assert by["mid2"].parent == a.id and by["mid2"].id == d.id
    assert by["next"].parent is None and by["next"].request == e.id
    assert len({a.id, b.id, c.id, d.id, e.id}) == 5
    assert by["outer"].start <= by["mid"].start <= by["inner"].start
    assert by["inner"].end <= by["mid"].end <= by["outer"].end


def test_threads_keep_their_own_chains():
    rec = prof.SpanRecorder(capacity=1024)
    n, rounds = 4, 50
    gate = threading.Barrier(n)
    roots = {}

    def work(i):
        gate.wait(timeout=30)
        with rec.span(f"root{i}") as r:
            roots[i] = r.id
            for _ in range(rounds):
                with rec.span(f"child{i}"):
                    with rec.span(f"leaf{i}"):
                        pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    got = rec.spans()
    assert len(got) == n * (1 + 2 * rounds) and rec.dropped() == 0
    ids = {s.id: s for s in got}
    for s in got:
        i = int(s.name[-1])
        assert s.request == roots[i]
        if s.name.startswith("child"):
            assert s.parent == roots[i]
        if s.name.startswith("leaf"):
            assert ids[s.parent].name == f"child{i}"


def test_ring_is_bounded_and_counts_what_it_drops():
    assert prof.RECORDER.capacity >= 1 << 16
    rec = prof.SpanRecorder(capacity=4)
    for i in range(3):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans()] == ["s0", "s1", "s2"]
    assert rec.dropped() == 0
    for i in range(3, 10):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans()] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped() == 6
    assert rec.profiler.counts["s0"] == 1   # totals keep dropped spans


def test_counts_and_profiler_totals():
    totals = prof.AccuProfiler()
    rec = prof.SpanRecorder(capacity=8, profiler=totals)
    for k in (2, 5):
        with rec.span("load", frames=k) as sp:
            sp.counts["bytes"] = 8 * k
    last = rec.spans()[-1]
    assert last.counts == {"frames": 5, "bytes": 40}
    assert totals.counts["load"] == 2
    assert dict(totals.sums["load"]) == {"frames": 7, "bytes": 56}
    assert totals.seconds["load"] == pytest.approx(
        sum(s.end - s.start for s in rec.spans()))
    text = totals.report()
    assert "load" in text and "frames=7" in text and "bytes=56" in text
    # the process's recorder feeds the module's PROFILER
    before = prof.PROFILER.counts["tracing.test"]
    with prof.span("tracing.test", n=1):
        pass
    assert prof.PROFILER.counts["tracing.test"] == before + 1


def test_annotation_only_while_a_profiler_records(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.span("tracing.outer"):
            with prof.span("tracing.inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    path = str(tmp_path / "trace.json")
    p.export_chrome_trace(path)
    ev = {e["name"]: e for e in json.load(open(path))["traceEvents"]
          if e.get("cat") == "user_annotation"}
    assert {"tracing.outer", "tracing.inner"} <= set(ev)
    o, i = ev["tracing.outer"], ev["tracing.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with prof.span("tracing.off"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("tracing.on"):
            pass
    assert entered == ["tracing.on"]


# -- the instrumented sites, on the CPU -----------------------------------

@pytest.mark.parametrize("kind", ["best_path", "record", "chunked"])
def test_frame_loop_span_counts_its_frames(graph, kind):
    ll, nf = loglikes()
    B, T = ll.shape[:2]
    t0 = now()
    if kind == "best_path":
        CsrBeamDecoder(graph, CsrBeamOpts(**OPTS), device="cpu").decode(ll, nf)
        want = [(B, T)]
    elif kind == "record":
        CsrBeamDecoder(graph, CsrBeamOpts(**OPTS, rec_cap=64),
                       device="cpu").decode_raw(ll, nf)
        want = [(B, T)]
    else:
        ChunkedCsrBeamDecoder(graph, CsrBeamOpts(**OPTS), chunk_frames=16,
                              device="cpu").decode(ll, nf)
        want = [(B, 16)] * 3     # T padded to whole chunks
    got = newest("csr_beam.frame_loop", t0)
    assert [(s.counts["batch"], s.counts["frames"]) for s in got] == want


def test_fetch_host_span_counts_the_buffer(graph):
    xs = [torch.arange(6, dtype=torch.int32).reshape(2, 3),
          torch.ones(5, dtype=torch.float16), torch.zeros(3, dtype=torch.bool),
          torch.ones((2, 2), dtype=torch.int64)]
    t0 = now()
    out = fetch_host(xs)
    (s,) = newest("hostpack.fetch_host", t0)
    # each part padded to a multiple of 8 bytes: 24, 10 -> 16, 3 -> 8, 32
    assert s.counts == {"bytes": 24 + 16 + 8 + 32}
    np.testing.assert_array_equal(out[0], xs[0].numpy())
    # a decode fetches its outputs once, inside its request's chain
    ll, nf = loglikes()
    dec = CsrBeamDecoder(graph, CsrBeamOpts(**OPTS), device="cpu")
    t1 = now()
    dec.decode(ll, nf)
    (s,) = newest("hostpack.fetch_host", t1)
    assert s.counts["bytes"] > 0


def test_build_tier_tables_span(graph):
    t0 = now()
    dec = CsrBeamDecoder(graph, CsrBeamOpts(**OPTS), device="cpu")
    (s,) = newest("csr_beam.build_tier_tables", t0)
    assert s.counts == {"states": dec.csr.num_states,
                        "arcs": len(dec.csr.e_nxt) + len(dec.csr.z_nxt)}
    assert s.end > s.start


def test_decode_batched_is_the_request_of_its_spans(graph):
    dec = CsrBeamDecoder(graph, CsrBeamOpts(**OPTS), device="cpu")
    rng = np.random.RandomState(5)
    utts = [(f"u{i}", (rng.randn(n, 64) * 3).astype(np.float32))
            for i, n in enumerate([30, 70, 75, 160])]
    t0 = now()
    decode_batched(dec, utts, lambda x: x, batch_size=2, device="cpu")
    (root,) = newest("batching.decode_batched", t0)
    loops = newest("csr_beam.frame_loop", t0)
    fetches = newest("hostpack.fetch_host", t0)
    assert root.parent is None and root.request == root.id
    assert root.counts == {"utts": 4, "batches": len(loops)}
    assert len(loops) == len(fetches) >= 2
    for s in loops + fetches:
        assert s.request == root.id and s.parent == root.id
        assert root.start <= s.start and s.end <= root.end


def tiny_sre(post_fn=None):
    rng = np.random.RandomState(0)
    I, D, K = 4, 3, 2
    means = rng.randn(I, D)
    covars = np.stack([np.eye(D) * (1.0 + 0.1 * i) for i in range(I)])
    ubm = FullGmm(np.full(I, 1.0 / I), means, covars)
    ext = IvectorExtractor.from_arrays(
        means, np.linalg.inv(covars), ubm.weights, rng.randn(I, D, K) * 0.1,
        100.0)
    opts = SrePipelineOpts(num_gauss=I, ivector_dim=K, num_gselect=2,
                           use_vad=True, vad=VadOpts())
    return SreSystem(ubm=ubm, extractor=ext, plda=None, opts=opts,
                     post_fn=post_fn, device="cpu")


def tiny_feats(n=3, seed=1):
    rng = np.random.RandomState(seed)
    return [np.c_[rng.randn(T) * 4 + 8, rng.randn(T, 2)].astype(np.float32)
            for T in (50, 37, 64)[:n]]


def test_sre_vad_span_counts_kept_frames():
    system, feats = tiny_sre(), tiny_feats()
    t0 = now()
    system.stats(feats)
    (s,) = newest("sre.vad", t0)
    kept = sum(int(compute_vad(f, system.opts.vad).sum()) for f in feats)
    assert 0 < kept < sum(map(len, feats))
    assert s.counts == {"frames_in": sum(map(len, feats)),
                        "frames_kept": kept}


@pytest.mark.parametrize("with_posts", [False, True])
def test_ivector_upload_span_counts_its_bytes(with_posts):
    I = 4
    post_fn = (lambda f: np.full((len(f), I), 1.0 / I)) if with_posts \
        else None
    system, feats = tiny_sre(post_fn), tiny_feats()
    t0 = now()
    system.stats(feats)
    (vad,) = newest("sre.vad", t0)
    ups = newest("ivector.upload", t0)
    frames, dim = vad.counts["frames_kept"], feats[0].shape[1]
    want = 8 * frames * dim + (8 * frames * I if with_posts else 0)
    assert len(ups) == 1 and ups[0].counts == {"bytes": want}


def test_train_step_span_holds_the_update_span():
    cfg = TdnnConfig(feat_dim=8, num_pdfs=12, hidden_dim=16,
                     nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    params = tdnn_params_from_jax(random_tdnn_params(
        cfg, np.random.default_rng(0)))
    opt = make_optimizer(NnetTrainOpts(initial_lr=0.1, final_lr=0.01), 4)
    step = make_train_step(Tdnn(cfg), opt)
    rng = np.random.default_rng(1)
    batch = (torch.as_tensor(rng.standard_normal((2, 17, 8), np.float32)),
             torch.as_tensor(rng.integers(0, 12, (2, 10)), dtype=torch.int32),
             torch.ones((2, 10)))
    t0 = now()
    state = opt.init(params)
    for _ in range(2):
        params, state, _loss, _acc = step(params, state, *batch)
    steps, updates = newest("train.step", t0), newest("train.update", t0)
    assert len(steps) == len(updates) == 2
    for s, u in zip(steps, updates):
        assert u.parent == s.id and u.request == s.request
        assert s.start <= u.start and u.end <= s.end


# -- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_frame_loop_annotation_encloses_its_gather_launches(card, graph,
                                                            tmp_path):
    ll, nf = loglikes()
    dec = CsrBeamDecoder(graph, CsrBeamOpts(**OPTS), device=card)
    dec.decode(ll, nf)                      # builds the kernel, warms up
    t0, n0 = now(), table_gather.launches
    with prof.device_trace(str(tmp_path)):
        dec.decode(ll, nf)
    n = table_gather.launches - n0
    (mine,) = newest("csr_beam.frame_loop", t0)
    events = json.load(open(os.path.join(tmp_path, "trace.json"))
                       )["traceEvents"]
    (ann,) = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == "csr_beam.frame_loop"]
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") == "kernel" and "table_gather_kernel" in e["name"]}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("args", {}).get("correlation") in corr]
    assert len(corr) == len(launches) == n >= ll.shape[1]
    a0, a1 = float(ann["ts"]), float(ann["ts"]) + float(ann["dur"])
    for e in launches:
        assert a0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= a1
    assert abs((mine.end - mine.start) * 1e6 - float(ann["dur"])) < 1e3
