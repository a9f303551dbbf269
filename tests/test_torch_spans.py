"""The program's spans (CPU): ``observability.span`` is one shared no-op
while no profiler runs and a ``record_function`` while one does; the train
step, the embed pass and the serving turn record their ``convdr.*`` spans,
nested as the layers nest; ``h100_bench.spans.read_spans`` counts each
span's launches, device time and idle time on a hand-built trace, every
value counted by hand; ``program_span`` never makes up a number; and
``PhaseTimer`` logs its perf-counter seconds, synchronizes a card at exit
and opens its ``convdr.phase.*`` span. (This file imports nothing of JAX.)"""

import json
import logging
import time

import numpy as np
import pytest
import torch

from convdr_torch.core.config import EncoderArchConfig, ModelConfig, TrainConfig
from convdr_torch.core.loading import make_apply_fn
from convdr_torch.data.token_cache import TokenCache, TokenCacheWriter
from convdr_torch.models.encoders import build_model
from convdr_torch.retrieval import online
from convdr_torch.retrieval.blocks import write_embedding_block
from convdr_torch.retrieval.embed_corpus import generate_embeddings
from convdr_torch.train import trainer
from convdr_torch.utils import observability
from h100_bench import devtrace
from h100_bench.spans import program_span, read_spans

TRAIN_SPANS = ["convdr.train.student_fwd", "convdr.train.teacher_targets",
               "convdr.train.teacher_docs", "convdr.train.backward",
               "convdr.train.optimizer"]


def profiled(fn):
    """The ``convdr.*`` user annotations recorded while ``fn()`` runs under
    the profiler (CPU activity), each as (name, start, end) in us."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name.startswith("convdr."))


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def tiny_config():
    return ModelConfig(name="rdot_nll", arch=EncoderArchConfig.tiny(vocab_size=64),
                       embedding_dim=16)


# ---------------------------------------------------------------------------
# the helper
# ---------------------------------------------------------------------------
def test_span_off_is_one_shared_no_op(monkeypatch):
    def entered(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert not torch.autograd._profiler_enabled()
    a, b = observability.span("convdr.a"), observability.span("convdr.b")
    assert a is b
    with a, b:
        pass
    assert profiled(lambda: None) == []


def test_span_on_is_a_user_annotation_on_the_profilers_clock():
    def work():
        with observability.span("convdr.test.outer"):
            with observability.span("convdr.test.inner"):
                torch.ones(8).sum()

    got = profiled(work)
    assert [n for n, _, _ in got] == ["convdr.test.inner", "convdr.test.outer"]
    assert inside(got[0], got[1])
    assert observability.span("convdr.x") is observability.span("convdr.y")  # off again


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------
def tiny_batch(seed=3, b=2, t=24, k=3, doc_len=20):
    rng = np.random.RandomState(seed)
    mask = (np.arange(t)[None] < rng.randint(3, t + 1, size=(b, 1))).astype(np.int32)
    dmask = (np.arange(doc_len) < rng.randint(1, doc_len + 1, size=(b, k, 1))).astype(np.int32)
    tmask = (np.arange(12)[None] < rng.randint(2, 13, size=(b, 1))).astype(np.int32)
    batch = {"concat_ids": rng.randint(4, 60, size=(b, t)) * mask + (1 - mask),
             "concat_mask": mask, "target_ids": rng.randint(4, 60, size=(b, 12)),
             "target_mask": tmask, "doc_ids": rng.randint(4, 60, size=(b, k, doc_len)),
             "doc_mask": dmask}
    return {n: torch.from_numpy(np.asarray(v, np.int32)) for n, v in batch.items()}


def test_train_step_records_its_six_spans_nested_in_the_step():
    torch.manual_seed(0)
    cfg = tiny_config()
    student, teacher = build_model(cfg), build_model(cfg)
    config = TrainConfig(ranking_task=True, num_negatives=2)
    state, tx = trainer.create_train_state(student, config, 10)
    step = trainer.make_train_step(student, teacher, tx, config)
    step(state, tiny_batch())  # a first step outside the profiler
    got = profiled(lambda: step(state, tiny_batch(4)))
    names = [n for n, _, _ in got]
    assert sorted(names) == sorted(TRAIN_SPANS + ["convdr.train.step"])
    (outer,) = [s for s in got if s[0] == "convdr.train.step"]
    assert all(inside(s, outer) for s in got)
    order = sorted(got, key=lambda s: s[1])
    assert [n for n, _, _ in order] == ["convdr.train.step"] + TRAIN_SPANS
    assert state.step == 2


def test_embed_pass_records_its_batches_readbacks_and_blocks(tmp_path):
    torch.manual_seed(0)
    rng = np.random.RandomState(1)
    with TokenCacheWriter(str(tmp_path / "cache"), 32) as w:
        for _ in range(40):
            w.write(rng.randint(4, 60, rng.randint(2, 33)))
    apply_fn = make_apply_fn(build_model(tiny_config()))

    def one_pass():
        rows = generate_embeddings(apply_fn, TokenCache(str(tmp_path / "cache")),
                                   str(tmp_path / "out"), device=torch.device("cpu"),
                                   batch_size=8, num_blocks=2, length_buckets=(16, 32))
        assert rows == 40

    got = profiled(one_pass)
    by = {n: [s for s in got if s[0] == n] for n in {s[0] for s in got}}
    assert set(by) == {"convdr.embed.pass", "convdr.embed.batch", "convdr.embed.readback",
                       "convdr.embed.write_block"}
    (outer,) = by["convdr.embed.pass"]
    assert len(by["convdr.embed.write_block"]) == 2  # one a block
    assert len(by["convdr.embed.batch"]) == len(by["convdr.embed.readback"]) >= 5
    assert all(inside(s, outer) for s in got)
    for r in by["convdr.embed.readback"]:
        assert sum(inside(r, b) for b in by["convdr.embed.batch"]) == 1


def test_cpu_turn_records_the_turn_span(tmp_path):
    rng = np.random.RandomState(2)
    write_embedding_block(str(tmp_path / "blocks"), 0, rng.randn(200, 32).astype(np.float32),
                          np.arange(200))
    searcher = online.OnlineSearcher.from_blocks(
        None, str(tmp_path / "blocks"), top_n=5, max_concat_length=16, arch_preset="tiny",
        device="cpu")
    ids = np.zeros((1, 16), np.int32)
    mask = np.zeros_like(ids)
    ids[0, :5], mask[0, :5] = [0, 7, 9, 11, 2], 1
    want = searcher.search_tokens(ids, mask)
    got = []
    spans = profiled(lambda: got.append(searcher.search_tokens(ids, mask)))
    assert [n for n, _, _ in spans] == ["convdr.serve.turn"]  # no replay on the CPU
    assert np.array_equal(got[0][1], want[1]) and np.array_equal(got[0][0], want[0])
    assert len(searcher.stats.latencies) == 2


# ---------------------------------------------------------------------------
# the reader, on a hand-built trace (us)
# ---------------------------------------------------------------------------
def host(name, ts, dur, cat="user_annotation", pid=1, tid=1, corr=None):
    e = {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def dev(name, ts, dur, corr, cat="kernel"):
    return {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


HAND = [
    host(devtrace.SPAN, 0, 1000),
    host("convdr.t.outer", 100, 500),
    host("convdr.t.inner", 200, 200),  # nested in outer
    host("cudaLaunchKernel", 210, 5, "cuda_runtime", corr=1),
    dev("k1", 250, 50, 1),
    host("cudaGraphLaunch", 300, 8, "cuda_runtime", corr=3),  # three kernels, one id
    dev("g1", 310, 20, 3), dev("g2", 320, 30, 3), dev("g3", 400, 10, 3),
    host("cudaLaunchKernel", 450, 5, "cuda_runtime", tid=2, corr=2),  # autograd's thread
    dev("k2", 460, 60, 2),
    host("cudaMemcpyAsync", 550, 5, "cuda_runtime", corr=4),
    dev("Memcpy DtoH", 560, 20, 4, cat="gpu_memcpy"),
    host("cudaEventSynchronize", 585, 10, "cuda_runtime", corr=5),  # no device op
    host("convdr.t.empty", 700, 100),  # no launches: idle its whole length
    host("convdr.t.inner", 820, 80),  # a second inner span, idle
    host("convdr.t.late", 950, 150),  # ends after the segment
    host("convdr.t.after", 1200, 100),  # after the segment
    host("convdr.t.inner", 300, 50, pid=9),  # another process
    host("aten::mm", 220, 30, "cpu_op"),
]
# the device's busy union in the segment: [250, 300], [310, 350], [400, 410],
# [460, 520], [560, 580]
HAND_BUSY = [(250, 300), (310, 350), (400, 410), (460, 520), (560, 580)]


def test_read_spans_on_a_hand_built_trace():
    got = read_spans(HAND, 0, 1000, HAND_BUSY, pid=1)
    assert set(got) == {"convdr.t.outer", "convdr.t.inner", "convdr.t.empty"}
    us = pytest.approx
    # inner: k1 and the graph's three kernels; device [250,300] + [310,350] +
    # [400,410]; idle: 200 - 50 - 40 in the first, 80 in the second
    assert got["convdr.t.inner"] == {"count": 2, "host_s": us(280e-6), "launches": 4,
                                     "device_s": us(100e-6), "idle_s": us(190e-6)}
    # outer: the inner's four, k2 from the second thread, the copy; busy 180
    assert got["convdr.t.outer"] == {"count": 1, "host_s": us(500e-6), "launches": 6,
                                     "device_s": us(180e-6), "idle_s": us(320e-6)}
    assert got["convdr.t.empty"] == {"count": 1, "host_s": us(100e-6), "launches": 0,
                                     "device_s": 0.0, "idle_s": us(100e-6)}
    # any process: the other process's inner span counts too (its interval is
    # the device's busy [310, 350])
    assert read_spans(HAND, 0, 1000, HAND_BUSY)["convdr.t.inner"]["count"] == 3


def test_read_spans_clips_device_time_to_the_segment():
    ev = [host("convdr.t.tail", 100, 100),
          host("cudaLaunchKernel", 150, 5, "cuda_runtime", corr=1),
          dev("k", 180, 100, 1)]  # runs past the segment's end at 200
    got = read_spans(ev, 0, 200, [(180, 200)])
    assert got["convdr.t.tail"]["launches"] == 1
    assert got["convdr.t.tail"]["device_s"] == pytest.approx(20e-6)
    assert got["convdr.t.tail"]["idle_s"] == pytest.approx(80e-6)


def test_read_spans_of_a_real_cpu_trace(tmp_path):
    """The profiler's own Chrome trace of a traced segment: the spans come
    out with their counts, no device work on the CPU, idle throughout."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.SPAN):
            for _ in range(3):
                with observability.span("convdr.t.call"):
                    torch.ones(64).cumsum(0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    (seg,) = [e for e in events if e.get("name") == devtrace.SPAN]
    got = read_spans(events, seg["ts"], seg["ts"] + seg["dur"], [], pid=seg["pid"])
    call = got["convdr.t.call"]
    assert call["count"] == 3 and call["launches"] == 0 and call["device_s"] == 0.0
    assert call["idle_s"] == pytest.approx(call["host_s"]) and call["host_s"] > 0


class SpanTrace:
    def __init__(self, spans):
        self.spans = spans


@pytest.mark.parametrize("case", ["ok", "no_trace", "no_spans_field", "absent", "per_absent"])
def test_program_span_reads_a_total_per_count_or_none(case):
    spans = {"convdr.t.part": {"count": 6, "host_s": 0.3, "launches": 12, "device_s": 0.2,
                               "idle_s": 0.1},
             "convdr.t.whole": {"count": 3, "host_s": 0.9, "launches": 12, "device_s": 0.6,
                                "idle_s": 0.3}}
    obs = {
        "ok": {"trace": SpanTrace(spans)},
        "no_trace": {},
        "no_spans_field": {"trace": devtrace.Trace(window_s=1.0, busy_s=0.5)},
        "absent": {"trace": SpanTrace({"convdr.t.whole": spans["convdr.t.whole"]})},
        "per_absent": {"trace": SpanTrace({"convdr.t.part": spans["convdr.t.part"]})},
    }[case]
    got = program_span(obs, "convdr.t.part", "launches", "convdr.t.whole")
    assert got == (4.0 if case == "ok" else None)


# ---------------------------------------------------------------------------
# the phase timer
# ---------------------------------------------------------------------------
def test_phase_timer_logs_perf_counter_seconds(tmp_path, monkeypatch, caplog):
    clock = iter([10.0, 12.5])
    monkeypatch.setattr(observability.time, "perf_counter", lambda: next(clock))
    sink = observability.MetricsLogger(str(tmp_path))
    with caplog.at_level(logging.INFO):
        with observability.PhaseTimer("search", sink=sink, step=3, device="cpu") as timer:
            pass
    sink.close()
    assert timer.elapsed == 2.5
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["search_seconds"] == 2.5
    assert "phase search: 2.5000s" in caplog.text


def test_phase_timer_synchronizes_a_card_before_it_reads_the_clock(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(("sync", d)))
    monkeypatch.setattr(observability.time, "perf_counter",
                        lambda: calls.append(("clock", None)) or float(len(calls)))
    with observability.PhaseTimer("search", device=torch.device("cuda", 0)):
        pass
    assert calls == [("clock", None), ("sync", torch.device("cuda", 0)), ("clock", None)]
    calls.clear()
    with observability.PhaseTimer("search"):  # no device: no sync
        pass
    assert calls == [("clock", None), ("clock", None)]


def test_phase_timer_opens_its_span():
    def phase():
        with observability.PhaseTimer("search"):
            torch.ones(8).sum()

    assert [n for n, _, _ in profiled(phase)] == ["convdr.phase.search"]
    start = time.perf_counter()
    with observability.PhaseTimer("alone") as timer:
        pass
    assert 0 <= timer.elapsed <= time.perf_counter() - start
