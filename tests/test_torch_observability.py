"""The port's phase timer and profiler trace (CPU): ``PhaseTimer`` logs to
its sink as the JAX package's does, ``profile_trace("")`` does nothing,
``profile_trace(dir)`` writes a Chrome trace whose span covers the block,
and the inference driver with ``--profile_dir --no_cuda`` writes one of
its search phase."""

import json
import logging
import os

import pytest
import torch

from convdr_torch.drivers import gen_passage_embeddings as torch_embed
from convdr_torch.drivers import run_convdr_inference as torch_infer
from convdr_torch.utils import observability as tobs
from convdr_tpu.utils import observability as jobs
from test_torch_pipeline import chain, embed_args, infer_args  # noqa: F401


def test_phase_timer_logs_to_its_sink_as_jax(tmp_path, caplog):
    recs = {}
    for name, mod in (("torch", tobs), ("jax", jobs)):
        sink = mod.MetricsLogger(str(tmp_path / name))
        with caplog.at_level(logging.INFO):
            with mod.PhaseTimer("search", sink=sink, step=7) as timer:
                sum(range(1000))
        sink.close()
        assert timer.elapsed >= 0
        with open(tmp_path / name / "metrics.jsonl") as f:
            recs[name] = json.loads(f.read())
    assert recs["torch"].keys() == recs["jax"].keys() == {"step", "time", "search_seconds"}
    assert recs["torch"]["step"] == 7
    assert "phase search:" in caplog.text
    with tobs.PhaseTimer("alone") as timer:  # no sink
        pass
    assert timer.elapsed >= 0


def test_profile_trace_without_dir_does_nothing(tmp_path, monkeypatch):
    def no_profiler(*a, **k):
        raise AssertionError("the profiler must not start")

    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    for log_dir in ("", None):
        with tobs.profile_trace(log_dir) as got:
            assert got is None
    assert os.listdir(tmp_path) == []


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tobs.profile_trace(log_dir):
        x = torch.randn(64, 64)
        (x @ x).sum()
    (name,) = os.listdir(log_dir)
    assert name.startswith("trace-") and name.endswith(".json")
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == tobs.TRACE_SPAN]
    assert len(spans) == 1 and spans[0]["dur"] > 0
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.fixture(scope="module")
def port_blocks(chain):
    torch_embed.main(embed_args(chain, "obs_emb") + ["--no_cuda"])
    return chain


@pytest.mark.parametrize("profile", [False, True])
def test_inference_driver_profile_dir(port_blocks, tmp_path, profile):
    trace_dir = tmp_path / "search_trace"
    extra = ["--profile_dir", str(trace_dir)] if profile else []
    means = torch_infer.main(
        infer_args(port_blocks, "obs_emb", f"obs_{profile}", "--no_cuda", *extra)
    )
    assert "ndcg_cut_3" in means
    if not profile:
        assert not trace_dir.exists()
        return
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == tobs.TRACE_SPAN for e in events)
    # the trace changes nothing in the run (the untraced case ran first)
    assert (port_blocks / "obs_True.trec").read_bytes() == (
        port_blocks / "obs_False.trec").read_bytes()
