"""The yardstick's operation and byte counts against hand counts at small
shapes, and the readers built on them."""

import pytest

from h100_bench import devtrace, readers, work

CFG = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2,
       "num_attention_heads": 2, "embedding_dim": 4, "head": "linear_layernorm"}
PK = {"bf16_flops_per_s": 100.0, "hbm_bytes_per_s": 10.0}


def test_encoder_flops_by_hand():
    # one sequence of 3 tokens, h=4, i=8, 2 layers:
    # projections 4 x (3 x 4 x 4) MACs, scores and values 2 x (3 x 3 x 4),
    # feed-forward 2 x (3 x 4 x 8) MACs; the head 4 x 4 MACs on one token
    per_layer_macs = 4 * 48 + 2 * 36 + 2 * 96
    expect = 2 * (2 * per_layer_macs + 16)
    assert work.encoder_flops(CFG, [3]) == expect
    assert work.encoder_flops(CFG, [3, 3]) == 2 * expect
    assert work.encoder_flops(dict(CFG, head="none"), [3]) == 2 * 2 * per_layer_macs


def test_attention_fwd_by_hand():
    # 5 valid tokens, H x D = 4: QK^T and PV, 2 x 25 pairs x 4 MACs;
    # q, k, v, out of 5 x 4 f32 each; lse of 5 rows x 2 heads
    w = work.attention_fwd(CFG, [5], 4)
    assert w.flops == 2 * 2 * 25 * 4
    assert w.bytes == 4 * 5 * 4 * 4
    assert work.attention_fwd(CFG, [5], 4, with_lse=True).bytes == w.bytes + 5 * 2 * 4


def test_attention_bwd_by_hand():
    # S again, dP, dV, dK, dQ: 5 products of 25 pairs x 4 MACs; q, k, v, o,
    # dO read and dq, dk, dv written (8 x 5 x 4 f32), lse read (5 x 2 f32)
    w = work.attention_bwd(CFG, [5], 4)
    assert w.flops == 5 * 2 * 25 * 4
    assert w.bytes == 8 * 5 * 4 * 4 + 5 * 2 * 4


def test_scores_and_search_by_hand():
    w = work.scores(q=2, rows=64, dim=8, group=32)
    assert w.flops == 2 * 2 * 64 * 8
    assert w.bytes == 64 * 8 * 4 + 2 * 8 * 4 + 2 * 64 * 4 + 2 * 2 * 4
    s = work.search(q=2, rows=64, dim=8)
    assert (s.flops, s.bytes) == (2 * 2 * 64 * 8, 64 * 8 * 4)


def test_least_time_is_the_larger_bound():
    assert work.Work(1000, 5).least_s(PK) == 10.0  # operations bound
    assert work.Work(10, 50).least_s(PK) == 5.0  # bytes bound
    assert (work.Work(1, 2) + work.Work(3, 4)).flops == 4
    assert (work.Work(1, 2) * 3).bytes == 6


def test_published_peaks():
    pk = work.peaks()
    assert pk["bf16_flops_per_s"] == 989e12
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["int8_ops_per_s"] == 1979e12


def fake_trace(kernels, busy, window):
    return devtrace.Trace(window_s=window, busy_s=busy, kernels=kernels)


def test_roofline_reads_least_time_over_kernel_time():
    least = work.scores(1, 2 ** 20, 768, 32).least_s(work.peaks())
    obs = {"trace": fake_trace([("void scores_groupmax_f32_small_q<1>", 2 * least),
                                ("gather_groups_kernel", 1.0)], 1.0, 2.0),
           "work": {"scores": work.scores(1, 2 ** 20, 768, 32)}}
    assert readers.roofline(obs, "scores", readers.SCORES) == pytest.approx(50.0)
    # a kernel at its least time reads 100%, never more
    obs["trace"] = fake_trace([("scores_groupmax_f32", least)], 1.0, 2.0)
    assert readers.roofline(obs, "scores", readers.SCORES) == pytest.approx(100.0)
    # nothing to read: no trace, no such kernel
    assert readers.roofline({}, "scores", readers.SCORES) is None
    obs["trace"] = fake_trace([("other", 1.0)], 1.0, 2.0)
    assert readers.roofline(obs, "scores", readers.SCORES) is None


def test_idle_share_and_mfu():
    assert readers.idle_share({"trace": fake_trace([], 1.5, 2.0)}) == pytest.approx(25.0)
    assert readers.idle_share({"trace": fake_trace([], 0.0, 2.0)}) is None
    assert readers.mfu({"least_s": [0.1, 0.3], "window_s": 2.0}) == pytest.approx(20.0)
    assert readers.mfu({"least_s": [], "window_s": 2.0}) is None
    assert readers.latency_ms({"latency_s": [0.001, 0.002, 0.003]}, 50) == pytest.approx(2.0)
    assert readers.rate({"units": 30, "window_s": 3.0}) == 10.0


def test_trace_reading_busy_union_and_idle_gaps():
    ev = [
        {"name": devtrace.SPAN, "ph": "X", "cat": "user_annotation", "ts": 0, "dur": 100,
         "pid": 1, "tid": 1},
        {"name": devtrace.SPAN, "ph": "X", "cat": "gpu_user_annotation", "ts": 0, "dur": 100,
         "pid": 2, "tid": 7},
        {"name": "void k1<float>(int)", "ph": "X", "cat": "kernel", "ts": 10, "dur": 20},
        {"name": "k2", "ph": "X", "cat": "kernel", "ts": 20, "dur": 20},  # overlaps k1
        {"name": "Memcpy HtoD", "ph": "X", "cat": "gpu_memcpy", "ts": 60, "dur": 10},
        {"name": "aten::copy_", "ph": "X", "cat": "cpu_op", "ts": 40, "dur": 30,
         "pid": 1, "tid": 1},
        {"name": "bench.feed", "ph": "X", "cat": "user_annotation", "ts": 70, "dur": 30,
         "pid": 1, "tid": 1},
    ]
    tr = devtrace.read_trace(ev)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)  # [10, 40] and [60, 70]
    assert tr.kernel_seconds(["k1"]) == (pytest.approx(20e-6), 1)
    assert dict(tr.device_ops)["k1"] == pytest.approx(20e-6)
    gaps = dict(tr.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(20e-6)  # [40, 60]
    assert gaps["bench.feed"] == pytest.approx(30e-6)  # [70, 100]
    assert gaps["host outside any traced operation"] == pytest.approx(10e-6)  # [0, 10]
