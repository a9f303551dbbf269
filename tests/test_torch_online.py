"""The port's online serving (convdr_torch/retrieval/online.py,
drivers/serve_online.py) against the JAX package's, on the CPU.

On the tiny chain of ``tests/test_torch_pipeline.py`` (one model dir, 24
passages in two f32 blocks, 8 turns) plus an IVF int8 and an IVFPQ (pq4)
index built by the port's ``build_ivf_index``:

  * the port's ``serve_online --no_cuda`` against the JAX ``serve_online``
    on the same model dir, blocks and index, and against the port's batch
    driver at ``--per_gpu_eval_batch_size 1`` (the same encode shape, so
    the same embedding bits): flat f32, bf16 and int8 and IVF int8 at a
    full probe rank for rank (tolerance 0: the same pids in the same
    order); IVFPQ by sets (its ADC tables come from the device program in
    serving and from the host in the batch path, so near-ties may order
    differently);
  * the latency line, ``history_to_inputs``, ``_fold_int8_queries`` (bit
    for bit), ``ServeStats`` and the errors, each against the JAX package
    where it has a counterpart.
"""

import numpy as np
import pytest
import torch

from convdr_torch.drivers import build_ivf_index as torch_build
from convdr_torch.drivers import run_convdr_inference as torch_infer
from convdr_torch.drivers import serve_online as torch_serve
from convdr_torch.evaluation.metrics import parse_trec_run
from convdr_torch.ops.quant import Int8Quantizer, quantize_queries
from convdr_torch.retrieval import online
from convdr_torch.retrieval.blocks import write_embedding_block
from convdr_tpu.drivers import serve_online as jax_serve
from test_torch_pipeline import TOPICS, chain, embedded, infer_args  # noqa: F401

TURNS = 2 * len(TOPICS)  # the chain's eval topics: two turns a topic
BACKENDS = {
    "flat_f32": (["--storage_dtype", "float32"], []),
    "flat_bf16": (["--storage_dtype", "bfloat16"], ["--storage_dtype", "bfloat16"]),
    "flat_int8": (["--storage_dtype", "int8"], ["--storage_dtype", "int8"]),
    "ivf_int8": (["--ivf_dir", "IVF_INT8", "--nprobe", "999"], None),
    "ivfpq": (["--ivf_dir", "IVFPQ", "--nprobe", "999"], None),
}


@pytest.fixture(scope="module")
def served(embedded):
    """The ANN indexes (port builds), and each backend's port serve run,
    made once."""
    for name, flags in (("ivf_int8", ["--storage_dtype", "int8"]),
                        ("ivfpq", ["--storage_dtype", "pq4", "--pq_m", "8"])):
        torch_build.main(["--ann_data_dir", str(embedded / "torch_emb"), "--index_dir",
                          str(embedded / name), "--nlist", "4", "--kmeans_iters", "6",
                          "--no_cuda", *flags])
    return {"chain": embedded, "runs": {}}


def backend_flags(served, backend):
    chain = served["chain"]
    flags = [str(chain / f.lower()) if f in ("IVF_INT8", "IVFPQ") else f
             for f in BACKENDS[backend][0]]
    if "--ivf_dir" not in flags:
        flags = ["--ann_data_dir", str(chain / "torch_emb"), *flags]
    return flags


def serve_args(chain, name, flags):
    return [
        "--model_path", str(chain / "model"),
        "--eval_file", str(chain / "raw" / "eval_topics.jsonl"),
        "--model_type", "rdot_nll",
        "--processed_data_dir", str(chain / "processed"),
        "--qrels", str(chain / "raw" / "qrels.tsv"),
        "--output_trec_file", str(chain / f"{name}.trec"),
        "--top_n", "10",
        "--max_concat_length", "48",
        "--arch_size", "tiny",
        *flags,
    ]


def port_serve(served, backend):
    """(driver output, TREC path) of the port's serve run, run once."""
    runs = served["runs"]
    if backend not in runs:
        chain = served["chain"]
        name = f"serve_t_{backend}"
        out = torch_serve.main(serve_args(chain, name, backend_flags(served, backend)
                                          + ["--no_cuda"]))
        runs[backend] = (out, chain / f"{name}.trec")
    return runs[backend]


def runs_equal(trec_a, trec_b, *, sets_only=False):
    ra, rb = parse_trec_run(str(trec_a)), parse_trec_run(str(trec_b))
    assert set(ra) == set(rb) and len(ra) == TURNS
    for qid in ra:
        pids_a = [pid for pid, _ in ra[qid]]
        pids_b = [pid for pid, _ in rb[qid]]
        assert len(pids_a) == 10
        if sets_only:
            assert set(pids_a) == set(pids_b), qid
        else:
            assert pids_a == pids_b, qid


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_serve_matches_the_jax_serve(served, backend):
    """The port's serve run equals the JAX serve run on the same model dir,
    blocks and index: rank for rank (IVFPQ: sets)."""
    _out, trec = port_serve(served, backend)
    chain = served["chain"]
    jax_trec = chain / f"serve_j_{backend}.trec"
    jax_serve.main(serve_args(chain, f"serve_j_{backend}", backend_flags(served, backend)))
    runs_equal(trec, jax_trec, sets_only=backend == "ivfpq")


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_serve_matches_the_batch_driver_at_batch_1(served, backend):
    """The port's serve run equals the port's batch driver at
    ``--per_gpu_eval_batch_size 1`` over the same blocks or index: rank for
    rank (IVFPQ: sets)."""
    _out, trec = port_serve(served, backend)
    chain = served["chain"]
    flat_flags = BACKENDS[backend][1]
    extra = (flat_flags if flat_flags is not None else
             ["--ivf_dir", str(chain / backend), "--nprobe", "999"])
    torch_infer.main(infer_args(chain, "torch_emb", f"batch1_{backend}", "--no_cuda",
                                "--per_gpu_eval_batch_size", "1", *extra))
    runs_equal(trec, chain / f"batch1_{backend}.trec", sets_only=backend == "ivfpq")


def test_serving_latency_line(served, capsys):
    """``count`` is the number of turns (the warm-up call left out) and the
    percentiles are ordered; the metrics line follows it."""
    out, _trec = port_serve(served, "flat_f32")
    lat = out["serving_latency"]
    assert lat["count"] == TURNS
    assert lat["p50_ms"] > 0 and lat["p99_ms"] >= lat["p90_ms"] >= lat["p50_ms"]
    assert "ndcg_cut_3" in out and "recall_10" in out


def test_search_text_equals_search_tokens(served):
    """``search`` (history text, tokenized in) equals ``search_tokens`` on
    the dataset's ids, and a Q=2 call equals two Q=1 calls (rank for rank);
    the latency of every call is recorded."""
    from convdr_torch.data.conv_dataset import ConvSearchDataset

    chain = served["chain"]
    searcher = online.OnlineSearcher.from_blocks(
        str(chain / "model"), str(chain / "torch_emb"), top_n=10, max_concat_length=48,
        arch_preset="tiny", device="cpu")
    dataset = ConvSearchDataset([str(chain / "raw" / "eval_topics.jsonl")], searcher.tokenizer,
                                mode="inference", query_mode="no_res", model_type="rdot_nll",
                                max_concat_length=48)
    batch = next(iter(dataset.batches(2)))
    s2, i2 = searcher.search_tokens(batch["concat_ids"], batch["concat_mask"])
    for r in range(2):
        s_t, i_t = searcher.search(batch["history_utterances"][r])
        s_1, i_1 = searcher.search_tokens(batch["concat_ids"][r:r + 1],
                                          batch["concat_mask"][r:r + 1])
        np.testing.assert_array_equal(i_t, i_1)
        np.testing.assert_array_equal(s_t, s_1)
        np.testing.assert_array_equal(i2[r], i_1[0])
    assert len(searcher.stats.latencies) == 5
    assert searcher.graphs == {}  # the CPU runs the program eagerly
    with pytest.raises(ValueError):
        searcher.search_tokens(batch["concat_ids"][:, :40], batch["concat_mask"][:, :40])


@pytest.mark.parametrize("model_type", ["rdot_nll", "dpr"])
@pytest.mark.parametrize("response", [None, "a canonical response about the topic"])
def test_history_to_inputs_matches_jax(model_type, response):
    """ids and mask equal to the JAX ``history_to_inputs`` (RoBERTa and
    BERT layouts, with and without the ``<response>`` injection), at a
    length that pads and at one that truncates."""
    from convdr_torch.data.tokenizers import load_tokenizer as torch_tok
    from convdr_tpu.data.tokenizers import load_tokenizer as jax_tok
    from convdr_tpu.retrieval.online import history_to_inputs as jax_h2i

    kind = "bert" if model_type == "dpr" else "roberta"
    ours, theirs = torch_tok(kind, "tiny"), jax_tok(kind, "tiny")
    history = ["hi there", "more on cats and dogs", "how do they treat fleas?"]
    for length in (64, 12):
        got = online.history_to_inputs(ours, history, model_type=model_type,
                                       max_concat_length=length, response_text=response)
        want = jax_h2i(theirs, history, model_type=model_type, max_concat_length=length,
                       response_text=response)
        for a, b in zip(got, want):
            assert a.dtype == np.int32 and a.shape == (1, length)
            np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError):
        online.history_to_inputs(ours, [])


def test_fold_int8_queries_bit_equal_to_jax_and_host():
    """The device fold equals the JAX fold and the host ``quantize_queries``
    bit for bit (tolerance 0) on seeded rows, a zero row, and rows whose
    folded values land on .5 (round half to even)."""
    import jax.numpy as jnp

    from convdr_tpu.retrieval.online import _fold_int8_queries as jax_fold

    rng = np.random.RandomState(11)
    q = rng.randn(16, 48).astype(np.float32)
    scales = (np.abs(rng.randn(48)) / 127.0 + 1e-3).astype(np.float32)
    q[3] = 0.0
    # one scale 1, the row's max |value| 127: t = 1 and the values are the
    # halves -126.5 .. 126.5 themselves
    scales[:] = 1.0
    q[5] = (np.arange(48) - 24 + 0.5).astype(np.float32) * 5.0 + 0.5
    q[5, 0] = 127.0
    q[6] = np.linspace(-2.5, 2.5, 48).astype(np.float32)
    q[6, 0] = 127.0
    q_int, t = online._fold_int8_queries(torch.from_numpy(q), torch.from_numpy(scales))
    j_int, j_t = jax_fold(jnp.asarray(q), jnp.asarray(scales))
    h_int, h_t = quantize_queries(q, scales)
    assert q_int.dtype == torch.float32 and t.shape == (16, 1)
    for want_int, want_t in ((np.asarray(j_int), np.asarray(j_t)), (h_int, h_t)):
        assert q_int.numpy().tobytes() == want_int.astype(np.float32).tobytes()
        assert t.numpy().tobytes() == want_t.astype(np.float32).tobytes()
    assert np.all(q_int.numpy()[3] == 0) and t[3, 0] == 1.0
    halves = q[6] / t.numpy()[6, 0]
    assert np.any(np.abs(halves - np.round(halves)) == 0.5)  # ties occur and agree


def test_serve_stats_summary_matches_jax():
    """``summary()`` equal to the JAX ``ServeStats``' on the same latencies;
    an empty one summarises to count 0 and its percentile raises."""
    from convdr_tpu.retrieval.online import ServeStats as JaxStats

    lat = list(np.random.RandomState(12).exponential(0.004, 57))
    assert online.ServeStats(list(lat)).summary() == JaxStats(list(lat)).summary()
    assert online.ServeStats(list(lat)).percentile(90) == JaxStats(list(lat)).percentile(90)
    empty = online.ServeStats([])
    assert empty.summary() == {"count": 0}
    with pytest.raises(ValueError):
        empty.percentile(50)


def test_from_blocks_int8_sidecar_rules(tmp_path, caplog):
    """int8 blocks without a sidecar raise; float blocks under an int8
    config without one fit their scales on block 0 (with a warning), as the
    batch searcher does; int8 blocks under a float config dequantize
    through the sidecar (the dequantized corpus, not a cast)."""
    rng = np.random.RandomState(13)
    f32_dir, i8_dir, bare_dir = tmp_path / "f32", tmp_path / "i8", tmp_path / "bare"
    rows = rng.randn(300, 32).astype(np.float32)
    for b in range(2):
        write_embedding_block(str(f32_dir), b, rows[b * 150:(b + 1) * 150],
                              np.arange(b * 150, (b + 1) * 150))
    quant = Int8Quantizer.fit(rows[:150])
    for d in (i8_dir, bare_dir):
        for b in range(2):
            write_embedding_block(str(d), b, quant.quantize_passages(rows[b * 150:(b + 1) * 150]),
                                  np.arange(b * 150, (b + 1) * 150))
    quant.save(str(i8_dir))
    kw = dict(top_n=5, max_concat_length=16, arch_preset="tiny", device="cpu")
    with pytest.raises(FileNotFoundError):
        online.OnlineSearcher.from_blocks(None, str(bare_dir), storage_dtype="int8", **kw)
    with pytest.raises(FileNotFoundError):
        online.OnlineSearcher.from_blocks(None, str(tmp_path / "none"), **kw)
    with caplog.at_level("WARNING"):
        fitted = online.OnlineSearcher.from_blocks(None, str(f32_dir), storage_dtype="int8",
                                                   **kw)
    assert "fitting scales on block 0" in caplog.text
    corpus, scales = fitted._operands
    np.testing.assert_array_equal(scales.numpy(), quant.scales)
    assert corpus.dtype == torch.int8 and corpus.shape == (384, 32)  # padded to the tile
    np.testing.assert_array_equal(corpus[:300].numpy(), quant.quantize_passages(rows))
    assert not corpus[300:].any()
    deq = online.OnlineSearcher.from_blocks(None, str(i8_dir), **kw)
    np.testing.assert_array_equal(
        deq._operands[0][:300].numpy(),
        quant.quantize_passages(rows).astype(np.float32) * quant.scales[None, :])
    assert deq.resident_bytes == 384 * 32 * 4
    with pytest.raises(NotImplementedError):
        online.OnlineSearcher.from_blocks(None, str(f32_dir), precision="high", **kw)


def test_driver_errors(served, monkeypatch):
    """Without ``--no_cuda`` and without a card the driver raises;
    ``--matmul_precision high`` raises as not ported; exactly one backend."""
    chain = served["chain"]
    flat = ["--ann_data_dir", str(chain / "torch_emb")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_serve.main(serve_args(chain, "never", flat))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        torch_serve.main(serve_args(chain, "never", flat + ["--matmul_precision", "high",
                                                             "--no_cuda"]))
    with pytest.raises(ValueError, match="exactly one"):
        torch_serve.main(serve_args(chain, "never", ["--no_cuda"]))
    with pytest.raises(ValueError, match="exactly one"):
        torch_serve.main(serve_args(chain, "never", flat + ["--ivf_dir", "x", "--no_cuda"]))


@pytest.mark.parametrize("storage,opq", [("float32", 0), ("int8", 0), ("pq4", 2)])
def test_from_ivf_query_prep_matches_the_index_search(tmp_path, storage, opq):
    """The program's query-side prep on seeded embeddings against
    ``IVFIndex.search`` (host prep) over the same saved index: f32 lists
    and the SQ8 fold score for score and rank for rank (tolerance 0);
    IVFPQ with an OPQ rotation by sets, sorted scores within 1e-5
    relative (its ADC tables come from another f32 product order than the
    host's, then round to bf16 in both)."""
    from convdr_torch.retrieval.ivf import IVFIndex

    rng = np.random.RandomState(14)
    rows = (rng.randn(16, 32)[rng.randint(0, 16, 600)] + rng.randn(600, 32)).astype(np.float32)
    q = (rows[rng.randint(0, 600, 6)] + 0.5 * rng.randn(6, 32)).astype(np.float32)
    index = IVFIndex.build(rows, 4, rowids=np.arange(600) * 3 + 1, storage_dtype=storage,
                           pq_m=8, opq_iters=opq, pack=storage == "pq4", iters=4, device="cpu")
    index.save(str(tmp_path / "ivf"))
    searcher = online.OnlineSearcher.from_ivf(None, str(tmp_path / "ivf"), top_n=20, nprobe=3,
                                              arch_preset="tiny", device="cpu")
    assert (index.codec is not None and index.codec.rotation is not None) == bool(opq)
    s, i = searcher.search_embeddings(torch.from_numpy(q))
    want_s, want_i = IVFIndex.load(str(tmp_path / "ivf"), device="cpu").search(q, 20, nprobe=3)
    if storage == "pq4":
        for r in range(6):
            assert set(i[r].tolist()) == set(want_i[r].tolist())
        np.testing.assert_allclose(np.sort(s.numpy(), 1), np.sort(want_s, 1), rtol=1e-5)
    else:
        np.testing.assert_array_equal(i.numpy(), want_i)
        assert s.numpy().tobytes() == want_s.tobytes()
