"""The port's two drivers against the JAX package's on one tiny chain (CPU).

One model directory (a JAX tiny init exported in the reference's
``pytorch_model.bin`` format, plus its tokenizer), one token cache, one set
of topics and qrels. Both embed drivers write blocks, both inference drivers
search them. The blocks must agree within 1e-5 (f32, another summation
order) and cross-read in both directions; the TREC run files must be
byte-identical and the metrics equal.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest

from convdr_torch.drivers import gen_passage_embeddings as torch_embed
from convdr_torch.drivers import run_convdr_inference as torch_infer
from convdr_torch.retrieval.blocks import iter_embedding_blocks as torch_iter
from convdr_tpu.drivers import gen_passage_embeddings as jax_embed
from convdr_tpu.drivers import run_convdr_inference as jax_infer
from convdr_tpu.drivers import tokenize_collection
from convdr_tpu.retrieval.blocks import iter_embedding_blocks as jax_iter

TOPICS = ["cats", "dogs", "fish", "birds"]
N_PASSAGES = 24


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_chain")
    raw = work / "raw"
    os.makedirs(raw)
    with open(raw / "collection.tsv", "w") as f:
        for pid in range(N_PASSAGES):
            more = " and more words" * (pid % 7)  # spread lengths over rungs
            f.write(f"{pid}\tall about {TOPICS[pid % 4]} number {pid}{more}\n")
    with open(raw / "queries.raw.tsv", "w") as f:
        for t, topic in enumerate(TOPICS):
            f.write(f"{t + 1}_1\ttell me about {topic}\n")
            f.write(f"{t + 1}_2\tand what do they eat\n")
    topics = []
    for t, topic in enumerate(TOPICS):
        for turn, utt in ((1, f"tell me about {topic}"), (2, "and what do they eat")):
            topics.append({
                "topic_number": t + 1, "query_number": turn,
                "input": [f"tell me about {topic}", utt][:turn],
                "target": f"tell me about {topic}",
            })
    with open(raw / "eval_topics.jsonl", "w") as f:
        for rec in topics:
            f.write(json.dumps(rec) + "\n")
    for fold in range(5):  # cross-validation folds (reference NUM_FOLD)
        with open(raw / f"eval_topics.jsonl.{fold}", "w") as f:
            for rec in topics[fold::5]:
                f.write(json.dumps(rec) + "\n")
    with open(raw / "qrels.tsv", "w") as f:
        for t in range(4):
            for pid in range(N_PASSAGES):
                if pid % 4 == t:
                    f.write(f"{t + 1}_1\t0\t{pid}\t{1 + pid % 2}\n")
                    f.write(f"{t + 1}_2\t0\t{pid}\t1\n")
    tokenize_collection.main([
        "--collection", str(raw / "collection.tsv"),
        "--out_data_dir", str(work / "processed"),
        "--model_type", "rdot_nll",
        "--max_seq_length", "96",
        "--num_workers", "1",
    ])
    # one model dir, in the reference's HF format, shared by both packages
    from convdr_tpu.core.loading import load_model_and_params
    from convdr_tpu.models.import_torch import export_ance_checkpoint

    model_dir = work / "model"
    os.makedirs(model_dir)
    cfg, tok, _model, params = load_model_and_params("rdot_nll", None, arch_preset="tiny")
    export_ance_checkpoint(
        jax.tree.map(np.asarray, params), cfg, str(model_dir / "pytorch_model.bin")
    )
    tok.save_pretrained(str(model_dir))
    for fold in range(5):
        os.symlink(model_dir, work / f"model-{fold}")
    return work


def embed_args(chain, out):
    return [
        "--data_dir", str(chain / "processed"),
        "--checkpoint", str(chain / "model"),
        "--model_type", "rdot_nll",
        "--output_dir", str(chain / out),
        "--per_gpu_eval_batch_size", "4",
        "--num_blocks", "2",
        "--dtype", "float32",
        "--arch_size", "tiny",
    ]


def infer_args(chain, emb_dir, name, *extra):
    return [
        "--model_path", str(chain / "model"),
        "--eval_file", str(chain / "raw" / "eval_topics.jsonl"),
        "--model_type", "rdot_nll",
        "--ann_data_dir", str(chain / emb_dir),
        "--processed_data_dir", str(chain / "processed"),
        "--raw_data_dir", str(chain / "raw"),
        "--qrels", str(chain / "raw" / "qrels.tsv"),
        "--output_trec_file", str(chain / f"{name}.trec"),
        "--output_file", str(chain / f"{name}.jsonl"),
        "--output_query_type", "raw",
        "--top_n", "10",
        "--max_concat_length", "48",
        "--arch_size", "tiny",
        *extra,
    ]


@pytest.fixture(scope="module")
def embedded(chain):
    rows_jax = jax_embed.main(embed_args(chain, "jax_emb") + ["--no_mesh"])
    rows_torch = torch_embed.main(embed_args(chain, "torch_emb") + ["--no_cuda"])
    assert rows_jax == rows_torch == N_PASSAGES
    return chain


def test_embedding_blocks_agree_and_cross_read(embedded):
    jax_blocks = list(jax_iter(str(embedded / "jax_emb")))
    torch_blocks = list(torch_iter(str(embedded / "torch_emb")))
    assert len(jax_blocks) == len(torch_blocks) == 2
    for (bj, ej, ij), (bt, et, it) in zip(jax_blocks, torch_blocks):
        assert bj == bt and et.dtype == np.float32
        np.testing.assert_array_equal(ij, it)  # same rows in the same order
        np.testing.assert_allclose(et, ej, atol=1e-5, rtol=0)
    # each package reads the other's files as written
    for reader, writer_dir, written in (
        (jax_iter, "torch_emb", torch_blocks), (torch_iter, "jax_emb", jax_blocks),
    ):
        for (_b, emb, ids), (_b2, emb2, ids2) in zip(
            reader(str(embedded / writer_dir)), written
        ):
            np.testing.assert_array_equal(emb, emb2)
            np.testing.assert_array_equal(ids, ids2)
    with open(embedded / "torch_emb" / "passage__emb_p__data_obj_0.pb", "rb") as f:
        assert isinstance(pickle.load(f), np.ndarray)


def test_trec_run_byte_identical_and_metrics_equal(embedded):
    means_jax = jax_infer.main(infer_args(embedded, "jax_emb", "jax", "--no_mesh"))
    means_torch = torch_infer.main(infer_args(embedded, "torch_emb", "torch", "--no_cuda"))
    assert (embedded / "torch.trec").read_bytes() == (embedded / "jax.trec").read_bytes()
    assert means_torch == means_jax
    assert "ndcg_cut_3" in means_torch and "recall_10" in means_torch
    om_jax = [json.loads(ln) for ln in open(embedded / "jax.jsonl")]
    om_torch = [json.loads(ln) for ln in open(embedded / "torch.jsonl")]
    assert len(om_torch) == len(om_jax) == 8 * 10
    for a, b in zip(om_torch, om_jax):
        assert {k: v for k, v in a.items() if k != "retrieval_score"} == {
            k: v for k, v in b.items() if k != "retrieval_score"
        }
        # scores sum 32 products of the 1e-5-close embeddings: relative 1e-5
        assert a["retrieval_score"] == pytest.approx(b["retrieval_score"], rel=1e-5)


def test_cross_validate_matches_jax(embedded):
    extra = ["--cross_validate"]
    jax_infer.main(infer_args(embedded, "jax_emb", "jax_cv", *extra, "--no_mesh"))
    torch_infer.main(infer_args(embedded, "jax_emb", "torch_cv", *extra, "--no_cuda"))
    assert (embedded / "torch_cv.trec").read_bytes() == (embedded / "jax_cv.trec").read_bytes()


def test_multi_chunk_chain_matches_jax(chain):
    """FirstP multi-chunk (tiny chunk_len 32: 96-token records are 3 chunks,
    empty ones included): chunk rows share their record's offset and the
    run writer dedups them to the best-ranked pid."""
    def model_type(argv):
        return [("rdot_nll_multi_chunk" if a == "rdot_nll" else a) for a in argv]

    jax_embed.main(model_type(embed_args(chain, "jax_mc")) + ["--no_mesh"])
    torch_embed.main(model_type(embed_args(chain, "torch_mc")) + ["--no_cuda"])
    for (_b, ej, ij), (_b2, et, it) in zip(
        jax_iter(str(chain / "jax_mc")), torch_iter(str(chain / "torch_mc"))
    ):
        assert et.shape[0] == 3 * (N_PASSAGES // 2)  # every chunk is a row
        np.testing.assert_array_equal(ij, it)
        # an all-pad chunk holds identical tokens (pad id, pad position), so
        # the two attention rules agree on its rows as well
        np.testing.assert_allclose(et, ej, atol=1e-5, rtol=0)
    means_jax = jax_infer.main(
        model_type(infer_args(chain, "torch_mc", "jax_mc", "--no_mesh"))
    )
    means_torch = torch_infer.main(
        model_type(infer_args(chain, "torch_mc", "torch_mc", "--no_cuda"))
    )
    assert (chain / "torch_mc.trec").read_bytes() == (chain / "jax_mc.trec").read_bytes()
    assert means_torch == means_jax


def test_drivers_need_a_card_or_no_cuda(chain, monkeypatch):
    # with no CUDA device and without --no_cuda the drivers raise
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no_cuda"):
        torch_embed.main(embed_args(chain, "never"))
    with pytest.raises(RuntimeError, match="no_cuda"):
        torch_infer.main(infer_args(chain, "jax_emb", "never"))


@pytest.mark.parametrize(
    "flags",
    [
        ["--ivf_dir", "x"], ["--pq_dir", "x"], ["--matmul_precision", "default"],
        ["--matmul_precision", "high"], ["--profile_dir", "x"],
    ],
)
def test_unported_inference_options_raise(chain, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_infer.main(infer_args(chain, "jax_emb", "never", "--no_cuda", *flags))


@pytest.mark.parametrize(
    "flags", [["--storage_dtype", "int8"], ["--storage_dtype", "int8", "--rescore_factor", "2"]]
)
def test_int8_inference_options_are_ported(chain, flags):
    # these raised NotImplementedError before SQ8 search was ported
    args = torch_infer.get_arguments(infer_args(chain, "jax_emb", "never", "--no_cuda", *flags))
    torch_infer.check_ported(args)


@pytest.mark.parametrize(
    "flags", [["--storage_dtype", "bfloat16"], ["--block_format", "native"]]
)
def test_unported_embed_options_raise(chain, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_embed.main(embed_args(chain, "never") + ["--no_cuda", *flags])
