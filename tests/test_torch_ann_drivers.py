"""The ANN driver chain of convdr_torch against the JAX package's (CPU).

On the tiny chain of ``tests/test_torch_pipeline.py`` (24 passages, 8
queries): ``build_ivf_index`` of either package builds an index over the
same embedding blocks, and the port's ``run_convdr_inference --ivf_dir`` /
``--pq_dir`` searches it. A full probe (``--nprobe 999``) and a rescore whose
candidates cover the corpus must give the flat f32 run's metrics (the JAX
``tests/test_drivers.py`` contract); on an index saved by the JAX driver the
port's run equals the JAX run (metrics equal, TREC run files equal).
"""

import json

import numpy as np
import pytest

from convdr_torch.drivers import build_ivf_index as torch_build
from convdr_torch.drivers import run_convdr_inference as torch_infer
from convdr_torch.retrieval.blocks import write_embedding_block
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_tpu.drivers import build_ivf_index as jax_build
from convdr_tpu.drivers import run_convdr_inference as jax_infer
from test_torch_pipeline import N_PASSAGES, chain, embedded, infer_args  # noqa: F401


def build_args(chain, name, *extra):
    return ["--ann_data_dir", str(chain / "torch_emb"), "--index_dir", str(chain / name),
            "--kmeans_iters", "8", *extra]


def torch_run(chain, name, *extra):
    return torch_infer.main(infer_args(chain, "torch_emb", name, "--no_cuda", *extra))


@pytest.fixture(scope="module")
def flat(embedded):
    return torch_run(embedded, "flat")


@pytest.mark.parametrize(
    "storage,extra",
    [("float32", []), ("bfloat16", []), ("int8", []), ("pq4", ["--pq_m", "8"]),
     ("pq8", ["--pq_m", "8"]), ("pq4", ["--pq_m", "8", "--pack_codes"])],
)
def test_build_ivf_index_summaries_match_jax(embedded, storage, extra):
    flags = ["--nlist", "4", "--storage_dtype", storage, *extra]
    ann_dir, n = str(embedded / "torch_emb"), N_PASSAGES
    if storage == "pq8":  # 256 centroids a subspace need >= 256 rows
        ann_dir, n = str(embedded / "rows_300"), 300
        rows = np.random.Generator(np.random.PCG64(4)).standard_normal((n, 32), np.float32)
        write_embedding_block(ann_dir, 0, rows, np.arange(n, dtype=np.int64))
    flags += ["--ann_data_dir", ann_dir]
    ours = torch_build.main(build_args(embedded, f"ivf_t_{storage}", *flags, "--no_cuda"))
    theirs = jax_build.main(build_args(embedded, f"ivf_j_{storage}", *flags))
    assert ours.keys() == theirs.keys()
    assert ours["ntotal"] == theirs["ntotal"] == n
    for key in ("index_type", "dim", "storage_dtype", "packed", "assign_n_clusters"):
        assert ours[key] == theirs[key], key
    index = IVFIndex.load(ours["index_dir"], device="cpu")
    assert index.storage_dtype == storage and index.packed == ("--pack_codes" in extra)


def test_ivf_full_probe_equals_flat_run(embedded, flat):
    torch_build.main(build_args(embedded, "ivf", "--nlist", "4", "--no_cuda"))
    full = torch_run(embedded, "ivf_full", "--ivf_dir", str(embedded / "ivf"), "--nprobe", "999")
    assert full == pytest.approx(flat), (full, flat)
    runs = [{ln.split()[0] + ln.split()[2] for ln in open(embedded / f"{n}.trec")}
            for n in ("ivf_full", "flat")]
    assert runs[0] == runs[1]  # the same (query, pid) pairs
    one = torch_run(embedded, "ivf_1", "--ivf_dir", str(embedded / "ivf"), "--nprobe", "1")
    assert "ndcg_cut_3" in one


@pytest.mark.parametrize("kind", ["ivf", "pq"])
def test_jax_built_index_searches_like_the_jax_driver(embedded, kind):
    flags = (["--nlist", "4"] if kind == "ivf"
             else ["--index_type", "pq", "--pq_m", "8", "--pq_nbits", "4"])
    jax_build.main(build_args(embedded, f"jax_{kind}", *flags))
    opt = ["--ivf_dir", str(embedded / f"jax_{kind}"), "--nprobe", "2"] if kind == "ivf" else [
        "--pq_dir", str(embedded / f"jax_{kind}")]
    ours = torch_run(embedded, f"t_on_j_{kind}", *opt)
    theirs = jax_infer.main(infer_args(embedded, "torch_emb", f"j_on_j_{kind}", "--no_mesh", *opt))
    assert ours == pytest.approx(theirs)
    assert ((embedded / f"t_on_j_{kind}.trec").read_text().split()[2::6]
            == (embedded / f"j_on_j_{kind}.trec").read_text().split()[2::6])


def test_pq_rescore_covering_the_corpus_equals_flat_run(embedded, flat):
    summary = torch_build.main(build_args(
        embedded, "pq", "--index_type", "pq", "--pq_m", "8", "--pq_nbits", "4", "--no_cuda"))
    assert summary["code_tensor_bytes"] == N_PASSAGES * 8
    raw = torch_run(embedded, "pq_raw", "--pq_dir", str(embedded / "pq"))
    assert "ndcg_cut_3" in raw
    # rescore_factor * top_n >= N_PASSAGES: the refine ranks the whole corpus
    rescored = torch_run(embedded, "pq_rs", "--pq_dir", str(embedded / "pq"),
                         "--rescore_factor", "3")
    assert rescored == pytest.approx(flat), (rescored, flat)
    # --from_pq_dir promotes the flat PQ index to IVFPQ, codes verbatim
    promoted = torch_build.main(build_args(
        embedded, "ivfpq_promoted", "--nlist", "4", "--from_pq_dir", str(embedded / "pq"),
        "--no_cuda"))
    assert promoted["storage_dtype"] == "pq4" and promoted["ntotal"] == N_PASSAGES


@pytest.mark.parametrize("storage", ["pq4", "int8"])
def test_ivf_rescore_covering_the_corpus_equals_flat_run(embedded, flat, storage, caplog):
    torch_build.main(build_args(embedded, f"ivf_rs_{storage}", "--nlist", "4", "--storage_dtype",
                                storage, "--pq_m", "8", "--no_cuda"))
    rescored = torch_run(embedded, f"ivf_rs_{storage}", "--ivf_dir",
                         str(embedded / f"ivf_rs_{storage}"), "--nprobe", "999",
                         "--rescore_factor", "3")
    assert rescored == pytest.approx(flat), (rescored, flat)
    no_op = "ranking no-op" in caplog.text
    assert no_op == (storage == "int8")


def test_ann_flag_errors(embedded, monkeypatch):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        torch_run(embedded, "never", "--ivf_dir", "a", "--pq_dir", "b")
    with pytest.raises(SystemExit, match="already exact"):
        torch_run(embedded, "never", "--rescore_factor", "2")
    with pytest.raises(SystemExit, match="nbits=4 codes only"):
        torch_build.main(build_args(embedded, "never", "--index_type", "pq", "--pack_codes",
                                    "--no_cuda"))
    with pytest.raises(SystemExit, match="--nlist is required"):
        torch_build.main(build_args(embedded, "never", "--no_cuda"))
    # with no CUDA device and without --no_cuda the build driver raises
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no_cuda"):
        torch_build.main(build_args(embedded, "never", "--nlist", "4"))
    with pytest.raises(RuntimeError, match="no_cuda"):
        torch_infer.main(infer_args(embedded, "torch_emb", "never", "--ivf_dir", "x"))


def test_summary_line_is_json(embedded, capsys):
    summary = torch_build.main(build_args(embedded, "ivf_json", "--nlist", "3", "--no_cuda"))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert np.load(embedded / "ivf_json" / "rowids.npy").dtype == np.int32
