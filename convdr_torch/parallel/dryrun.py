"""Multi-rank runs in one call: spawned ranks, the multi-chip dry run, and
rank programs that run the port's meshed entry points on given inputs.

:func:`spawn` starts ``n`` processes (the ``spawn`` start method, so each
imports only ``convdr_torch`` and what its program needs), forms one
process group over them through a ``file://`` store (gloo on the CPU, NCCL
with one card a rank), runs a program on every rank and fails if any rank
fails or outlives its time limit; :func:`single_rank` forms a group of
the calling process alone. :func:`dryrun_multichip` is the
counterpart of ``__graft_entry__.py::dryrun_multichip``: the same checks on
the same tiny shapes over ``n`` ranks. :func:`run_cases` runs named entry
points (:data:`CASES`) over a mesh of all ranks and saves rank 0's outputs
to one ``.npz``.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import tempfile
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from convdr_torch.parallel.mesh import (
    axis_index,
    axis_size,
    get_mesh,
    init_distributed,
    is_main_rank,
    shard_batch,
    shard_rows,
)

# how long a rank's collective may wait, and a spawned run may last
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
RUN_TIMEOUT_S = 240.0


def _rank_main(rank: int, world: int, store: str, no_cuda: bool, fn: Callable, args) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    init_distributed(no_cuda, init_method=f"file://{store}", timeout=COLLECTIVE_TIMEOUT)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def single_rank(no_cuda: bool = True):
    """A process group of the calling process alone (world size 1: gloo on
    the CPU, or NCCL on the current card), closed on exit; yields this
    rank's device."""
    with tempfile.TemporaryDirectory(prefix="convdr_rank_") as tmp:
        device = init_distributed(
            no_cuda, rank=0, world_size=1,
            local_rank=0 if no_cuda else torch.cuda.current_device(),
            init_method=f"file://{os.path.join(tmp, 'store')}", timeout=COLLECTIVE_TIMEOUT,
        )
        try:
            yield device
        finally:
            dist.destroy_process_group()


def spawn(n_ranks: int, fn: Callable, args: Tuple = (), *, no_cuda: bool = True) -> None:
    """Run ``fn(*args)`` on ``n_ranks`` spawned ranks of one process group
    (``fn`` and ``args`` must pickle; ``fn`` by import path). Raises if a
    rank exits non-zero or the run outlives ``RUN_TIMEOUT_S``; every rank is
    stopped before this returns."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="convdr_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, args=(r, n_ranks, store, no_cuda, fn, args))
            for r in range(n_ranks)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RUN_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if hung:
            raise TimeoutError(f"ranks {hung} of {n_ranks} still ran after {RUN_TIMEOUT_S} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"ranks failed (rank: exit code): {failed}")


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _shard(mesh, axis: str, rows: np.ndarray) -> np.ndarray:
    """This rank's rows of a padded row-sharded matrix (every shard the
    same height; the rows must divide by the axis size)."""
    lo, hi, _ = shard_rows(rows.shape[0], axis_size(mesh, axis), axis_index(mesh, axis))
    return rows[lo:hi]


# ---------------------------------------------------------------------------
# rank programs: each runs one meshed entry point and returns numpy outputs
# ---------------------------------------------------------------------------
def flat_case(queries, passages, k, *, storage="float32", valid_rows=-1, block_rows=65536,
              precision="highest"):
    """``sharded_flat_ip_topk`` over ``passages`` [S * rows, D] (f32, or
    int8 with int-valued queries; ``storage="bfloat16"`` casts the f32
    rows) at the matmul ``precision``."""
    from convdr_torch.parallel.sharded_search import sharded_flat_ip_topk

    mesh, device = get_mesh(("index",)), _device()
    p = torch.from_numpy(np.ascontiguousarray(_shard(mesh, "index", passages))).to(device)
    if storage == "bfloat16":
        p = p.to(torch.bfloat16)
    s, i = sharded_flat_ip_topk(mesh, torch.from_numpy(queries).to(device), p, k,
                                valid_rows=valid_rows, block_rows=block_rows,
                                precision=precision)
    return {"scores": s.cpu().numpy(), "ids": i.cpu().numpy()}


def pq_case(lut, codes, k, ksub, *, packed=False, valid_rows=-1, block_rows=1 << 18):
    """``sharded_pq_topk`` over ``codes`` [S * rows, M] (M/2 packed)."""
    from convdr_torch.parallel.sharded_search import sharded_pq_topk

    mesh, device = get_mesh(("index",)), _device()
    c = torch.from_numpy(np.ascontiguousarray(_shard(mesh, "index", codes))).to(device)
    s, i = sharded_pq_topk(mesh, torch.from_numpy(lut).to(device), c, k, ksub,
                           valid_rows=valid_rows, block_rows=block_rows, packed=packed)
    return {"scores": s.cpu().numpy(), "ids": i.cpu().numpy()}


def ivf_index_case(index_dir, queries, k, nprobe):
    """``IVFIndex.search(mesh=)`` of a saved index."""
    from convdr_torch.retrieval.ivf import IVFIndex

    index = IVFIndex.load(index_dir, device=_device())
    s, i = index.search(queries, k, nprobe=nprobe, mesh=get_mesh(("index",)))
    return {"scores": s, "ids": i}


def pq_index_case(index_dir, queries, k):
    """``PQIndex.search(mesh=)`` of a saved index."""
    from convdr_torch.retrieval.pq_index import PQIndex

    s, i = PQIndex.load(index_dir, device=_device()).search(queries, k, mesh=get_mesh(("index",)))
    return {"scores": s, "ids": i}


def blocks_case(block_dir, queries, k, *, storage="float32", rescore_factor=0,
                precision="highest"):
    """``BlockedSearcher(mesh=).search_blocks`` over a block directory."""
    from convdr_torch.core.config import SearchConfig
    from convdr_torch.retrieval.searcher import BlockedSearcher

    searcher = BlockedSearcher(
        SearchConfig(storage_dtype=storage, rescore_factor=rescore_factor,
                     matmul_precision=precision),
        device=_device(), mesh=get_mesh(("index",)),
    )
    s, o = searcher.search_blocks(block_dir, queries, k)
    return {"scores": s, "offsets": o}


def _build(model_config, state_dict):
    from convdr_torch.models.encoders import build_model

    model = build_model(model_config)
    model.load_state_dict(state_dict)
    return model.to(_device())


def train_case(model_config, student_state, teacher_state, train_config, batches):
    """Data-parallel KD + ranking steps (``make_train_step(mesh=)``) over
    the global ``batches``, each rank its slice: each step's metrics, and
    the first step's gradients as ``grad.<name>``."""
    from convdr_torch.train.trainer import create_train_state, make_train_step

    mesh, device = get_mesh(("data",)), _device()
    student = _build(model_config, student_state)
    teacher = _build(model_config, teacher_state)
    state, tx = create_train_state(student, train_config, 10)
    step = make_train_step(student, teacher, tx, train_config, mesh=mesh)
    out: Dict[str, np.ndarray] = {}
    for n, batch in enumerate(batches):
        local = shard_batch(mesh, {k: torch.from_numpy(v) for k, v in batch.items()})
        state, metrics = step(state, {k: v.to(device) for k, v in local.items()})
        for key, v in metrics.items():
            out.setdefault(key, []).append(float(v))
        if n == 0:
            out.update({f"grad.{name}": p.grad.cpu().numpy()
                        for name, p in student.named_parameters()})
    return {k: np.asarray(v) for k, v in out.items()}


def encode_case(model_config, state_dict, cache_dir, out_dir, batch_size, *,
                length_buckets=None, storage_dtype="float32"):
    """``generate_embeddings(mesh=)``: rank 0 writes the blocks to ``out_dir``."""
    from convdr_torch.core.loading import make_apply_fn
    from convdr_torch.data.token_cache import TokenCache
    from convdr_torch.retrieval.embed_corpus import generate_embeddings

    rows = generate_embeddings(
        make_apply_fn(_build(model_config, state_dict)), TokenCache(cache_dir), out_dir,
        device=_device(), batch_size=batch_size, mesh=get_mesh(("data",)),
        length_buckets=length_buckets, storage_dtype=storage_dtype,
    )
    return {"rows": np.asarray(rows)}


def driver_case(module: str, argv):
    """A driver's ``main(argv)`` under the rank's torchrun-like environment
    (it forms its mesh over the group)."""
    import importlib

    result = importlib.import_module(f"convdr_torch.drivers.{module}").main(list(argv))
    return {f"metric.{k}": np.asarray(v) for k, v in result.items()
            if isinstance(v, (int, float))} if isinstance(result, dict) else {}


CASES: Dict[str, Callable] = {
    "flat": flat_case, "pq": pq_case, "ivf_index": ivf_index_case,
    "pq_index": pq_index_case, "blocks": blocks_case, "train": train_case,
    "encode": encode_case, "driver": driver_case,
}


def run_cases(cases: Dict[str, Tuple[str, dict]], out_path: str) -> None:
    """Rank program: run each named case, ``(entry of CASES, keyword
    arguments)``, and on rank 0 save every output as ``<case>.<key>`` into
    the npz ``out_path``."""
    out = {}
    for name, (entry, kwargs) in cases.items():
        for key, value in CASES[entry](**kwargs).items():
            out[f"{name}.{key}"] = value
    if dist.get_rank() == 0:
        np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the multi-chip dry run
# ---------------------------------------------------------------------------
def _dryrun_rank(n_devices: int) -> None:
    from convdr_torch.core.config import EncoderArchConfig, ModelConfig, TrainConfig
    from convdr_torch.core.loading import init_weights
    from convdr_torch.models.encoders import build_model
    from convdr_torch.ops.pq import PQCodec, pack_codes_4bit
    from convdr_torch.parallel.sharded_search import sharded_flat_ip_topk, sharded_pq_topk
    from convdr_torch.retrieval.blocks import write_embedding_block
    from convdr_torch.retrieval.ivf import IVFIndex
    from convdr_torch.retrieval.refine import RefineStore
    from convdr_torch.train.trainer import create_train_state, make_train_step

    device = _device()
    rng = np.random.RandomState(0)

    # ---- full training step, batch sharded over the 'data' axis ----
    mesh = get_mesh(("data",))
    cfg = ModelConfig(name="rdot_nll", arch=EncoderArchConfig.tiny(vocab_size=64),
                      embedding_dim=16)
    batch, seq, k = 2 * n_devices, 16, 3
    ids = rng.randint(4, 60, size=(batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    student = init_weights(build_model(cfg), seed=0).to(device)
    teacher = init_weights(build_model(cfg), seed=1).to(device)
    tcfg = TrainConfig(ranking_task=True, num_negatives=k - 1)
    state, tx = create_train_state(student, tcfg, total_steps=10)
    step = make_train_step(student, teacher, tx, tcfg, mesh=mesh)
    train_batch = {
        "concat_ids": ids, "concat_mask": mask, "target_ids": ids, "target_mask": mask,
        "doc_ids": rng.randint(4, 60, size=(batch, k, seq)).astype(np.int32),
        "doc_mask": np.ones((batch, k, seq), np.int32),
    }
    local = shard_batch(mesh, {n: torch.from_numpy(v) for n, v in train_batch.items()})
    state, metrics = step(state, {n: v.to(device) for n, v in local.items()})
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"dry-run train step loss {float(metrics['loss'])}")

    # ---- sharded exact retrieval over the 'index' axis ----
    mesh_idx = get_mesh(("index",))
    n_rows = 64 * n_devices
    passages = rng.randn(n_rows, 16).astype(np.float32)
    queries = rng.randn(4, 16).astype(np.float32)
    q = torch.from_numpy(queries).to(device)
    p_shard = torch.from_numpy(_shard(mesh_idx, "index", passages)).to(device)
    s, i = sharded_flat_ip_topk(mesh_idx, q, p_shard, 10, block_rows=64)
    if s.shape != (4, 10) or int(i.min()) < 0:
        raise AssertionError(f"sharded search: {tuple(s.shape)}, min id {int(i.min())}")

    # ---- sharded packed-pq4 ADC retrieval over the same axis ----
    codec = PQCodec.fit(passages, m=4, nbits=4, iters=3, seed=0, device=device)
    codes = pack_codes_4bit(codec.encode(passages, device=device))
    lut = torch.from_numpy(codec.lut(queries)).to(device)
    c_shard = torch.from_numpy(np.ascontiguousarray(_shard(mesh_idx, "index", codes))).to(device)
    s_pq, i_pq = sharded_pq_topk(mesh_idx, lut, c_shard, 10, codec.ksub, block_rows=64,
                                 packed=True)
    if s_pq.shape != (4, 10) or int(i_pq.min()) < 0:
        raise AssertionError("sharded packed-pq4 search returned short lists")

    # ---- sharded IVF probing (balanced per-shard allocation): full probe
    # must give the flat result sets ----
    ivf = IVFIndex.build(passages, 8, iters=3, seed=0, device=device)
    _, i_ivf = ivf.search(queries, 10, nprobe=ivf.nlist, mesh=mesh_idx)
    i_flat = i.cpu().numpy()
    for r in range(i_ivf.shape[0]):
        if set(i_ivf[r].tolist()) != set(i_flat[r].tolist()):
            raise AssertionError("sharded IVF full probe diverged from the flat result")

    # ---- candidate-proportional refine smoke, on the main rank ----
    if is_main_rank(mesh_idx):
        with tempfile.TemporaryDirectory() as tmp:
            write_embedding_block(tmp, 0, passages, np.arange(n_rows, dtype=np.int64))
            store = RefineStore.open(tmp, passages.shape[1])
            _r_s, r_i = store.refine_by_value(queries, np.asarray(i_ivf, np.int64), 10)
            for r in range(r_i.shape[0]):
                if set(r_i[r].tolist()) != set(i_flat[r].tolist()):
                    raise AssertionError("refine re-ranking changed the full-probe result set")
        print(
            f"dryrun_multichip({n_devices}): train step loss="
            f"{float(metrics['loss']):.4f}, sharded search ok, "
            f"sharded packed-pq4 search ok, sharded IVF probe ok, "
            f"refine smoke ok",
            flush=True,
        )


def dryrun_multichip(n_devices: int, no_cuda: bool = True) -> None:
    """The JAX package's multi-chip dry run over ``n_devices`` spawned
    ranks: a data-parallel KD + ranking step (AdamW), the sharded exact
    search, the sharded packed-pq4 search, the sharded IVF at full probe
    (its sets equal to the flat result) and the refine smoke. Rank 0
    prints the JAX dry run's one-line summary; a failed check fails it."""
    spawn(n_devices, _dryrun_rank, (n_devices,), no_cuda=no_cuda)
