"""Online serving: conversation text -> top-N through one captured CUDA graph.

The counterpart of ``convdr_tpu/retrieval/online.py``. A deployed
conversational system serves one turn at a time, with the model and the
index resident on the device. The JAX package fuses the whole request into
one jitted program so that a turn costs one dispatch:

    token ids -> encoder forward -> [Q, D] embedding -> query-side prep
    (the SQ8 fold or the ADC tables) -> resident-index search -> (scores, rows)

Here that program is a ``torch.cuda.CUDAGraph`` keyed by (Q, capacity),
captured by :meth:`OnlineSearcher.warmup` or at the first call that needs
it (the JAX program compiles once per distinct Q). A call whose rows are
all ConvDR's prefix layout (a run of valid tokens from position 0) and
whose valid tokens, rounded up to ``PACK_STEP``, number fewer than Q * T
packs: the host builds the index of its valid tokens (:func:`fill_packing`)
and the encoder's per-token layers run on those rows alone
(:class:`~convdr_torch.models.transformer.Packing`). It replays the
smallest packed graph of its Q whose capacity holds its tokens, captured at
its own capacity where none does; every other call (a Q=1 turn always)
replays the padded graph of its Q (capacity None). The graphs of one Q
share one memory pool, which is safe because replays are serialized and
each one's outputs are read back before the next. A call copies its ids,
mask and any token index into the graph's static inputs through pinned
host buffers, replays the graph, copies the results back and waits once;
rows map to token-cache offsets on the host. The graph launches the
port's kernels as the eager program does (the attention forward in every
layer; on the flat backends the score kernel and the group gather), so a
replay's results equal the eager program's on the same inputs and packing
bit for bit. On the card there is no eager fallback: a capture or a replay
that fails raises. CPU tensors (``device="cpu"``, the tests) run the same
program eagerly, packed by the same rule, through the kernels' plain
versions.

Backends (the offline search family's):

  * flat float32 / bfloat16: :func:`~convdr_torch.ops.exact_search.
    flat_ip_topk` over the resident corpus, f32 accumulation, no TF32;
  * flat int8 (SQ8): the passage scales fold into the query on the device
    (:func:`_fold_int8_queries`, bit-identical to ``quantize_queries``),
    then the integer-exact scan;
  * IVF (f32 / bf16 / int8 lists) and IVFPQ (packed or not): the probe of
    :func:`~convdr_torch.retrieval.ivf._ivf_search_dev`, with the SQ8 fold
    or the OPQ rotation and the ADC tables (f32, TF32 off) computed on the
    device; the offline path computes those tables on the host, so the two
    agree on result sets, not always on the order of near-ties.

Spans (recorded only while a ``torch.profiler`` runs): ``convdr.serve.turn``
covers a whole :meth:`OnlineSearcher.search_tokens`; a replay's
``convdr.serve.copy_in`` (the pinned fills and the copies' enqueue),
``convdr.serve.replay`` (``graph.replay()``) and ``convdr.serve.wait``
(the copy-back's enqueue, the event wait, the numpy copies) sit inside it.

Launch counts: the kernels' wrappers count a launch when they issue one,
which under a capture records it into the graph. Each graph keeps the
counts its capture recorded, and :meth:`OnlineSearcher.replayed_launches`
multiplies them by the graph's replays. :meth:`OnlineSearcher.
packing_stats` counts the calls that packed and the share of their
graphs' capacity that valid tokens filled.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from convdr_torch.core.device import pick_device
from convdr_torch.core.loading import load_model_and_params, make_apply_fn
from convdr_torch.data.conv_dataset import _concat_conversation_ids
from convdr_torch.data.padding import pad_input_ids_with_mask
from convdr_torch.models.attention import flash_attention
from convdr_torch.models.transformer import Packing
from convdr_torch.ops.exact_search import NEG_INF, flat_ip_topk
from convdr_torch.ops.fused_search import ROW_TILE, fused_scores_groupmax
from convdr_torch.ops.gather_groups import dma_gather_groups
from convdr_torch.utils.observability import span

logger = logging.getLogger(__name__)

# the kernels a serving program can launch, by the name chip_smoke reports
COUNTED_KERNELS = {
    "flash_attention_fwd": flash_attention,
    "fused_scores_groupmax": fused_scores_groupmax,
    "dma_gather_groups": dma_gather_groups,
}


def _launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in COUNTED_KERNELS.items()}


def capture(fn: Callable, device: torch.device, pool=None):
    """Capture ``fn()`` into a new CUDA graph. One eager run on a side
    stream first builds and binds the kernels and warms cuBLAS, as a
    capture needs; then the capture records every launch into the graph,
    which draws its intermediates from its own memory pool, or from
    ``pool`` (another graph's ``graph.pool()``), which the two then share:
    such graphs must not replay concurrently, and each one's outputs must
    be read before another replays. -> (graph, ``fn``'s outputs in that
    pool, the counted kernels' launches the graph records, the bytes the
    capture reserved)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    # the capture empties the allocator's cache itself; emptied first,
    # the reserved bytes grow by the graph's private pool alone
    torch.cuda.empty_cache()
    before = _launch_counts()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    after = _launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    return graph, out, launches, torch.cuda.memory_reserved(device) - reserved


def history_to_inputs(
    tokenizer,
    history: Sequence[str],
    *,
    model_type: str = "rdot_nll",
    max_concat_length: int = 256,
    response_text: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One conversation history -> padded (ids [1, L], mask [1, L]) int32.

    ``history`` is the session's utterances with the current question
    last, the ``input`` field of a topics record, so the ids equal
    ConvSearchDataset's inference mode token for token. ``response_text``
    injects a ``<response>`` passage before the current question (man_can /
    auto_can serving); ``history`` must not already hold it.
    """
    if not history:
        raise ValueError("history must contain at least the current question")
    raw_ids = _concat_conversation_ids(
        tokenizer,
        list(history),
        is_bert_style=(model_type == "dpr"),
        response_text=response_text,
    )
    ids, mask = pad_input_ids_with_mask(raw_ids, max_concat_length)
    return np.asarray([ids], np.int32), np.asarray([mask], np.int32)


def _fold_int8_queries(q: torch.Tensor, scales: torch.Tensor):
    """The device twin of ``ops/quant.py::quantize_queries``: fold the
    passage scales into the queries and quantize each row by its own
    scalar, with the same f32 IEEE divide, round half to even and clip, so
    the int-valued rows and the score scales are bit-identical to the
    host's. -> (int-valued f32 [Q, D], scale [Q, 1])."""
    qf = q.float() * scales[None, :]
    amax = qf.abs().amax(dim=1, keepdim=True)
    # a divisor tensor: divided by a Python scalar, a CUDA tensor is
    # multiplied by the scalar's reciprocal, which can differ in the last bit
    t = amax / torch.full_like(amax, 127.0)
    t = torch.where(t > 0, t, torch.ones_like(t))
    q_int = torch.round(qf / t).clamp_(-127, 127)
    return q_int, t


# a packed call's capacity: its valid tokens rounded up to a multiple of this
PACK_STEP = 4096


def packed_capacity(mask: np.ndarray) -> Optional[int]:
    """The capacity a call's valid tokens pack into, or None where the call
    keeps the padded program: the valid count rounded up to ``PACK_STEP``
    must be below Q * T (so a Q=1 turn never packs), and every row must be
    ConvDR's prefix layout, a run of at least one valid token from position
    0 and pads after it, as ``pad_input_ids_with_mask`` and a cut from the
    front make."""
    q, t = mask.shape
    lengths = mask.sum(axis=1)
    capacity = -(-int(lengths.sum()) // PACK_STEP) * PACK_STEP
    if capacity >= q * t or lengths.min() < 1:
        return None
    if not np.array_equal(mask, np.arange(t)[None, :] < lengths[:, None]):
        return None
    return capacity


def fill_packing(mask: np.ndarray, index: np.ndarray, first: np.ndarray) -> int:
    """Write a prefix-layout call's token index: ``index`` (int64
    [capacity]) gets the flat positions ``b * T + t`` of its valid tokens,
    then the sentinel Q * T to the end; ``first`` (int64 [Q]) each row's
    first token among them. -> the number of valid tokens."""
    q, t = mask.shape
    valid = np.flatnonzero(mask)
    index[: len(valid)] = valid
    index[len(valid):] = q * t
    first[0] = 0
    np.cumsum(mask[:-1].sum(axis=1), out=first[1:])
    return len(valid)


@dataclass
class PackingStats:
    """Serving calls by encoder path: every call, the packed ones, and the
    valid tokens the packed ones carried against the capacity they ran."""

    calls: int = 0
    packed_calls: int = 0
    packed_tokens: int = 0
    packed_capacity: int = 0

    def record(self, capacity: Optional[int], valid: int) -> None:
        self.calls += 1
        if capacity is not None:
            self.packed_calls += 1
            self.packed_tokens += valid
            self.packed_capacity += capacity

    def summary(self) -> dict:
        """Counts, the share of calls packed and the share of the packed
        calls' capacity that valid tokens filled (None before any)."""
        return {
            "calls": self.calls,
            "packed_calls": self.packed_calls,
            "packed_call_share": self.packed_calls / self.calls if self.calls else None,
            "token_share": (self.packed_tokens / self.packed_capacity
                            if self.packed_capacity else None),
        }


@dataclass
class ServeStats:
    """Wall-clock latencies (seconds) of completed ``search`` calls."""

    latencies: List[float]

    def percentile(self, p: float) -> float:
        if not self.latencies:
            raise ValueError("no completed search calls recorded yet")
        return float(np.percentile(np.asarray(self.latencies), p))

    def summary(self) -> dict:
        if not self.latencies:
            return {"count": 0}
        lat = np.asarray(self.latencies)
        return {
            "count": int(lat.shape[0]),
            "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p90_ms": round(float(np.percentile(lat, 90)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "mean_ms": round(float(lat.mean()) * 1e3, 3),
        }


@dataclass
class ServeGraph:
    """One captured serving program for one Q and capacity: its static
    inputs and outputs on the card, pinned host buffers for the copies, and
    what its capture recorded. A packed graph (``capacity`` tokens) also
    takes the call's token index and first rows; a padded one has capacity
    None and no index."""

    graph: torch.cuda.CUDAGraph
    ids: torch.Tensor
    mask: torch.Tensor
    scores: torch.Tensor
    rows: torch.Tensor
    host_ids: torch.Tensor
    host_mask: torch.Tensor
    host_scores: torch.Tensor
    host_rows: torch.Tensor
    done: torch.cuda.Event
    capture_s: float
    pool_bytes: int
    launches: Dict[str, int]
    capacity: Optional[int] = None
    packing: Optional[Packing] = None
    host_index: Optional[torch.Tensor] = None
    host_first: Optional[torch.Tensor] = None
    replays: int = 0


def _load_model(model_type, model_path, device, dtype, arch_preset, max_concat_length):
    """(tokenizer, model on ``device``, concat length clamped to what the
    position embeddings hold)."""
    _cfg, tokenizer, model = load_model_and_params(
        model_type, model_path, device=device, dtype=dtype, arch_preset=arch_preset
    )
    return tokenizer, model, min(max_concat_length, tokenizer.max_len_single_sentence)


class OnlineSearcher:
    """text / tokens -> top-N through one resident serving program.

    Build with :meth:`from_blocks` (a flat resident corpus) or
    :meth:`from_ivf` (a resident ANN index). Per request call :meth:`search`
    (history text) or :meth:`search_tokens` (ids and mask, e.g. from
    ConvSearchDataset). Results are (scores [Q, k] f32 desc, ids [Q, k]):
    token-cache offsets (flat blocks map their rows through emb2offset; IVF
    rowids are offsets already).

    :meth:`encode` (ids, mask -> f32 [Q, D]) and ``search_embeddings``
    ([Q, D] -> device scores and rows) are the two halves of the program on
    the device; :meth:`program` runs both eagerly (the witness a replay is
    held to), :meth:`search_tokens` serves through the captured graph on the
    card.

    A graph's static inputs, outputs and pinned buffers are shared by every
    call it serves, and the graphs of one Q share a memory pool, so a lock
    serializes the card's turns: calls from several threads are correct,
    and served one at a time.
    """

    def __init__(
        self,
        *,
        tokenizer,
        model: torch.nn.Module,
        search_embeddings: Callable,
        operands: Tuple,
        top_n: int,
        model_type: str,
        max_concat_length: int,
        device: torch.device,
        rowid_to_offset: Optional[np.ndarray] = None,
    ):
        self.tokenizer = tokenizer
        self.model = model
        self._apply = make_apply_fn(model)
        self.search_embeddings = search_embeddings
        self._operands = operands
        self.top_n = top_n
        self.model_type = model_type
        self.max_concat_length = max_concat_length
        self.device = device
        self._rowid_to_offset = rowid_to_offset
        self.graphs: Dict[Tuple[int, Optional[int]], ServeGraph] = {}
        self._pools: Dict[int, object] = {}
        self._lock = threading.Lock()
        self.stats = ServeStats([])
        self.packing = PackingStats()

    @property
    def resident_bytes(self) -> int:
        """Bytes of the index operands resident on the device."""
        return sum(t.numel() * t.element_size() for t in self._operands if t is not None)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_blocks(
        cls,
        model_path: Optional[str],
        ann_data_dir: str,
        *,
        model_type: str = "rdot_nll",
        top_n: int = 100,
        max_concat_length: int = 256,
        storage_dtype: str = "float32",
        precision: str = "highest",
        block_rows: int = 524288,
        dtype: torch.dtype = torch.float32,
        arch_preset: Optional[str] = None,
        max_blocks: Optional[int] = None,
        device=None,
    ) -> "OnlineSearcher":
        """Resident flat search over every block under ``ann_data_dir``.

        Blocks upload one at a time in ``storage_dtype`` and are joined on
        the device into one corpus, its rows padded to the score kernel's
        tile, so the device's peak is about twice the resident corpus (the
        uploaded blocks beside the joined copy), plus one float block while
        it is SQ8-quantized on the device under ``storage_dtype='int8'``
        (bit-identical to the host quantizer). Without an
        ``int8_scales.npy`` sidecar, float blocks fit their scales on
        block 0 (with a warning) and int8 blocks raise; int8 blocks under a
        float config are dequantized through the sidecar.
        """
        from convdr_torch.ops.quant import Int8Quantizer, quantize_passages_dev
        from convdr_torch.retrieval.blocks import iter_embedding_blocks
        from convdr_torch.utils.transfer import device_put_chunked

        if storage_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unknown storage_dtype {storage_dtype!r}")
        device = pick_device(device)
        tokenizer, model, max_concat_length = _load_model(
            model_type, model_path, device, dtype, arch_preset, max_concat_length)

        int8 = storage_dtype == "int8"
        target = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}[storage_dtype]
        quantizer = Int8Quantizer.load_optional(ann_data_dir)
        devs, offs = [], []
        for _b, emb, emb2offset in iter_embedding_blocks(ann_data_dir, max_blocks=max_blocks):
            offs.append(np.asarray(emb2offset, np.int64))
            if emb.shape[0] == 0:
                continue
            if emb.dtype == np.int8 and quantizer is None:
                raise FileNotFoundError(
                    f"int8 blocks in {ann_data_dir} have no int8_scales.npy sidecar"
                )
            if int8 and emb.dtype != np.int8:
                if quantizer is None:
                    # block 0 only: the sample the offline searcher fits
                    # on, so rankings match it
                    logger.warning("no int8_scales.npy in %s; fitting scales on block 0",
                                   ann_data_dir)
                    quantizer = Int8Quantizer.fit(emb)
                p_float = device_put_chunked(emb, device=device)
                scales = torch.from_numpy(quantizer.scales).to(device)
                devs.append(quantize_passages_dev(p_float, scales))
                del p_float
            elif not int8 and emb.dtype == np.int8:
                # SQ8 rows under a float config: a plain cast would drop
                # the per-dimension scales
                deq = emb.astype(np.float32) * quantizer.scales[None, :]
                devs.append(device_put_chunked(deq, target, device=device))
                del deq
            else:
                devs.append(device_put_chunked(emb, target, device=device))
        if not offs:
            raise FileNotFoundError(f"No embedding blocks in {ann_data_dir}")
        rowid_to_offset = np.concatenate(offs)
        n = sum(int(x.shape[0]) for x in devs)
        dim = devs[0].shape[1] if devs else 1
        corpus = torch.empty((-(-n // ROW_TILE) * ROW_TILE, dim), dtype=target, device=device)
        corpus[n:].zero_()
        lo = 0
        for x in devs:
            corpus[lo : lo + x.shape[0]].copy_(x)
            lo += x.shape[0]
        del devs
        scales_dev = torch.from_numpy(quantizer.scales).to(device) if int8 else None
        eff_block_rows = max(1, min(block_rows, corpus.shape[0]))

        @torch.inference_mode()
        def search_embeddings(q):
            if int8:
                q_int, t = _fold_int8_queries(q, scales_dev)
                s, i = flat_ip_topk(q_int, corpus, top_n, block_rows=eff_block_rows,
                                    valid_rows=n)
                return torch.where(i >= 0, s * t, NEG_INF), i
            return flat_ip_topk(q, corpus, top_n, block_rows=eff_block_rows, valid_rows=n,
                                precision=precision)

        return cls(
            tokenizer=tokenizer, model=model, search_embeddings=search_embeddings,
            operands=(corpus, scales_dev),
            top_n=top_n, model_type=model_type, max_concat_length=max_concat_length,
            device=device, rowid_to_offset=rowid_to_offset,
        )

    @classmethod
    def from_ivf(
        cls,
        model_path: Optional[str],
        ivf_dir: str,
        *,
        model_type: str = "rdot_nll",
        top_n: int = 100,
        nprobe: int = 8,
        max_concat_length: int = 256,
        dtype: torch.dtype = torch.float32,
        arch_preset: Optional[str] = None,
        device=None,
    ) -> "OnlineSearcher":
        """Resident ANN probe over a saved IVF / IVFPQ index.

        The index uploads once; ``nprobe`` is clamped to its sub-lists. The
        query-side prep runs inside the program: the SQ8 fold (int8 lists),
        or the OPQ rotation and the ADC tables in f32 with TF32 off (PQ
        lists). The probe's gathered candidates stay under
        ``IVFIndex.search``'s default budget. Returned ids are the index's
        rowids (emb2offset values).
        """
        from convdr_torch.retrieval.ivf import MAX_CANDIDATE_BYTES, IVFIndex, _ivf_search_dev

        device = pick_device(device)
        tokenizer, model, max_concat_length = _load_model(
            model_type, model_path, device, dtype, arch_preset, max_concat_length)

        index = IVFIndex.load(ivf_dir, device=device)
        cent, lists_dev, rid_dev = index._device_arrays()
        nprobe = max(1, min(nprobe, index.nlist))
        packed = index.packed
        scales_dev = rot_dev = books_dev = None
        if index.storage_dtype == "int8":
            scales_dev = torch.from_numpy(index.quantizer.scales).to(device)
        elif index.codec is not None:
            codec = index.codec
            if codec.rotation is not None:
                rot_dev = torch.from_numpy(np.asarray(codec.rotation, np.float32)).to(device)
            books_dev = torch.from_numpy(np.asarray(codec.codebooks, np.float32)).to(device)
            m, dsub = codec.m, codec.dsub

        @torch.inference_mode()
        def search_embeddings(q):
            t = None
            if scales_dev is not None:
                q_score, t = _fold_int8_queries(q, scales_dev)
            elif books_dev is not None:
                # orthogonal OPQ rotation: <xR, qR> == <x, q>
                qr = q @ rot_dev if rot_dev is not None else q
                # per-query ADC tables [Q, M, K] (host twin: PQCodec.lut)
                q_score = torch.einsum("qmd,mkd->qmk", qr.reshape(q.shape[0], m, dsub),
                                       books_dev)
            else:
                q_score = q
            s, i = _ivf_search_dev(q, q_score, cent, lists_dev, rid_dev, top_n, nprobe,
                                   packed=packed, max_candidate_bytes=MAX_CANDIDATE_BYTES)
            if t is not None:
                s = torch.where(i >= 0, s * t, NEG_INF)
            return s, i

        return cls(
            tokenizer=tokenizer, model=model, search_embeddings=search_embeddings,
            operands=(cent, lists_dev, rid_dev, scales_dev, rot_dev, books_dev),
            top_n=top_n, model_type=model_type, max_concat_length=max_concat_length,
            device=device, rowid_to_offset=None,  # IVF rowids are offsets
        )

    # -- the program --------------------------------------------------------
    def encode(self, ids: torch.Tensor, mask: torch.Tensor,
               packing: Optional[Packing] = None) -> torch.Tensor:
        """Query embeddings [Q, D] f32 of device ids and mask; under a
        ``packing`` of the mask's valid tokens the encoder's per-token
        layers run on the packed rows alone."""
        if packing is None:
            return self._apply(ids, mask, True).float()
        with torch.inference_mode():
            return self.model.query_emb(ids, mask, packing=packing).float()

    def program(self, ids: torch.Tensor, mask: torch.Tensor,
                packing: Optional[Packing] = None):
        """The serving program, run eagerly on device tensors: encode, the
        query-side prep and the search -> (scores [Q, k] f32, rows [Q, k])."""
        return self.search_embeddings(self.encode(ids, mask, packing))

    def _graph(self, q: int, capacity: Optional[int]) -> ServeGraph:
        """The graph a call of ``q`` rows replays: the padded one (capacity
        None), or the smallest packed one whose capacity holds ``capacity``
        tokens; captured where there is none."""
        if capacity is None:
            return self.graphs.get((q, None)) or self._capture(q, None)
        fits = [c for gq, c in self.graphs if gq == q and c is not None and c >= capacity]
        return self.graphs[(q, min(fits))] if fits else self._capture(q, capacity)

    def _capture(self, q: int, capacity: Optional[int]) -> ServeGraph:
        """Capture the program for ``q`` queries (:func:`capture`), padded
        or packed into ``capacity`` rows, on static inputs that each replay
        refills, in the memory pool of the graphs of ``q``."""
        dev = self.device
        shape = (q, self.max_concat_length)
        ids = torch.zeros(shape, dtype=torch.int32, device=dev)
        mask = torch.zeros(shape, dtype=torch.int32, device=dev)
        ids[:, 0] = self.tokenizer.cls_token_id
        mask[:, 0] = 1
        packing = None
        if capacity is not None:
            index = torch.full((capacity,), ids.numel(), dtype=torch.int64, device=dev)
            first = torch.arange(q, dtype=torch.int64, device=dev)
            index[:q] = first * shape[1]
            packing = Packing(index, first)
        t0 = time.perf_counter()
        graph, (scores, rows), launches, pool_bytes = capture(
            lambda: self.program(ids, mask, packing), dev, self._pools.get(q))
        self._pools.setdefault(q, graph.pool())

        def pinned(t):
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

        entry = ServeGraph(
            graph=graph, ids=ids, mask=mask, scores=scores, rows=rows,
            host_ids=pinned(ids), host_mask=pinned(mask), host_scores=pinned(scores),
            host_rows=pinned(rows), done=torch.cuda.Event(),
            capture_s=time.perf_counter() - t0, pool_bytes=pool_bytes,
            launches=launches, capacity=capacity, packing=packing,
        )
        if packing is not None:
            entry.host_index, entry.host_first = pinned(packing.index), pinned(packing.first)
        self.graphs[(q, capacity)] = entry
        logger.info("captured the serving program for Q=%d, capacity %s in %.2f s (graph "
                    "pool grew %.1f MiB, launches a replay %s)", q, capacity, entry.capture_s,
                    pool_bytes / 2 ** 20, entry.launches)
        return entry

    def _replay(self, ids: np.ndarray, mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Copy in, replay, copy back, wait once (the turn's only host
        sync), all under the lock that keeps the graphs' buffers and pool
        one turn's."""
        capacity = packed_capacity(mask)
        with self._lock:
            g = self._graph(ids.shape[0], capacity)
            with span("convdr.serve.copy_in"):
                g.host_ids.copy_(torch.from_numpy(ids))
                g.host_mask.copy_(torch.from_numpy(mask))
                g.ids.copy_(g.host_ids, non_blocking=True)
                g.mask.copy_(g.host_mask, non_blocking=True)
                valid = 0
                if g.packing is not None:
                    valid = fill_packing(mask, g.host_index.numpy(), g.host_first.numpy())
                    g.packing.index.copy_(g.host_index, non_blocking=True)
                    g.packing.first.copy_(g.host_first, non_blocking=True)
            self.packing.record(g.capacity, valid)
            with span("convdr.serve.replay"):
                g.graph.replay()
            with span("convdr.serve.wait"):
                g.host_scores.copy_(g.scores, non_blocking=True)
                g.host_rows.copy_(g.rows, non_blocking=True)
                g.done.record()
                g.done.synchronize()
                g.replays += 1
                return g.host_scores.numpy().copy(), g.host_rows.numpy().copy()

    def _eager(self, ids: np.ndarray, mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The program run eagerly (CPU tensors), packed by the replay's
        rule at the call's own capacity."""
        dev = self.device
        capacity = packed_capacity(mask)
        packing, valid = None, 0
        if capacity is not None:
            index, first = np.empty(capacity, np.int64), np.empty(len(mask), np.int64)
            valid = fill_packing(mask, index, first)
            packing = Packing(torch.from_numpy(index).to(dev), torch.from_numpy(first).to(dev))
        with self._lock:
            self.packing.record(capacity, valid)
        s, i = self.program(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                            packing)
        return s.cpu().numpy(), i.cpu().numpy()

    def rows_to_offsets(self, rows: np.ndarray) -> np.ndarray:
        """Device rows of the search -> token-cache offsets (int64, -1
        kept): flat rows map through the blocks' emb2offset; IVF rowids are
        offsets already."""
        if self._rowid_to_offset is not None:
            rows = np.where(rows >= 0, self._rowid_to_offset[np.clip(rows, 0, None)], -1)
        return rows.astype(np.int64)

    def packing_stats(self) -> dict:
        """:meth:`PackingStats.summary` of every call so far."""
        with self._lock:
            return self.packing.summary()

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches the replays issued: each graph's recorded
        launches times its replays, summed over the graphs."""
        out = dict.fromkeys(COUNTED_KERNELS, 0)
        for g in self.graphs.values():
            for name, n in g.launches.items():
                out[name] += n * g.replays
        return out

    # -- serving ------------------------------------------------------------
    def warmup(self) -> None:
        """Capture (on the card) and run the Q=1 program once, so a serving
        loop does not pay the capture on its first turn."""
        ids = np.zeros((1, self.max_concat_length), np.int32)
        ids[:, 0] = self.tokenizer.cls_token_id
        mask = np.zeros_like(ids)
        mask[:, 0] = 1
        self.search_tokens(ids, mask, record=False)

    def search_tokens(
        self,
        ids: np.ndarray,
        mask: np.ndarray,
        *,
        record: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [Q, L], mask [Q, L]) -> (scores, offsets): one replay on the
        card, the eager program on the CPU.

        L is fixed at construction; each Q is captured padded, and packed at
        each capacity its calls need (see the module's notes); online
        serving is Q=1 a turn, an evaluation replay may batch. The
        recorded latency covers the copies, the replay, the read-back and
        the id mapping; :meth:`search` times the tokenizer in as well.
        """
        t0 = time.perf_counter()
        with span("convdr.serve.turn"):
            ids = np.ascontiguousarray(ids, np.int32)
            mask = np.ascontiguousarray(mask, np.int32)
            if ids.ndim != 2 or ids.shape[1] != self.max_concat_length or mask.shape != ids.shape:
                raise ValueError(
                    f"ids and mask must be [Q, {self.max_concat_length}], got "
                    f"{ids.shape} and {mask.shape}"
                )
            if self.device.type == "cuda":
                s, i = self._replay(ids, mask)
            else:
                s, i = self._eager(ids, mask)
            i = self.rows_to_offsets(i)
        if record:
            self.stats.latencies.append(time.perf_counter() - t0)
        return s, i

    def search(
        self,
        history: Sequence[str],
        *,
        response_text: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One conversation turn: history (current question last) ->
        (scores [1, top_n], token-cache offsets [1, top_n]). The recorded
        latency is the whole request: tokenize, copies, replay, read-back
        and id mapping."""
        t0 = time.perf_counter()
        ids, mask = history_to_inputs(
            self.tokenizer,
            history,
            model_type=self.model_type,
            max_concat_length=self.max_concat_length,
            response_text=response_text,
        )
        out = self.search_tokens(ids, mask, record=False)
        self.stats.latencies.append(time.perf_counter() - t0)
        return out
