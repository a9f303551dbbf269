"""Kernel 1's forward (``csrc/flash_attention.cu``) on the card: the f32
forward on its two paths, its accuracy, and the bf16 forward at the corpus
encoder's shapes.

The f32 forward (six bf16 ``wgmma`` products of the operands' exact bf16
parts) takes 64-row blocks (the small-grid path) while the grid of 128-row
blocks, ceil(T / 128) * H * B, is at most the source's
``kSmallGridBlocks``, and 128-row blocks above. At H=12 D=64, B = 1, 2, 4,
8 and 40 (the teacher's documents) x T = 64, 128, 256, 512, with the masks
of served histories (``history_to_inputs``, right-padded) and random
right-padded masks, the public entry's out and lse are held bit for bit
(``torch.equal``) to batch elements [0, B) of the same problem repeated to
a batch that takes the 128-row path; a mismatch raises. Each shape is
timed on the device (the calls queued behind a spin kernel, so no host
time is in it) through the entry, beside its bound (bytes over 3.35 TB/s
against the kernel's six-part operations, 24HD a pair in segment, over
the 989 TFLOP/s bf16 peak; ``f32_parts_operations``) and, beside that, the
4HD a pair of a design on the CUDA cores over their 67 TFLOP/s f32 peak,
masked SDPA and the repeated batch on the 128-row path (and the plain
version at the serving encode's and the teacher's targets' shapes).

``--parts entry`` times the f32 entry alone at ``ENTRY_SHAPES`` with the
path each takes, for trees whose block-shape switch is moved.

``--parts encoder_f32`` times one full-width 12-layer f32 ``rdot_nll``
encode at each of the main paths' f32 shapes (``F32_ENCODES``: the serving
encode, the query encoder and student, the teacher's targets and
documents) on the device.

``--parts accuracy`` reports the f32 forward's worst distance, out and lse,
from the f64 plain version and from the f32 plain version (the card tests'
1e-5 yardstick) on N(0, 1) inputs and on near-parallel positive rows (1 +
0.01 N(0, 1): long one-signed sums) at B=40 T=512 and B=4 T=256, and on
one row of T=30000 (``ACCURACY_CASES``).

The bf16 part (``--parts bf16``) times the bf16 forward on the device at
the corpus rungs (``ATTN_SHAPES``), at the bf16 student's B=4 T=256 with
lse and at one T past 512 (``FLUSH_SHAPE``: the accumulator flush), each
beside its bytes bound, the kernel's own tensor-core operations (the
three-part P: 8HD a pair, ``bf16_operations``) at the bf16 peak, masked
SDPA, the launch configuration and path; and one full-width ``rdot_nll``
bf16 ``body_emb`` (random weights from a seed, 12 layers) at each rung,
beside 12 times the kernel. ``--save_bf16 DIR`` keeps the bf16 outputs and
``--against_bf16 DIR`` reports each output's largest distance, in bf16
ulps, from the ones another run kept (the same seeded inputs), over all
positions and over those of magnitude at least 1e-4.

``--root`` imports ``convdr_torch`` from another checkout (a parent
unpacked with ``git archive``), so two versions compare within one call
on one card: a tree from before the small-grid path times the 64-row tile
at every shape. ``--digests`` adds digests of every f32 out and lse and
the f32 backward's gradients at chip_smoke's f32 shapes, of the serving
shape, and of the bf16 outputs at the corpus rungs, so that two
checkouts compare bit for bit across processes:

    python -m convdr_torch.scripts.attention_sweep --root parent --label parent --digests
    python -m convdr_torch.scripts.attention_sweep --label change --digests
    python -m convdr_torch.scripts.attention_sweep --parts accuracy

    python -m convdr_torch.scripts.attention_sweep --parts bf16 --root parent \
        --label parent --save_bf16 /tmp/bf16_parent
    python -m convdr_torch.scripts.attention_sweep --parts bf16 --label change \
        --against_bf16 /tmp/bf16_parent

Needs the card; prints one JSON line a version.
"""

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from convdr_torch.scripts.score_sweep import HBM_BYTES_PER_S, PEAK_FLOPS, device_ms, digest

HEADS, HEAD_DIM = 12, 64
SWEEP_B, SWEEP_T = (1, 2, 4, 8), (64, 128, 256, 512)
EXTRA_SHAPES = ((40, 512),)  # the teacher's documents
# where the plain version is timed too: the serving encode, the teacher's targets
PLAIN_SHAPES = ((1, 256), (4, 64))
MASKS = ("served", "right")
# (batch, T) of gen_passage_embeddings' length rungs at 64 rows x 512 tokens
# (retrieval/embed_corpus.py _BucketBuffer), bf16
ATTN_SHAPES = [(512, 64), (256, 128), (128, 256), (64, 384), (64, 512)]
# the f32 forward's shapes in chip_smoke's train step: the student's concat
# (batch 4 x 256), the teacher's targets (4 x 64) and documents (4 x 10
# rows of 512: a positive and 9 negatives)
F32_SHAPES = [(4, 256), (4, 64), (40, 512)]
SERVE_T = 256  # the serving encode's concat length (batch 1)
# the bf16 part: the bf16 student's forward with lse, and a T past 512
# (more than 8 key tiles a row: the bf16 kernel's accumulator flush)
BF16_LSE_SHAPE = (4, 256)
FLUSH_SHAPE = (8, 2048)
ENCODER_LAYERS = 12  # rdot_nll: RoBERTa-base


def make_histories(n):
    """n distinct three-turn conversations, the current question last
    (scripts/bench_online.py's)."""
    subjects = ["throat cancer", "bronze age trade", "lucid dreaming", "coral reefs",
                "rust compilers", "monsoon seasons", "jazz harmony", "glacier melt"]
    return [[f"tell me about {subjects[i % len(subjects)]} case {i}",
             f"what causes it in region {i % 7}",
             f"how is it treated or managed today, variant {i}"] for i in range(n)]


def in_segment_pairs(mask):
    """The (query, key) pairs of a [B, T] 0/1 mask that share a segment: a
    query attends to the L valid or the T - L pad keys of its row."""
    lens = mask.sum(1).double()
    return float((lens ** 2 + (mask.shape[1] - lens) ** 2).sum())


def bf16_operations(mask, heads, head_dim):
    """The tensor-core operations of the bf16 kernel on this data: S is 2D
    a pair and head, P V 2D for each of P's three bf16 parts, so 8HD a
    pair, twice the function's 4HD (the planned tiles' masked pairs not
    counted)."""
    return 8.0 * heads * head_dim * in_segment_pairs(mask)


def bf16_ulps(a, b, min_abs=0.0):
    """The largest distance between two bf16 tensors of one shape, in bf16
    ulps (steps between neighbouring bf16 values; +0 and -0 count as one value), over
    the positions where either is at least ``min_abs`` in magnitude (two
    outputs of opposite sign near zero are as many steps apart as there
    are bf16 values between them)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    steps = (ordered(a) - ordered(b)).abs()
    if min_abs > 0:
        steps = steps[torch.maximum(a.float().abs(), b.float().abs()) >= min_abs]
    return int(steps.max()) if steps.numel() else 0


def f32_parts_operations(mask, heads, head_dim):
    """The tensor-core operations of the f32 kernel on this data: S is six
    bf16 products of 2D a pair and head, P V six more, so 24HD a pair, six
    times the function's 4HD (the planned tiles' masked pairs not
    counted)."""
    return 24.0 * heads * head_dim * in_segment_pairs(mask)


def cuda_core_bound_ms(q, mask):
    """The function's 4HD operations a pair in segment over the CUDA cores'
    67 TFLOP/s f32 peak (ms): the floor of any f32 design without the
    tensor cores, printed beside the f32 bound."""
    _b, _t, h, d = q.shape
    return 4.0 * h * d * in_segment_pairs(mask) / PEAK_FLOPS[torch.float32] * 1e3


def bound_ms(q, mask, lse=False):
    """The least time (ms) of one forward: the bytes of q, k, v, out and
    the mask once each (and the f32 lse with ``lse``) against the
    operations the kernel does on this data (a query attends to the L valid
    or the T-L pad keys of its row; f32: the six-part products' 24HD a pair
    at the bf16 peak, ``f32_parts_operations``; bf16: the function's 4HD at
    the bf16 peak); and which of the two bounds it."""
    b, t, h, d = q.shape
    if q.dtype == torch.float32:
        ops_ms = f32_parts_operations(mask, h, d) / PEAK_FLOPS[torch.bfloat16] * 1e3
    else:
        ops_ms = 4.0 * h * d * in_segment_pairs(mask) / PEAK_FLOPS[q.dtype] * 1e3
    nbytes = 4 * q.numel() * q.element_size() + mask.numel() * 4 + (b * h * t * 4 if lse else 0)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms else "bytes")


def served_mask(batch, t, histories=None):
    """[batch, t] int32 masks of served histories (row i the i-th), as the
    serving encode pads them at concat length t."""
    from convdr_torch.core.loading import load_tokenizer_for
    from convdr_torch.core.registry import get_model_config
    from convdr_torch.retrieval.online import history_to_inputs

    tokenizer = load_tokenizer_for(get_model_config("rdot_nll"), None)
    histories = histories or make_histories(batch)
    rows = [history_to_inputs(tokenizer, histories[i % len(histories)],
                              max_concat_length=t)[1][0] for i in range(batch)]
    return torch.tensor(rows, dtype=torch.int32, device="cuda")


def right_mask(batch, t, gen):
    """Right-padded masks of random lengths in [1, t]."""
    lens = torch.randint(1, t + 1, (batch,), generator=gen, device="cuda")
    return (torch.arange(t, device="cuda")[None, :] < lens[:, None]).int()


def problem(batch, t, dtype, gen, mask):
    q, k, v = (torch.randn((batch, t, HEADS, HEAD_DIM), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    return q, k, v, mask


# the f32 forward's path for large grids: the 128-row blocks ("f32 tile"
# in trees from before the six-part kernel, whose large-grid path was the
# FMA tile)
LARGE_GRID_PATHS = ("f32 six-part wgmma", "f32 tile")


def fwd_path(batch, t, h=HEADS, d=HEAD_DIM):
    from convdr_torch.models.attention import flash_attention_fwd_config

    # a tree from before the small-grid path reports no path: the tile
    return flash_attention_fwd_config(batch, t, h, d, torch.float32).get("path", "f32 tile")


def tile_repeats(batch, t, h=HEADS, d=HEAD_DIM):
    """The smallest count of copies of a B=batch problem that takes the f32
    forward's large-grid path."""
    r = 1
    while fwd_path(batch * r, t, h, d) not in LARGE_GRID_PATHS:
        r *= 2
    return r


def sweep(histories=None, seed=0, log=print):
    """The readings above as ``{"B<b>xT<t>_<mask>": row}``; raises if an
    output of the small-grid path differs from the large-grid path's."""
    from convdr_torch.models.attention import flash_attention_fwd, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for b, t in [(b, t) for b in SWEEP_B for t in SWEEP_T] + list(EXTRA_SHAPES):
        for kind in MASKS:
            mask = served_mask(b, t, histories) if kind == "served" else right_mask(b, t, gen)
            q, k, v, mask = problem(b, t, torch.float32, gen, mask)
            o, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
            r = tile_repeats(b, t)
            tiled = [x.repeat(r, *([1] * (x.dim() - 1))) for x in (q, k, v, mask)]
            o_t, lse_t = flash_attention_fwd(*tiled, with_lse=True)
            if not (torch.equal(o, o_t[:b]) and torch.equal(lse, lse_t[:b])):
                raise AssertionError(f"B={b} T={t} {kind}: the f32 forward differs from the "
                                     f"large-grid path's first {b} batch elements")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            allowed = mask[:, None, :, None] == mask[:, None, None, :]
            bnd, by = bound_ms(q, mask)
            row = {"path": fwd_path(b, t), "tile_grid": -(-t // 64) * HEADS * b,
                   "valid_tokens": int(mask.sum()), "equal_to_tile_path": True,
                   "ms": device_ms(lambda: flash_attention_fwd(q, k, v, mask, False)),
                   "tile_repeats": r,
                   "tile_batch_ms": device_ms(lambda: flash_attention_fwd(*tiled, False)),
                   "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=allowed)),
                   "bound_ms": bnd, "bound_by": by,
                   "cuda_core_bound_ms": cuda_core_bound_ms(q, mask)}
            if (b, t) in PLAIN_SHAPES:
                row["plain_ms"] = device_ms(lambda: flash_attention_plain(q, k, v, mask), iters=5)
            out[f"B{b}xT{t}_{kind}"] = row
            log(f"  f32 B={b} T={t} {kind} ({row['valid_tokens']} valid; tile grid "
                f"{row['tile_grid']}): {row['path']} {row['ms']:.4f} ms; "
                f"x{r} on the large-grid path {row['tile_batch_ms']:.4f}, "
                + (f"plain {row['plain_ms']:.4f}, " if "plain_ms" in row else "")
                + f"SDPA {row['sdpa_ms']:.4f}; bound {bnd:.4f} ({by}; CUDA cores "
                f"{row['cuda_core_bound_ms']:.4f}); equal to the large-grid path")
    return out


# the shapes of ``--parts entry``: the main path's f32 forwards and the
# grids on either side of the block-shape switch (``kSmallGridBlocks``)
ENTRY_SHAPES = [(40, 512), (64, 512), (8, 512), (4, 256), (8, 256), (2, 256), (1, 256),
                (4, 64), (8, 128), (1, 512)]


def entry_times(seed=11, log=print):
    """Device ms of the public f32 entry (no lse) at ``ENTRY_SHAPES``, H=12
    D=64, right-padded random lengths, with the path and the blocks an SM
    the shape takes: ``{"B<b>xT<t>": row}``. Unlike ``sweep`` it holds no
    output to another path, so it also times trees whose block-shape
    switch is moved."""
    from convdr_torch.models.attention import flash_attention_fwd, flash_attention_fwd_config

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for b, t in ENTRY_SHAPES:
        q, k, v, mask = problem(b, t, torch.float32, gen, right_mask(b, t, gen))
        cfg = flash_attention_fwd_config(b, t, HEADS, HEAD_DIM, torch.float32)
        rows[f"B{b}xT{t}"] = {"ms": device_ms(lambda: flash_attention_fwd(q, k, v, mask, False)),
                              "path": cfg.get("path", "f32 tile"),
                              "blocks_per_sm": cfg["blocks_per_sm"]}
        log(f"  f32 entry B={b} T={t}: {rows[f'B{b}xT{t}']}")
    return rows


# (inputs, B, T, H, D, mask): N(0, 1) q, k, v or near-parallel positive
# rows, 1 + 0.01 N(0, 1) (long one-signed sums), at the teacher's documents'
# and the student's shapes, and one long row
ACCURACY_CASES = [("normal", 40, 512, 12, 64, "right"), ("normal", 4, 256, 12, 64, "right"),
                  ("near_parallel", 40, 512, 12, 64, "right"),
                  ("near_parallel", 4, 256, 12, 64, "right"),
                  ("normal", 1, 30000, 1, 16, "middle"),
                  ("near_parallel", 1, 30000, 1, 16, "middle")]


def kind_mask(batch, t, gen, kind):
    """[batch, t] int32 masks of random valid lengths in [1, t]: the valid
    tokens first ("right") or in a run between pads ("middle")."""
    lens = torch.randint(1, t + 1, (batch,), generator=gen, device="cuda")
    pos = torch.arange(t, device="cuda")[None, :]
    if kind == "right":
        return (pos < lens[:, None]).int()
    start = torch.randint(0, t, (batch,), generator=gen, device="cuda") % (t - lens + 1)
    return ((pos >= start[:, None]) & (pos < (start + lens)[:, None])).int()


def masked_lse(q, k, mask):
    """The log-sum-exp [B, H, T] of the scaled scores a query may see, in
    q's dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    return torch.logsumexp(scores.masked_fill(~allowed, float("-inf")), dim=-1)


def accuracy(seed=4, log=print):
    """The f32 forward's worst absolute distance, out and lse, from the f64
    plain version and from the f32 plain version, at ``ACCURACY_CASES``:
    ``{"<inputs>_B<b>xT<t>": row}``."""
    from convdr_torch.models.attention import flash_attention_fwd, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for inputs, b, t, h, d, kind in ACCURACY_CASES:
        mask = kind_mask(b, t, gen, kind)
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda") for _ in range(3))
        if inputs == "near_parallel":
            q, k, v = (1.0 + 0.01 * x for x in (q, k, v))
        out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
        row = {"out_vs_f32_plain": (out - flash_attention_plain(q, k, v, mask)).abs().max().item(),
               "lse_vs_f32": (lse - masked_lse(q, k, mask)).abs().max().item()}
        q64, k64, v64 = (x.double() for x in (q, k, v))
        row["out_vs_f64"] = (out - flash_attention_plain(q64, k64, v64, mask)).abs().max().item()
        row["lse_vs_f64"] = (lse - masked_lse(q64, k64, mask)).abs().max().item()
        del q64, k64, v64
        torch.cuda.empty_cache()
        name = f"{inputs}_B{b}xT{t}"
        rows[name] = row
        log(f"  f32 accuracy {name} (H={h} D={d}, {kind}): out {row['out_vs_f64']:.3e} from "
            f"f64, {row['out_vs_f32_plain']:.3e} from the f32 plain version; lse "
            f"{row['lse_vs_f64']:.3e} / {row['lse_vs_f32']:.3e}")
    return rows


def bf16_sweep(seed=2, save=None, against=None, log=print):
    """The bf16 readings above as ``{"B<b>xT<t>[_lse]": row}``, right-padded
    random lengths; with ``save`` each out goes to ``save/<name>.pt``, with
    ``against`` each row gets ``ulps_from_other``."""
    import os

    from convdr_torch.models.attention import flash_attention_fwd, flash_attention_fwd_config

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out_rows = {}
    shapes = [(b, t, False) for b, t in ATTN_SHAPES]
    for b, t, lse in shapes + [(*BF16_LSE_SHAPE, True), (*FLUSH_SHAPE, False)]:
        q, k, v, mask = problem(b, t, torch.bfloat16, gen, right_mask(b, t, gen))
        name = f"B{b}xT{t}" + ("_lse" if lse else "")
        out, _ = flash_attention_fwd(q, k, v, mask, lse)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        allowed = mask[:, None, :, None] == mask[:, None, None, :]
        bnd, by = bound_ms(q, mask, lse)
        ops = bf16_operations(mask, HEADS, HEAD_DIM)
        row = {"config": flash_attention_fwd_config(b, t, HEADS, HEAD_DIM, torch.bfloat16),
               "valid_tokens": int(mask.sum()),
               "ms": device_ms(lambda: flash_attention_fwd(q, k, v, mask, lse)),
               "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=allowed)),
               "bound_ms": bnd, "bound_by": by, "kernel_operations": ops,
               "kernel_operations_ms": ops / PEAK_FLOPS[torch.bfloat16] * 1e3}
        if save:
            os.makedirs(save, exist_ok=True)
            torch.save(out.cpu(), os.path.join(save, name + ".pt"))
        if against:
            other = torch.load(os.path.join(against, name + ".pt")).cuda()
            row["ulps_from_other"] = bf16_ulps(out, other)
            row["ulps_from_other_above_1e-4"] = bf16_ulps(out, other, 1e-4)
        out_rows[name] = row
        cfg = row["config"]
        log(f"  bf16 {name} ({row['valid_tokens']} valid): {cfg.get('path', '?')}, "
            f"{cfg['threads']} threads, {cfg['smem_bytes']} B, {cfg['blocks_per_sm']} blocks/SM: "
            f"{row['ms']:.4f} ms; SDPA {row['sdpa_ms']:.4f}; bound {bnd:.4f} ({by}); "
            f"three-part operations {ops:.3e} = {row['kernel_operations_ms']:.4f} ms at peak"
            + (f"; {row['ulps_from_other']} ulps from the other run "
               f"({row['ulps_from_other_above_1e-4']} where |out| >= 1e-4)" if against else ""))
    return out_rows


def encoder_sweep(seed=3, log=print):
    """One full-width rdot_nll bf16 ``body_emb`` (random weights from
    ``seed``) at each corpus rung, on the device, with the attention
    launches of one call: ``{"B<b>xT<t>": {"ms": .., "attention_launches": ..}}``."""
    from convdr_torch.core.loading import gelu_arch_overrides, load_model_and_params
    from convdr_torch.models.attention import flash_attention

    _config, _tok, model = load_model_and_params(
        "rdot_nll", None, device=torch.device("cuda"), dtype=torch.bfloat16,
        arch_overrides=gelu_arch_overrides("auto", "bfloat16"), seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    with torch.inference_mode():
        for b, t in ATTN_SHAPES:
            ids = torch.randint(3, model.config.arch.vocab_size, (b, t), generator=gen,
                                device="cuda")
            mask = right_mask(b, t, gen)
            before = flash_attention.launches
            model.body_emb(ids, mask)
            torch.cuda.synchronize()
            launches = flash_attention.launches - before
            rows[f"B{b}xT{t}"] = {"ms": device_ms(lambda: model.body_emb(ids, mask), iters=5),
                                  "attention_launches": launches}
            log(f"  bf16 encoder B={b} T={t}: {rows[f'B{b}xT{t}']['ms']:.3f} ms, "
                f"{launches} attention launches")
    return rows


# the f32 encodes of the main paths (rdot_nll, 12 layers): the serving
# encode (a served history), the query encoder and student at batch 4, and
# a train step's teacher encodes of its targets and documents
F32_ENCODES = [("serving", 1, SERVE_T, "query_emb"), ("query", 4, 256, "query_emb"),
               ("targets", 4, 64, "query_emb"), ("docs", 40, 512, "body_emb")]


def f32_encoder_sweep(histories=None, seed=3, log=print):
    """One full-width rdot_nll f32 encode (random weights from ``seed``, 12
    layers) at each of ``F32_ENCODES`` on the device, with the attention
    launches of one call: ``{name: {"ms": .., "attention_launches": ..}}``."""
    from convdr_torch.core.loading import load_model_and_params
    from convdr_torch.models.attention import flash_attention

    _config, _tok, model = load_model_and_params("rdot_nll", None, device=torch.device("cuda"),
                                                 dtype=torch.float32, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    with torch.inference_mode():
        for name, b, t, method in F32_ENCODES:
            ids = torch.randint(3, model.config.arch.vocab_size, (b, t), generator=gen,
                                device="cuda")
            mask = served_mask(b, t, histories) if name == "serving" else right_mask(b, t, gen)
            encode = getattr(model, method)
            before = flash_attention.launches
            encode(ids, mask)
            torch.cuda.synchronize()
            launches = flash_attention.launches - before
            rows[name] = {"shape": f"B={b} T={t} {method}", "attention_launches": launches,
                          "ms": device_ms(lambda: encode(ids, mask), iters=5)}
            log(f"  f32 encoder {name} B={b} T={t} {method}: {rows[name]['ms']:.3f} ms, "
                f"{launches} attention launches")
    return rows


def digests(histories=None, seed=1):
    """Digests of the f32 out and lse (and out without lse), and of the f32
    backward's dQ, dK, dV from that lse, at ``F32_SHAPES`` (right-padded
    random lengths) and at B=1 T=``SERVE_T`` (a served history); of the bf16
    out at ``ATTN_SHAPES`` and of bf16 out and lse at B=4 T=256."""
    from convdr_torch.models.attention import flash_attention_bwd, flash_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(seed)
    result = {}
    shapes = [(b, t, torch.float32, None) for b, t in F32_SHAPES]
    shapes.append((1, SERVE_T, torch.float32, served_mask(1, SERVE_T, histories)))
    shapes += [(b, t, torch.bfloat16, None) for b, t in ATTN_SHAPES + [(4, 256)]]
    for b, t, dtype, mask in shapes:
        q, k, v, mask = problem(b, t, dtype, gen,
                                right_mask(b, t, gen) if mask is None else mask)
        name = f"{str(dtype)[6:]}_B{b}xT{t}"
        if dtype == torch.bfloat16 and (b, t) != (4, 256):
            result[name] = digest(flash_attention_fwd(q, k, v, mask, False)[0])
            continue
        o, lse = flash_attention_fwd(q, k, v, mask, True)
        result[name] = digest(o, lse, flash_attention_fwd(q, k, v, mask, False)[0])
        if dtype == torch.float32:
            do = torch.randn(q.shape, generator=gen, device="cuda")
            result[name + "_bwd"] = digest(*flash_attention_bwd(q, k, v, o, do, mask, lse))
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default="", help="checkout to import convdr_torch from")
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--digests", action="store_true",
                        help="also digest the forward's outputs at chip_smoke's shapes")
    parser.add_argument("--parts", default="f32,bf16",
                        help="comma-separated: f32 (both f32 paths), entry (the f32 entry "
                             "alone), accuracy (the f32 "
                             "forward against f64), encoder_f32 (12-layer f32 encodes), "
                             "bf16 (kernel and encoder)")
    parser.add_argument("--save_bf16", default="", help="directory to keep the bf16 outputs in")
    parser.add_argument("--against_bf16", default="",
                        help="directory of another run's bf16 outputs to count ulps against")
    args = parser.parse_args(argv)
    parts = set(args.parts.split(","))
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules if m.split(".")[0] == "convdr_torch"]:
            del sys.modules[name]
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep needs a CUDA device")
    from convdr_torch.core.device import set_exact_matmul
    from convdr_torch.ops import cuda_build

    set_exact_matmul()
    cuda_build.build(["flash_attention", "flash_attention_bwd"])
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    result = {"label": args.label, "card": torch.cuda.get_device_name(0)}
    if "f32" in parts:
        result["sweep"] = sweep(log=log)
    if "entry" in parts:
        result["entry"] = entry_times(log=log)
    if "accuracy" in parts:
        result["accuracy"] = accuracy(log=log)
    if "encoder_f32" in parts:
        result["encoder_f32"] = f32_encoder_sweep(log=log)
    if "bf16" in parts:
        result["bf16"] = bf16_sweep(save=args.save_bf16, against=args.against_bf16, log=log)
        result["encoder"] = encoder_sweep(log=log)
        for name, row in result["encoder"].items():
            row["kernel_share"] = ENCODER_LAYERS * result["bf16"][name]["ms"] / row["ms"]
    if args.digests:
        result["digests"] = digests()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
