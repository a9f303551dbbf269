"""convdr_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU: each skips, with its reason,
where there is none. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which the machine with
the card does not have; this file imports nothing of JAX.)

Tolerances: attention f32 1e-5 absolute (same softmax, another summation
order), bf16 one bf16 ulp (2^-7 relative; both versions round one f32
result); scores 1e-5 * |q| * max|p| (f32 dot products of another order);
f32 and bf16 scores within 2 D 2^-24 sum |q_k p_k| of the f64 product of
the same operands (the six- and three-part tensor-core products; see
``bf16_score_bound``);
the attention backward 1e-5 * max|ref| per gradient (f32 sums of up to T
terms in another order, P recomputed from the forward's log-sum-exp), and
on near-parallel rows 1e-5 of the f64 sum of each gradient's terms'
magnitudes (``term_magnitudes``); in
bf16, within 2x the error of autograd through masked SDPA in bf16 (floor
1e-3 of scale) from the f64 plain backward, and the bf16 forward's lse
within 1e-5 relative of a torch.logsumexp.
Equal, not close: the streaming passes against the score kernel (f32: the
same six-part tensor-core product into the same two sums in one k order;
bf16: the same three-part product in one k order, whose bits the wgmma
probe shows depend on nothing else; int8: exact integer sums, on the
tensor cores in the score kernel), the score kernel's small-Q tiles
against its query tiles (the first Q rows of a Q=65 batch: the same
product), the f32 attention forward's small-grid path (64-row blocks)
against its 128-row blocks (out and lse of the same problem repeated to a
batch that takes the 128-row blocks; the same six-part products in one
order), two f32 or bf16 forward calls on the same inputs, the bf16 backward's
gradients against digests of the tree before the f32 backward's redesign, int8
scores against the plain version (exact integer
arithmetic), the gathers against ``torch.gather`` (copies), and two
backward calls on the same inputs (no atomics). The ANN layer (PyTorch
ops): int8 IVF scores equal the integer oracle's; the ADC scans and IVF
searches on the card against the CPU's within 1e-5, ids equal but for
near-ties at the cut; a full IVF probe's sets against ``flat_ip_topk``'s.
Multi-GPU (one card holds one NCCL rank): the sharded search on a world-1
NCCL mesh and the S-shard emulation in one process (S = 2, 3, 4; each
shard's local search, then the merge) equal the unsharded search, scores
and indices; a data-parallel step on a world-1 mesh equals the unmeshed
step bit for bit.
"""

import ctypes

import numpy as np
import pytest
import torch

from convdr_torch.core.config import SearchConfig
from convdr_torch.core.device import set_exact_matmul
from convdr_torch.models.attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_config,
    flash_attention_bwd_delta,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_config,
    flash_attention_plain,
)
from convdr_torch.models import attention as attention_module
from convdr_torch.ops import cuda_build
from convdr_torch.ops import exact_search as es
from convdr_torch.ops.fused_search import (
    bf16_query_parts,
    fused_flat_ip_topk,
    fused_scores_groupmax,
    fused_scores_groupmax_plain,
)
from convdr_torch.ops.gather_groups import dma_gather_groups, dma_gather_groups_plain
from convdr_torch.ops.quant import (
    Int8Quantizer,
    fit_int8_scales,
    quantize_passages,
    quantize_passages_dev,
)
from convdr_torch.ops.streaming_search import (
    candidate_work_list,
    candidate_work_list_plain,
    extract_candidate_scores,
    extract_candidate_scores_plain,
    extract_candidate_scores_unchecked,
    streaming_flat_ip_topk,
    streaming_groupmax,
    streaming_groupmax_plain,
)
from convdr_torch.retrieval.searcher import BlockedSearcher
from convdr_torch.scripts import attention_bwd_bench
from convdr_torch.scripts.attention_sweep import tile_repeats
from convdr_torch.scripts.score_sweep import digest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    set_exact_matmul()
    return torch.device("cuda")


def attention_problem(b, t, h, d, dtype, seed=0, mask="right"):
    """Seeded q/k/v and a [B, T] 0/1 mask whose last row is all pad. The
    other rows hold a random number of valid tokens: first ("right"), last
    ("left") or in a run between pads ("middle"); or ("random") each token
    is valid with probability 1/2."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
        for _ in range(3)
    )
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lens[-1] = 0  # all-pad row
    pos = torch.arange(t, device="cuda")[None, :]
    if mask == "right":
        valid = pos < lens[:, None]
    elif mask == "left":
        valid = pos >= t - lens[:, None]
    elif mask == "middle":
        start = torch.randint(0, t, (b,), generator=gen, device="cuda") % (t - lens + 1)
        valid = (pos >= start[:, None]) & (pos < (start + lens)[:, None])
    else:
        valid = torch.rand((b, t), generator=gen, device="cuda") < 0.5
        valid[-1] = False
    return q, k, v, valid.int()


# (B, T, H, D, mask): T values that cut the 64-query blocks and the 32-
# and 64-key tiles; small grids (B=1, 2, 4 at T=256); the teacher's document
# shape and corpus rungs; masks that are not right-padded, so the tile skip
# works on segment ranges and not on a prefix; and one long row
FLASH_CASES = [
    (3, 100, 2, 64, "right"), (4, 64, 12, 64, "right"), (2, 77, 3, 32, "right"),
    (2, 40, 2, 16, "right"), (2, 512, 12, 64, "right"),
    (512, 64, 12, 64, "right"),  # enough outputs near zero to expose rounding of P
    *[(2, t, 2, 64, "right") for t in (1, 31, 33, 63, 65, 127, 129, 255, 257, 511, 513)],
    (3, 129, 3, 32, "right"), (3, 65, 2, 16, "right"), (48, 129, 12, 64, "right"),
    (1, 256, 12, 64, "right"), (2, 256, 12, 64, "right"), (4, 256, 12, 64, "right"),
    (40, 512, 12, 64, "right"), (64, 384, 12, 64, "right"),
    (4, 256, 12, 64, "random"), (4, 256, 12, 64, "left"), (4, 256, 12, 64, "middle"),
    (40, 512, 12, 64, "random"), (40, 512, 12, 64, "left"), (40, 512, 12, 64, "middle"),
    (3, 200, 2, 16, "middle"), (3, 200, 2, 32, "left"), (24, 300, 12, 32, "random"),
    # bf16: flushes of the MMA accumulators; f32: a plan past 48 KB of shared memory
    (1, 30000, 1, 16, "middle"),
    # bf16: the flush at the base model's head width, planned tiles with gaps
    (2, 2048, 2, 64, "random"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,d,mask_kind", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, b, t, h, d, mask_kind):
    q, k, v, mask = attention_problem(b, t, h, d, dtype, mask=mask_kind)
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, mask)
    assert torch.isfinite(out.float()).all()
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        assert bool((diff <= 1e-6 + 2.0 ** -7 * ref.float().abs()).all())


@pytest.mark.parametrize(
    "b,t,h,d,mask_kind",
    [(4, 256, 12, 64, "right"), (40, 512, 12, 64, "middle"), (2, 33, 2, 16, "random"),
     (3, 129, 3, 32, "left"), (1, 1, 1, 64, "right")],
)
def test_flash_forward_lse_matches_logsumexp(cuda, b, t, h, d, mask_kind):
    """The f32 forward's lse against torch.logsumexp of the masked, scaled
    scores, 1e-5 absolute (f32 sums of another order)."""
    q, k, v, mask = attention_problem(b, t, h, d, torch.float32, mask=mask_kind)
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    torch.cuda.synchronize()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    want = torch.logsumexp(scores.masked_fill(~allowed, float("-inf")), dim=-1)
    assert torch.isfinite(lse).all()
    assert (lse - want).abs().max().item() <= 1e-5
    assert (out - flash_attention_plain(q, k, v, mask)).abs().max().item() <= 1e-5


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, mask = attention_problem(2, 16, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*(torch.zeros(2, 16, 1, 128, device="cuda") for _ in range(3)), mask)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k.half(), v, mask)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(q.numel() + 1, device="cuda")
        flash_attention(flat[1:].view(q.shape), k, v, mask)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("t", [1, 33, 64, 200, 256, 512])
@pytest.mark.parametrize("h", [1, 12])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_small_grid_path_equals_tile_path(cuda, b, t, h, d):
    """The f32 forward's small-grid path (blocks of one warpgroup, 64
    query rows) gives out and lse equal bit for bit to the 128-row blocks'
    on the same problem repeated to a batch that takes them, for four mask
    kinds, with and without lse: the direct proof that a row's six-part
    products, their order and its softmax do not depend on the block."""
    r = tile_repeats(b, t, h, d)
    for mask_kind in ("right", "left", "middle", "random"):
        # the first b rows of b + 1: none of them the all-pad last row
        q, k, v, mask = (x[:b].contiguous() for x in attention_problem(
            b + 1, t, h, d, torch.float32, seed=3, mask=mask_kind))
        tile = [x.repeat(r, *([1] * (x.dim() - 1))) for x in (q, k, v, mask)]
        out_t, lse_t = flash_attention_fwd(*tile, with_lse=True)
        out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
        bare, _ = flash_attention_fwd(q, k, v, mask, with_lse=False)
        torch.cuda.synchronize()
        assert torch.equal(out, out_t[:b]) and torch.equal(lse, lse_t[:b]), mask_kind
        assert torch.equal(bare, out), mask_kind


def test_flash_fwd_config_reports_the_path(cuda):
    """The serving encode's shape (B=1 T=256 H=12) takes the f32 small-grid
    path, whose 64-row blocks give it 48 blocks where 128-row ones give
    24; the teacher's documents (B=40 T=512) take the 128-row blocks; bf16
    takes the wgmma kernel at every shape."""
    small = flash_attention_fwd_config(1, 256, 12, 64, torch.float32)
    assert small["path"] == "f32 six-part wgmma small grid"
    assert -(-256 // small["block_queries"]) * 12 == 48
    assert small["blocks_per_sm"] >= 1
    assert flash_attention_fwd_config(40, 512, 12, 64, torch.float32)["path"] == \
        "f32 six-part wgmma"
    assert flash_attention_fwd_config(1, 256, 12, 64, torch.bfloat16)["path"] == "bf16 wgmma"


# the f32 forward's shapes: the serving encode, the teacher's targets, the
# query encoder and student, the teacher's documents; (path, query rows a
# block, threads)
F32_CONFIG_SHAPES = [(1, 256, "f32 six-part wgmma small grid", 64, 128),
                     (4, 64, "f32 six-part wgmma small grid", 64, 128),
                     (4, 256, "f32 six-part wgmma", 128, 256),
                     (40, 512, "f32 six-part wgmma", 128, 256)]


@pytest.mark.parametrize("b,t,path,rows,threads", F32_CONFIG_SHAPES)
def test_flash_fwd_f32_config_reports_the_six_part_kernel(cuda, b, t, path, rows, threads):
    """The f32 forward's launch configuration at the main path's shapes:
    the six-part wgmma kernel's path, its block (one warpgroup of 64 rows on
    small grids, two of 128 rows above), 64-key tiles, shared memory
    within a block's limit, at least one block resident an SM."""
    cfg = flash_attention_fwd_config(b, t, 12, 64, torch.float32)
    props = torch.cuda.get_device_properties(0)
    per_sm = props.shared_memory_per_multiprocessor
    assert (cfg["path"], cfg["block_queries"], cfg["threads"], cfg["tile_keys"]) == (
        path, rows, threads, 64)
    assert 0 < cfg["smem_bytes"] <= getattr(props, "shared_memory_per_block_optin", per_sm - 1024)
    assert cfg["blocks_per_sm"] >= 1


# the corpus rungs, the bf16 student, the flush's T and the other head dims
BF16_CONFIG_SHAPES = [(512, 64, 64), (256, 128, 64), (128, 256, 64), (64, 384, 64),
                      (64, 512, 64), (4, 256, 64), (2, 2048, 64), (1, 30000, 16), (3, 77, 32)]


@pytest.mark.parametrize("b,t,d", BF16_CONFIG_SHAPES)
def test_flash_fwd_bf16_config_fits_the_card(cuda, b, t, d):
    """The bf16 forward's launch configuration: the wgmma path, shared
    memory within what a block of this card may have (less the 1 KB the
    SM keeps for each block) and, for the blocks an SM it reports, within
    the SM's; at least one block resident an SM."""
    cfg = flash_attention_fwd_config(b, t, 12, d, torch.bfloat16)
    props = torch.cuda.get_device_properties(0)
    per_sm = props.shared_memory_per_multiprocessor
    assert cfg["path"] == "bf16 wgmma"
    assert 0 < cfg["smem_bytes"] <= getattr(props, "shared_memory_per_block_optin", per_sm - 1024)
    assert cfg["blocks_per_sm"] >= 1
    assert cfg["blocks_per_sm"] * cfg["smem_bytes"] <= per_sm


@pytest.mark.parametrize("b,t,h,d,mask_kind", [(40, 512, 12, 64, "right"), (4, 256, 12, 64, "random"),
                                               (1, 256, 12, 64, "middle"), (3, 77, 2, 32, "left"),
                                               (1, 30000, 1, 16, "middle")])
def test_flash_fwd_f32_is_deterministic(cuda, b, t, h, d, mask_kind):
    """Two f32 forward calls on the same inputs give the same out and lse
    bit for bit (no atomics, no order that depends on the schedule)."""
    q, k, v, mask = attention_problem(b, t, h, d, torch.float32, mask=mask_kind)
    first = flash_attention_fwd(q, k, v, mask, with_lse=True)
    second = flash_attention_fwd(q, k, v, mask, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("b,t,h,d,mask_kind", [(40, 512, 12, 64, "right"), (4, 256, 12, 64, "random"),
                                               (1, 256, 12, 64, "right"), (2, 300, 2, 32, "middle"),
                                               (1, 30000, 1, 16, "middle")])
def test_flash_f32_near_parallel_rows_within_1e5(cuda, b, t, h, d, mask_kind):
    """Near-parallel positive rows (1 + 0.01 N(0, 1)): every score and every
    P V term one-signed, the longest one-signed sums the tensor cores'
    truncating accumulation sees. out within 1e-5 of the plain version and
    lse within 1e-5 of torch.logsumexp, both in f64: on these rows the f32
    plain version's own sums drift by up to ~6e-6 at T=30000
    (``attention_sweep.py --parts accuracy``), too near 1e-5 to judge by."""
    q, k, v, mask = attention_problem(b, t, h, d, torch.float32, mask=mask_kind)
    q, k, v = (1.0 + 0.01 * x for x in (q, k, v))
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    torch.cuda.synchronize()
    q, k, v = (x.double() for x in (q, k, v))
    assert (out - flash_attention_plain(q, k, v, mask)).abs().max().item() <= 1e-5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    want = torch.logsumexp(scores.masked_fill(~allowed, float("-inf")), dim=-1)
    assert (lse - want).abs().max().item() <= 1e-5


def test_flash_fwd_f32_ptxas_shows_no_spills(cuda):
    """:func:`assert_ptxas_clean` for the f32 forward (the six-part kernel
    at D 16, 32, 64 with one and two warpgroups), whose launch bounds ask
    for one block an SM (its shared memory at D = 64 allows no more), so
    up to 255 registers a thread."""
    assert_ptxas_clean((("flash_attention", ("flash_fwd_f32",), 6),), max_registers=255)


@pytest.mark.parametrize("b,t,h,d,mask_kind", [(64, 512, 12, 64, "right"), (4, 256, 12, 64, "random"),
                                               (2, 2048, 2, 64, "middle"), (3, 77, 2, 32, "left")])
def test_flash_fwd_bf16_is_deterministic(cuda, b, t, h, d, mask_kind):
    """Two bf16 forward calls on the same inputs give the same out and lse
    bit for bit (no atomics, no order that depends on the schedule)."""
    q, k, v, mask = attention_problem(b, t, h, d, torch.bfloat16, mask=mask_kind)
    first = flash_attention_fwd(q, k, v, mask, with_lse=True)
    second = flash_attention_fwd(q, k, v, mask, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


# (Q, N, D) cutting the kernel's tiles: 64- and 128-query blocks, 128-row
# tiles, D padded to 16 bytes of the passages; D=1040 is int8's exact limit;
# the small-Q tiles' query buckets (2, 16) and the first Q past one (17:
# the 32-query bucket, 15 rows empty); the int8 kernel's tiles (128 queries,
# two warpgroups of 64, x 128 or 256 rows, 128 bytes of k a stage): Q = 1,
# 63-65, 257 and 512 against N = 128 and 384 (fewer tiles than the
# persistent grid's blocks), 4224 (one wave at Q=512), 32768 and 65536
# (several tiles a block, the ring running across them), D = 16, 112, 1040
SCORE_SHAPES = [(70, 384, 100), (512, 4096, 768), (1, 128, 8), (63, 384, 768),
                (64, 4224, 100), (65, 4224, 8), (129, 384, 768), (512, 4224, 100),
                (65, 384, 1040), (2, 4224, 768), (16, 384, 100), (17, 384, 1040),
                (1, 4224, 16), (63, 128, 112), (64, 384, 1040), (65, 128, 16),
                (257, 4224, 112), (512, 128, 1040), (257, 65536, 112), (512, 32768, 1040)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("group", [8, 16, 32, 128])
@pytest.mark.parametrize("qn,n,d", SCORE_SHAPES)
def test_scores_groupmax_kernel_matches_plain(cuda, dtype, group, qn, n, d):
    q, p = search_problem(qn, n, d, dtype, seed=1)
    before = fused_scores_groupmax.launches
    s, g = fused_scores_groupmax(q, p, group)
    torch.cuda.synchronize()
    assert fused_scores_groupmax.launches == before + 1
    s_ref, g_ref = fused_scores_groupmax_plain(q, p, group)
    if dtype == torch.int8:  # tensor-core integer sums: equal, kernel 3's maxima too
        assert torch.equal(s, s_ref) and torch.equal(g, g_ref)
        assert torch.equal(streaming_groupmax(q, p, group), g_ref)
    tol = 1e-5 * q.norm(dim=1)[:, None] * p.float().norm(dim=1).max()
    assert bool(((s - s_ref).abs() <= tol).all())
    assert torch.equal(g, s.view(qn, n // group, group).amax(-1))


@pytest.mark.parametrize("group", [8, 128])
@pytest.mark.parametrize("qn,n", [(1, 384), (65, 4224), (512, 32768)])
def test_int8_scores_exact_at_the_edge(cuda, qn, n, group):
    """Every element at +-127 at D=1040, the largest D whose int8 sums stay
    exact in f32 (1040 * 127^2 < 2^24); query 0 and passage 0 all +127, so
    one score is the largest sum there is. Kernels 2 and 3 equal the plain
    version (f32 sums of integers below 2^24: exact) and the integer
    oracle."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = 127.0 * (2.0 * torch.randint(0, 2, (qn, 1040), generator=gen, device="cuda") - 1.0)
    p = (127 * (2 * torch.randint(0, 2, (n, 1040), generator=gen, device="cuda") - 1)).to(
        torch.int8)
    q[0], p[0] = 127.0, 127
    s, g = fused_scores_groupmax(q, p, group)
    s_ref, g_ref = fused_scores_groupmax_plain(q, p, group)
    exact = (q.cpu().to(torch.int64) @ p.cpu().to(torch.int64).T).to(torch.float32)
    assert s_ref[0, 0].item() == 1040 * 127 ** 2
    assert torch.equal(s_ref.cpu(), exact)
    assert torch.equal(s, s_ref) and torch.equal(g, g_ref)
    assert torch.equal(streaming_groupmax(q, p, group), g_ref)


def test_scores_groupmax_kernel_rejects_bad_shapes(cuda):
    q = torch.randn(4, 32, device="cuda")
    with pytest.raises(ValueError, match="tile"):
        fused_scores_groupmax(q, torch.randn(100, 32, device="cuda"), 32)
    with pytest.raises(ValueError, match="group"):
        fused_scores_groupmax(q, torch.randn(128, 32, device="cuda"), 24)
    with pytest.raises(ValueError, match="f32, bf16 or int8"):
        fused_scores_groupmax(q, torch.randn(128, 32, device="cuda").half(), 32)
    with pytest.raises(ValueError, match="exact only"):
        fused_scores_groupmax(torch.zeros(4, 1056, device="cuda"),
                              torch.zeros(128, 1056, dtype=torch.int8, device="cuda"), 32)


def score_config(p_dtype, qn, d):
    """``convdr_scores_groupmax_config`` for (passage dtype code, Q, D):
    threads, shared bytes, query rows a block, blocks an SM, path (0 the
    f32 six-part kernel, 2 int8, 3 bf16), persistent blocks an SM."""
    fn = cuda_build.bind("scores_groupmax", "convdr_scores_groupmax_config",
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = (ctypes.c_int * 6)()
    assert fn(p_dtype, qn, d, ctypes.addressof(out)) == 0
    return list(out)


def score_path(p_dtype, qn, d):
    """The path ``convdr_scores_groupmax_config`` reports for (passage
    dtype code, Q, D): 0 the f32 six-part kernel, 2 int8, 3 bf16."""
    return score_config(p_dtype, qn, d)[4]


@pytest.mark.parametrize("qn", [1, 64, 65, 512])
@pytest.mark.parametrize("d", [16, 768, 1040])
def test_int8_score_config_reports_the_wgmma_kernel(cuda, qn, d):
    """int8 passages take the wgmma kernel (path 2) at every Q and D: a
    producer warp and two consumer warpgroups (288 threads), 128 query rows
    a block, kernel 2's shared memory (a 3-stage ring of 48 KB, two 16 KB
    staging halves a warpgroup, 1 KB of alignment, the barriers) within a
    block's limit, one block an SM, a persistent grid of one block an SM."""
    threads, smem, rows, per_sm, path, persistent = score_config(2, qn, d)
    props = torch.cuda.get_device_properties(0)
    assert (path, threads, rows, per_sm, persistent) == (2, 288, 128, 1, 1)
    assert smem == 1024 + 3 * 49152 + 4 * 16384 + 2 * 8 * 3
    assert smem <= getattr(props, "shared_memory_per_block_optin",
                           props.shared_memory_per_multiprocessor - 1024)


def test_int8_score_kernel_ptxas_shows_no_spills(cuda):
    """ptxas's report of the int8 kernels (kernel 2 and pass A): registers
    within the cap of one 288-thread block an SM (65536 / 384, 168 in
    ptxas's multiples of 8), no spill stores or loads, and no serialized
    wgmma pipeline (C7510, C7511, C7515, C7518: "Potential Performance
    Loss")."""
    cuda_build.build(["scores_groupmax"])
    report = cuda_build.ptxas_report("scores_groupmax")
    entries, entry = {}, None
    for line in report:
        if "Compiling entry function" in line:
            entry = line if "scores_groupmax_s8" in line else None
            if entry:
                entries[entry] = []
        elif entry:
            entries[entry].append(line)
    assert len(entries) == 2, report
    for name, lines in entries.items():
        text = "\n".join(lines)
        assert "0 bytes spill stores, 0 bytes spill loads" in text, (name, text)
        regs = [int(w) for line in lines if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        assert regs and regs[0] <= 168, (name, text)
    assert not [line for line in report
                if "Performance Loss" in line and "scores_groupmax_s8" in line], report


@pytest.mark.parametrize("qn", [1, 8, 9, 16, 17, 32, 33, 64, 65, 512])
@pytest.mark.parametrize("d", [16, 768, 1040])
def test_bf16_score_config_reports_the_wgmma_kernel(cuda, qn, d):
    """bf16 passages take the three-part wgmma kernel (path 3) at every Q
    and D: a producer warp and two consumer warpgroups (288 threads), one
    block an SM, a persistent grid; 128 query rows a block past Q=64, and
    Q rounded up to 8, 16, 32 or 64 up to it (the passages as A); the
    shared memory within a block's limit."""
    threads, smem, rows, per_sm, path, persistent = score_config(1, qn, d)
    props = torch.cuda.get_device_properties(0)
    want_rows = 128 if qn > 64 else next(b for b in (8, 16, 32, 64) if qn <= b)
    assert (path, threads, rows, per_sm, persistent) == (3, 288, want_rows, 1, 1)
    assert smem <= getattr(props, "shared_memory_per_block_optin",
                           props.shared_memory_per_multiprocessor - 1024)


@pytest.mark.parametrize("qn", [1, 8, 9, 16, 17, 32, 33, 64, 65, 512])
@pytest.mark.parametrize("d", [16, 768, 1040])
def test_f32_score_config_reports_the_wgmma_kernel(cuda, qn, d):
    """f32 passages take the six-part wgmma kernel (path 0) at every Q and
    D: a producer warp and two consumer warpgroups (288 threads), one block
    an SM, a persistent grid; 128 query rows a block past Q=64, and Q
    rounded up to 8, 16, 32 or 64 up to it; the shared memory within a
    block's limit (at Q > 64: a 4-stage ring of 40 KB, two 12 KB part
    buffers a warpgroup, the warps' maxima of 128 queries, the barriers)."""
    threads, smem, rows, per_sm, path, persistent = score_config(0, qn, d)
    props = torch.cuda.get_device_properties(0)
    want_rows = 128 if qn > 64 else next(b for b in (8, 16, 32, 64) if qn <= b)
    assert (path, threads, rows, per_sm, persistent) == (0, 288, want_rows, 1, 1)
    if qn > 64:
        assert smem == 1024 + 4 * 40960 + 4 * 12288 + 8 * 128 * 4 + 2 * 8 * 4
    assert smem <= getattr(props, "shared_memory_per_block_optin",
                           props.shared_memory_per_multiprocessor - 1024)


def assert_ptxas_clean(sources, max_registers=168):
    """ptxas's report of the kernels whose entries name a mark, per source
    (name, marks, entries expected): registers within the cap of one
    288-thread block an SM (168; ``max_registers`` for kernels bounded
    otherwise), no spill stores or loads, no stack, and no serialized or
    waited-on wgmma pipeline (C7510, C7511, C7514, C7515, C7517, C7518)."""
    cuda_build.build([name for name, _marks, _count in sources])
    for name, marks, count in sources:
        report = cuda_build.ptxas_report(name)
        entries, entry = {}, None
        for line in report:
            if "Compiling entry function" in line:
                entry = line if any(m in line for m in marks) else None
                if entry:
                    entries[entry] = []
            elif entry:
                entries[entry].append(line)
        assert len(entries) == count, report
        for entry_name, lines in entries.items():
            text = "\n".join(lines)
            assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in text, (
                entry_name, text)
            regs = [int(w) for line in lines if "registers" in line
                    for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
            assert regs and regs[0] <= max_registers, (entry_name, text)
        assert not [line for line in report if any(m in line for m in marks)
                    and any(f"(C75{c})" in line for c in ("10", "11", "14", "15", "17", "18"))], report


def test_bf16_score_kernels_ptxas_show_no_spills(cuda):
    """:func:`assert_ptxas_clean` for the bf16 kernels (kernels 2 and 3 at
    both tile kinds, kernel 4 at every G)."""
    assert_ptxas_clean((("scores_groupmax", ("scores_groupmax_bf16",), 10),
                        ("streaming_search", ("extract_candidates_bf16",), 5)))


def test_f32_score_kernels_ptxas_show_no_spills(cuda):
    """:func:`assert_ptxas_clean` for the f32 six-part kernels (kernels 2
    and 3 at both tile kinds and every query bucket, kernel 4 at every G)."""
    assert_ptxas_clean((("scores_groupmax", ("scores_groupmax_f32",), 10),
                        ("streaming_search", ("extract_candidates_f32",), 5)))


def wgmma_probe(a, b, n_inst, blocks=1, a_shift=0, b_shift=0, swap=0):
    """``convdr_wgmma_bf16_probe``: [blocks, 64, n_inst] f32 accumulators of
    the three-part product of a [3, 64, D] (A's rows) and b [3, 256, D]
    (B's rows), A row i at tile row (i + a_shift) % 64, B row r at (r +
    b_shift) % n_inst; swap 1 takes a[0] as A and b's parts as B."""
    fn = cuda_build.bind("scores_groupmax", "convdr_wgmma_bf16_probe",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = torch.empty((blocks, 64, n_inst), dtype=torch.float32, device=a.device)
    rc = cuda_build.launch(fn, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), blocks,
                           n_inst, a.shape[-1], a_shift, b_shift, swap)
    assert rc == 0, rc
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("d", [64, 768])
def test_wgmma_bf16_bits_depend_only_on_rows_and_k_order(cuda, d):
    """The property the bf16 kernels' bit-equalities rest on: an output of
    the three-part bf16 wgmma product (k-steps in order, parts 1, 2, 3 in
    each) depends on its A row, its B row and that order only. The same
    operands give the same bits at every instruction N (8..256), with the
    A row at any place in the 64-row tile, the B row at any place in the
    N-row tile, in every block, and with the roles swapped (passages as A,
    the query parts as B, as the small-Q tiles take them). Queries span
    2^-12..2^12 in scale, so that the products' alignment in the sums
    varies from row to row."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = torch.exp2(torch.randint(-12, 12, (256, d), generator=gen, device="cuda").float())
    q = torch.randn(256, d, generator=gen, device="cuda") * scale
    parts = bf16_query_parts(q)  # [3, 256, d]
    p = (torch.randn(256, d, generator=gen, device="cuda") * scale.flip(0)).bfloat16()
    a = parts[:, :64].contiguous()
    b = torch.zeros(3, 256, d, dtype=torch.bfloat16, device="cuda")
    b[0] = p
    ref = wgmma_probe(a, b, 256, blocks=4)
    assert all(torch.equal(ref[0], ref[i]) for i in range(1, 4))
    for n_inst in (8, 16, 32, 64, 128):
        assert torch.equal(wgmma_probe(a, b, n_inst)[0], ref[0, :, :n_inst]), n_inst
    rows = torch.arange(64, device="cuda")
    for shift in (1, 8, 17, 63):
        assert torch.equal(wgmma_probe(a, b, 256, a_shift=shift)[0][(rows + shift) % 64],
                           ref[0]), shift
    for n_inst, shift in ((256, 1), (256, 100), (64, 9), (8, 3)):
        cols = (torch.arange(n_inst, device="cuda") + shift) % n_inst
        got = wgmma_probe(a, b, n_inst, b_shift=shift)[0]
        assert torch.equal(got[:, cols], ref[0, :, :n_inst]), (n_inst, shift)
    a2 = torch.zeros(3, 64, d, dtype=torch.bfloat16, device="cuda")
    a2[0] = p[:64]
    b2 = torch.zeros(3, 256, d, dtype=torch.bfloat16, device="cuda")
    b2[:, :64] = a
    for n_inst in (8, 64):
        got = wgmma_probe(a2, b2, n_inst, swap=1)[0]  # [passage, query]
        assert torch.equal(got.T, ref[0, :n_inst, :64]), n_inst
    exact = q[:64].double() @ p.double().T
    assert bool(((ref[0] - exact).abs() <= bf16_score_bound(q[:64], p)).all())


def bf16_score_bound(q, p):
    """2 D 2^-24 sum_k |q_k p_k| for every (query, passage): the classical
    bound of an f32 sum of D terms (D 2^-24 of the sum of magnitudes, the
    terms exact: each bf16 part of q times a bf16 p is), doubled because a
    tensor core may truncate where an FMA rounds to nearest (a truncated
    sum loses up to one ulp a step, a rounded one half)."""
    d = q.shape[1]
    return 2 * d * 2.0 ** -24 * (q.double().abs() @ p.double().abs().T)


@pytest.mark.parametrize("qn", [1, 17, 65, 512])
@pytest.mark.parametrize("d", [8, 100, 768, 1040])
def test_f32_scores_within_the_f64_bound(cuda, qn, d):
    """Kernels 2, 3 and 4 on f32 passages against the f64 product of the
    same f32 operands: every score within ``bf16_score_bound`` (the
    six-part product drops terms below 2^-20 sum |q_k p_k|, far inside
    it) and within 1e-5 |q| max|p| of the plain f32 product; pass A's
    maxima and pass B's candidates (every group) equal kernel 2's."""
    n, group = 4224, 32
    q, p = search_problem(qn, n, d, torch.float32, seed=11)
    s, g = fused_scores_groupmax(q, p, group)
    m = streaming_groupmax(q, p, group)
    gsel = torch.arange(n // group, device="cuda").expand(qn, -1).contiguous()
    cand = extract_candidate_scores(q, p, gsel, group)
    torch.cuda.synchronize()
    exact = q.double() @ p.double().T
    assert bool(((s.double() - exact).abs() <= bf16_score_bound(q, p)).all())
    tol = 1e-5 * q.norm(dim=1)[:, None] * p.norm(dim=1).max()
    assert bool(((s - fused_scores_groupmax_plain(q, p, group)[0]).abs() <= tol).all())
    assert torch.equal(m, g) and torch.equal(cand.reshape(qn, n), s)


@pytest.mark.parametrize("qn", [1, 64, 65, 512])
@pytest.mark.parametrize("d", [768, 1040])
def test_f32_scores_on_near_parallel_rows_within_the_f32_tolerance(cuda, qn, d):
    """Near-parallel positive rows, 1 + 0.01 N(0, 1): long one-signed sums,
    where every add of a truncating tensor-core sum loses toward zero. The
    six-part scores stay within the unchanged 1e-5 |q| max|p| of the plain
    f32 product (one sum for all six products broke it) and within
    ``bf16_score_bound`` of f64; kernels 3 and 4 equal kernel 2."""
    n, group = 4224, 128
    gen = torch.Generator(device="cuda").manual_seed(13)
    q = 1 + 0.01 * torch.randn(qn, d, generator=gen, device="cuda")
    p = 1 + 0.01 * torch.randn(n, d, generator=gen, device="cuda")
    s, g = fused_scores_groupmax(q, p, group)
    gsel = torch.arange(n // group, device="cuda").expand(qn, -1).contiguous()
    cand = extract_candidate_scores(q, p, gsel, group)
    torch.cuda.synchronize()
    tol = 1e-5 * q.norm(dim=1)[:, None] * p.norm(dim=1).max()
    assert bool(((s - fused_scores_groupmax_plain(q, p, group)[0]).abs() <= tol).all())
    assert bool(((s.double() - q.double() @ p.double().T).abs() <= bf16_score_bound(q, p)).all())
    assert torch.equal(streaming_groupmax(q, p, group), g)
    assert torch.equal(cand.reshape(qn, n), s)


@pytest.mark.parametrize("qn", [1, 17, 65, 512])
@pytest.mark.parametrize("d", [8, 100, 768, 1040])
def test_bf16_scores_within_the_f64_bound(cuda, qn, d):
    """Kernels 2, 3 and 4 on bf16 passages against the f64 product of the
    same f32 queries and bf16 passages: every score within
    ``bf16_score_bound``; pass A's maxima and pass B's candidates (every
    group) equal kernel 2's."""
    n, group = 4224, 32
    q, p = search_problem(qn, n, d, torch.bfloat16, seed=11)
    s, g = fused_scores_groupmax(q, p, group)
    m = streaming_groupmax(q, p, group)
    gsel = torch.arange(n // group, device="cuda").expand(qn, -1).contiguous()
    cand = extract_candidate_scores(q, p, gsel, group)
    torch.cuda.synchronize()
    exact = q.double() @ p.double().T
    assert bool(((s.double() - exact).abs() <= bf16_score_bound(q, p)).all())
    assert torch.equal(m, g) and torch.equal(cand.reshape(qn, n), s)


def small_q_max(p_dtype, d=768):
    """Q*: the largest Q the small-Q tiles take at this D (f32 and bf16:
    the passages as A, which report the queries rounded up to 8-64 as a
    block's rows, against the 128 of the query tiles)."""
    return max(qn for qn in range(1, 129) if score_config(p_dtype, qn, d)[2] < 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [8, 32, 64, 128])
@pytest.mark.parametrize("d", [100, 768, 1040])
@pytest.mark.parametrize("n", [384, 4224])
def test_small_q_path_equals_tile_path(cuda, dtype, group, d, n):
    """Kernels 2 and 3 at Q in {1, 2, 3, 8, Q*-1, Q*} and at each query
    bucket's edges (the small-Q tiles: the passages as wgmma's A) equal the
    first Q rows of a Q=65 batch (the 128-query tiles) bit for bit: the
    direct proof that the small-Q tiles keep each score's six-part (f32)
    or three-part (bf16) product."""
    code = 0 if dtype == torch.float32 else 1
    path = 0 if code == 0 else 3  # the kernels' path code: both tile kinds
    top = small_q_max(code)
    q, p = search_problem(65, n, d, dtype, seed=5)
    assert score_config(code, 65, d)[2] == 128 and score_path(code, 65, d) == path
    s_tile, g_tile = fused_scores_groupmax(q, p, group)
    m_tile = streaming_groupmax(q, p, group)
    for qn in sorted({1, 2, 3, 8, 9, 16, 17, 32, 33, top - 1, top}):
        assert score_config(code, qn, d)[2] < 128 and score_path(code, qn, d) == path
        s, g = fused_scores_groupmax(q[:qn], p, group)
        torch.cuda.synchronize()
        assert torch.equal(s, s_tile[:qn]) and torch.equal(g, g_tile[:qn]), qn
        assert torch.equal(streaming_groupmax(q[:qn], p, group), m_tile[:qn]), qn
    assert score_config(code, top + 1, d)[2] == 128  # past Q*: the query tiles
    assert score_path(2, 1, d) == 2  # int8 takes its wgmma kernel at every Q


@pytest.mark.parametrize("qn", [65, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_score_kernels_take_unaligned_operands(cuda, dtype, qn):
    # views 4 bytes (one f32) past a 16-byte boundary: the wrapper copies them
    q, p = search_problem(qn, 384, 96, dtype, seed=2)
    flat_q = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    flat_p = torch.empty(p.numel() * p.element_size() + 4, dtype=torch.uint8, device="cuda")
    q_off = flat_q[1:].view(q.shape).copy_(q)
    p_off = flat_p[4:].view(p.dtype).view(p.shape).copy_(p)
    assert q_off.data_ptr() % 16 and p_off.data_ptr() % 16
    s, g = fused_scores_groupmax(q, p, 32)
    s2, g2 = fused_scores_groupmax(q_off, p_off, 32)
    assert torch.equal(s, s2) and torch.equal(g, g2)
    assert torch.equal(streaming_groupmax(q_off, p_off, 32), g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("qn,n,d", [(1, 128, 8), (65, 4224, 100), (129, 384, 768),
                                    (1, 4224, 768), (2, 384, 100), (3, 384, 1040),
                                    (8, 4224, 100), (31, 384, 768), (32, 128, 1040),
                                    (5, 384, 98), (70, 384, 98)])
def test_pass_b_over_every_group_equals_score_kernel(cuda, dtype, group, qn, n, d):
    """Pass B given every group of the block scores every (query, row):
    equal to kernel 2's whole score matrix, the direct proof that both keep
    one six-part product order (f32), one three-part product order (bf16)
    or exact integer sums (int8); at D=98 both wrappers pad the rows (f32
    to 4, bf16 to 8 for kernel 2)."""
    q, p = search_problem(qn, n, d, dtype, seed=3)
    scores, gmax = fused_scores_groupmax(q, p, group)
    gsel = torch.arange(n // group, device="cuda").expand(qn, -1).contiguous()
    cand = extract_candidate_scores(q, p, gsel, group)
    torch.cuda.synchronize()
    assert torch.equal(cand.reshape(qn, n), scores)
    assert torch.equal(streaming_groupmax(q, p, group), gmax)


def test_flat_ip_topk_on_card_matches_oracle_and_cpu(cuda):
    rng = np.random.RandomState(2)
    q = rng.randn(6, 48).astype(np.float32)
    p = rng.randn(3000, 48).astype(np.float32)
    p[[7, 900, 2999]] = p[100]  # exact ties across blocks
    os_, oi = es.topk_oracle(q, p, 40)
    for block_rows in (512, 65536):
        s, i = es.flat_ip_topk(torch.from_numpy(q).cuda(), torch.from_numpy(p).cuda(), 40,
                               block_rows=block_rows)
        np.testing.assert_array_equal(i.cpu().numpy(), oi)
        np.testing.assert_allclose(s.cpu().numpy(), os_, rtol=1e-5)
    s, i = fused_flat_ip_topk(torch.from_numpy(q).cuda(), torch.from_numpy(p[:50]).cuda(), 60)
    np.testing.assert_array_equal(i.cpu().numpy(), es.topk_oracle(q, p[:50], 60)[1])


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_blocked_searcher_on_card_matches_cpu(cuda, storage):
    rng = np.random.RandomState(3)
    q = rng.randn(5, 32).astype(np.float32)
    p = rng.randn(5000, 32).astype(np.float32)
    emb2offset = np.arange(5000, dtype=np.int64) + 7
    cfg = SearchConfig(passage_block_size=1024, storage_dtype=storage,
                       max_device_block_bytes=1)  # also splits into sub-blocks
    s_gpu, o_gpu = BlockedSearcher(cfg, device=cuda).search_arrays(q, p, emb2offset, 30)
    s_cpu, o_cpu = BlockedSearcher(cfg, device=torch.device("cpu")).search_arrays(
        q, p, emb2offset, 30
    )
    for r in range(5):
        assert set(o_gpu[r]) == set(o_cpu[r])
    if storage == "float32":
        np.testing.assert_array_equal(o_gpu, o_cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_on_card_matches_cpu(cuda, dtype):
    from convdr_torch.core.loading import load_model_and_params

    _, _, cpu_model = load_model_and_params(
        "rdot_nll", None, device=torch.device("cpu"), arch_preset="tiny"
    )
    _, _, gpu_model = load_model_and_params(
        "rdot_nll", None, device=cuda, arch_preset="tiny", dtype=dtype
    )
    rng = np.random.RandomState(4)
    ids = rng.randint(5, 200, size=(4, 96)).astype(np.int64)
    lens = np.asarray([96, 50, 7, 1])
    mask = (np.arange(96)[None, :] < lens[:, None]).astype(np.int32)
    before = flash_attention.launches
    with torch.no_grad():
        got = gpu_model.body_emb(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda())
        want = cpu_model.body_emb(torch.from_numpy(ids), torch.from_numpy(mask))
    assert flash_attention.launches == before + 2  # tiny arch: two layers
    atol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=atol)


def bwd_problem(b, t, h, d, mask_kind):
    q, k, v, mask = attention_problem(b, t, h, d, torch.float32, mask=mask_kind)
    gen = torch.Generator(device="cuda").manual_seed(7)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    return q, k, v, mask, do


# (B, T, H, D): T values that cut the 64-row blocks and the 32-row tiles,
# the student's shape, and one long row (a plan of 257 tiles)
BWD_CASES = [(3, 100, 2, 64), (2, 77, 3, 32), (2, 40, 2, 16), (4, 64, 12, 64), (4, 256, 12, 64),
             (5, 200, 12, 64), (1, 8192, 1, 16)]


@pytest.mark.parametrize("mask_kind", ["right", "left", "middle", "random"])
@pytest.mark.parametrize("b,t,h,d", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, b, t, h, d, mask_kind):
    q, k, v, mask, do = bwd_problem(b, t, h, d, mask_kind)
    before = flash_attention_bwd.launches
    out = FlashAttentionFn.apply(q.requires_grad_(), k.requires_grad_(),
                                 v.requires_grad_(), mask)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1  # one launch: dQ, dK and dV
    want = flash_attention_bwd_plain(q, k, v, out.detach(), do, mask)
    for g, r in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()


@pytest.mark.parametrize("b,t,h,d,mask_kind", [(4, 256, 12, 64, "random"), (3, 100, 2, 32, "middle")])
def test_flash_bwd_is_deterministic(cuda, b, t, h, d, mask_kind):
    """No atomics: two calls on the same inputs give bit-identical gradients."""
    q, k, v, mask, do = bwd_problem(b, t, h, d, mask_kind)
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    first = flash_attention_bwd(q, k, v, out, do, mask, lse)
    second = flash_attention_bwd(q, k, v, out, do, mask, lse)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,t", [(4, 256), (8, 512)])
def test_flash_bwd_f32_config(cuda, b, t):
    """The f32 backward: one warpgroup of 128 threads (its thread 0 issues
    the copies), 64 rows a block, 32-row streamed tiles, two blocks an SM
    (each at most half the SM's shared memory; registers up to 255)."""
    cfg = flash_attention_bwd_config(b, t, 12, 64)
    props = torch.cuda.get_device_properties(0)
    assert (cfg["threads"], cfg["block_rows"], cfg["tile_rows"]) == (128, 64, 32)
    assert cfg["blocks_per_sm"] == 2
    assert 2 * cfg["smem_bytes"] <= props.shared_memory_per_multiprocessor


def test_flash_bwd_f32_ptxas_shows_no_spills(cuda):
    """:func:`assert_ptxas_clean` for the f32 backward (the six-part kernel
    at D 16, 32, 64), whose launch bounds ask for two 128-thread blocks an
    SM, so up to 255 registers a thread."""
    assert_ptxas_clean((("flash_attention_bwd", ("flash_bwd_f32",), 3),), max_registers=255)


@pytest.mark.parametrize("case", attention_bwd_bench.NEAR_PARALLEL_CASES)
def test_flash_bwd_f32_near_parallel_rows_against_f64(cuda, case):
    """Near-parallel positive rows (1 + 0.01 N(0, 1)) at T=8192 (a plan of
    257 tiles, the longest sums) and the student's shape, against the plain
    backward in f64 (``attention_bwd_bench.near_parallel_errors``): each
    gradient within 1e-5 of the f64 sum of the magnitudes of the terms that
    enter it, element by element, and dV within 1e-5 of max|dV|. Not dQ
    and dK of their max: on these rows they are small beside the terms
    they sum, and the f32 roundings of D = rowsum(dO O) and of dP - D,
    which any f32 backward has, make most of dQ's error (0.30 of max|dQ|
    at T=8192, the f32 plain backward 0.05). The three bf16 parts' last
    three products left out give dV 4e-5-6e-5 of max|dV| (the kernel
    1.3e-6); one part gives dV 2e-5 of its terms."""
    errors = attention_bwd_bench.near_parallel_errors(attention_module, case)
    assert errors["finite"]
    for name, ratio in zip(("dq", "dk", "dv"), errors["ratio"]):
        assert ratio <= 1e-5, (name, ratio)
    assert errors["of_scale"][2] <= 1e-5, errors["of_scale"]


# The bf16 backward's gradients on the seeded problems of
# attention_bwd_bench.digest_problem: digests of the tree before the f32
# backward's redesign, on the card, which the redesign keeps
BF16_BWD_DIGESTS = {
    (4, 256, 12, 64, "random"): "91f258aff5e172f320353ff7917bc29a",
    (3, 77, 2, 32, "left"): "2b6292e905837f924940792173c0b5fc",
    (2, 65, 2, 16, "middle"): "dd09d2cb6618016e754310d0f646867b",
}


@pytest.mark.parametrize("case", list(BF16_BWD_DIGESTS))
def test_flash_bwd_bf16_gradients_unchanged(cuda, case):
    """The bf16 backward's dQ, dK, dV bit for bit as before the f32
    backward's redesign (the digest of their bytes)."""
    q, k, v, mask, do = attention_bwd_bench.digest_problem(*case, torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    grads = flash_attention_bwd(q, k, v, out, do, mask, lse)
    torch.cuda.synchronize()
    assert digest(*grads) == BF16_BWD_DIGESTS[case]


def test_flash_bwd_bf16_launches_once_with_finite_grads(cuda):
    """bf16 training raised NOT_PORTED once; now its forward (with lse) and
    its backward each launch once and give finite bf16 gradients."""
    q, k, v, mask = attention_problem(2, 16, 2, 64, torch.bfloat16)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, mask)
    grads = torch.autograd.grad(out, leaves, torch.ones_like(out))
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in grads)


# bf16 training: the forward's lse and the backward in bf16 at the student's
# shape, its targets' T=64, a T that cuts the 64-row tiles, other head dims,
# and (forward) a row long enough for the accumulator flushes
BF16_LSE_CASES = [(4, 256, 12, 64), (4, 64, 12, 64), (5, 200, 12, 64), (3, 77, 2, 32),
                  (2, 40, 2, 16), (1, 3000, 1, 64)]
BF16_BWD_CASES = [(4, 256, 12, 64), (4, 64, 12, 64), (5, 200, 12, 64), (3, 77, 2, 32),
                  (2, 40, 2, 16), (2, 513, 2, 64),
                  # many planned tiles with segment gaps (random mask), a long
                  # row; 32-row TMA boxes that straddle T
                  (2, 1024, 2, 64), (1, 3000, 1, 64), (2, 63, 3, 64), (3, 65, 2, 32),
                  (2, 65, 2, 16)]


@pytest.mark.parametrize("mask_kind", ["right", "left", "middle", "random"])
@pytest.mark.parametrize("b,t,h,d", BF16_LSE_CASES)
def test_flash_forward_bf16_lse(cuda, b, t, h, d, mask_kind):
    """bf16 with lse: lse within 1e-5 relative of torch.logsumexp of the
    masked, scaled f32 scores of the bf16 operands (f32 sums of another
    order); out bit-identical to the launch without lse."""
    q, k, v, mask = attention_problem(b, t, h, d, torch.bfloat16, mask=mask_kind)
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    bare, none = flash_attention_fwd(q, k, v, mask, with_lse=False)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, bare)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    want = torch.logsumexp(scores.masked_fill(~allowed, float("-inf")), dim=-1)
    assert lse.dtype == torch.float32 and bool(torch.isfinite(lse).all())
    assert bool(((lse - want).abs() <= 1e-5 * want.abs() + 1e-6).all())


def bf16_bwd_errors(q, k, v, mask, do):
    """Each gradient's largest error over its largest entry, against the
    plain backward in f64 of the same bf16 operands: the kernel's, and
    autograd's through masked SDPA in bf16 (the library's)."""
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    got = flash_attention_bwd(q, k, v, out, do, mask, lse)
    x = [t.double() for t in (q, k, v, do)]
    want = flash_attention_bwd_plain(x[0], x[1], x[2], None, x[3], mask)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=allowed)
    lib = [g.transpose(1, 2) for g in torch.autograd.grad(lib_out, leaves, do.transpose(1, 2))]
    torch.cuda.synchronize()
    err = lambda g, w: ((g.double() - w).abs().max() / w.abs().max()).item()  # noqa: E731
    return got, [err(g, w) for g, w in zip(got, want)], [err(g, w) for g, w in zip(lib, want)]


@pytest.mark.parametrize("mask_kind", ["right", "left", "middle", "random"])
@pytest.mark.parametrize("b,t,h,d", BF16_BWD_CASES)
def test_flash_bwd_bf16_kernel_against_f64_and_sdpa(cuda, b, t, h, d, mask_kind):
    """The bf16 backward: one launch, bf16 gradients, each within 2x the
    error of autograd through masked SDPA in bf16 (floor 1e-3 of scale)
    from the f64 plain witness, and two calls bit-identical (no atomics)."""
    q, k, v, mask = attention_problem(b, t, h, d, torch.bfloat16, mask=mask_kind)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(7),
                     device="cuda").to(torch.bfloat16)
    before = flash_attention_bwd.launches
    got, kernel_err, lib_err = bf16_bwd_errors(q, k, v, mask, do)
    assert flash_attention_bwd.launches == before + 1
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in got)
    for name, ke, le in zip(("dq", "dk", "dv"), kernel_err, lib_err):
        assert ke <= 2 * max(le, 1e-3), (name, ke, le)
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    first = flash_attention_bwd(q, k, v, out, do, mask, lse)
    second = flash_attention_bwd(q, k, v, out, do, mask, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


def test_flash_bwd_bf16_config(cuda):
    """One consumer warpgroup and one producer warp, 64 rows a block, 32-row
    streamed tiles; at the student's shape (B=4 T=256 H=12) its 2 x 4 x 12
    x 4 = 384 blocks run in one wave."""
    cfg = flash_attention_bwd_config(4, 256, 12, 64, torch.bfloat16)
    assert (cfg["threads"], cfg["block_rows"], cfg["tile_rows"]) == (160, 64, 32)
    blocks = 2 * (256 // cfg["block_rows"]) * 12 * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cfg["blocks_per_sm"] >= 3 and blocks <= cfg["blocks_per_sm"] * sms


@pytest.mark.parametrize("b,t,h,d", [(4, 256, 12, 64), (3, 65, 2, 32), (2, 40, 3, 16)])
def test_flash_bwd_f32_delta_prepass(cuda, b, t, h, d):
    """The f32 pre-pass's D = rowsum(o * dO) [B, H, T] against the f64 sum,
    within 1e-6 of the row's sum of |o * dO| (eight f32 fmaf a lane, then
    a shuffle tree)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    o, do = (torch.randn((b, t, h, d), generator=gen, device="cuda") for _ in range(2))
    got = flash_attention_bwd_delta(o, do)
    torch.cuda.synchronize()
    prod = o.double() * do.double()
    want = prod.sum(-1).transpose(1, 2)
    bound = 1e-6 * prod.abs().sum(-1).transpose(1, 2)
    assert got.shape == (b, h, t) and got.dtype == torch.float32
    assert bool(((got.double() - want).abs() <= bound).all())


@pytest.mark.parametrize("b,t,h,d", [(4, 256, 12, 64), (3, 65, 2, 32), (2, 40, 3, 16)])
def test_flash_bwd_bf16_delta_prepass(cuda, b, t, h, d):
    """The pre-pass's D = rowsum(o * dO) [B, H, T] against the f32 sum of
    the same bf16 products, within 1e-5 of the row's sum of |o * dO| (f32
    sums in another order)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    o, do = (torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    got = flash_attention_bwd_delta(o, do)
    torch.cuda.synchronize()
    prod = o.float() * do.float()
    want = prod.sum(-1).transpose(1, 2)
    bound = 1e-5 * prod.abs().sum(-1).transpose(1, 2)
    assert got.shape == (b, h, t) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= bound).all())


def test_train_step_on_card_matches_cpu(cuda):
    """One KD + ranking step of the tiny model at the port's init: the
    card's gradients (both flash kernels) against the CPU's (both plain
    versions). The key biases' gradient is zero in exact arithmetic
    (softmax shift invariance), rounding noise on both sides; it is held
    to 1e-4 of its layer's key-weight gradient."""
    import dataclasses

    from convdr_torch.core.config import TrainConfig
    from convdr_torch.core.loading import load_model_and_params
    from convdr_torch.train.trainer import create_train_state, make_train_step

    rng = np.random.RandomState(5)
    b, k, t, length = 3, 4, 40, 56
    ids = rng.randint(5, 200, size=(b, t)).astype(np.int32)
    mask = (np.arange(t)[None, :] < np.asarray([40, 17, 3])[:, None]).astype(np.int32)
    doc_ids = rng.randint(5, 200, size=(b, k, length)).astype(np.int32)
    doc_mask = (np.arange(length) < rng.randint(1, length + 1, size=(b, k, 1))).astype(np.int32)
    batch = {"concat_ids": ids, "concat_mask": mask, "target_ids": ids[:, :16],
             "target_mask": mask[:, :16], "doc_ids": doc_ids, "doc_mask": doc_mask}
    cfg = dataclasses.replace(TrainConfig(ranking_task=True, num_negatives=k - 1),
                              learning_rate=1e-3)
    grads = {}
    for dev in (torch.device("cpu"), cuda):
        student, teacher = (
            load_model_and_params("rdot_nll", None, device=dev, arch_preset="tiny",
                                  seed=seed)[2]
            for seed in (1, 2))
        state, tx = create_train_state(student, cfg, 10)
        step = make_train_step(student, teacher, tx, cfg)
        _, metrics = step(state, {n: torch.from_numpy(a).to(dev) for n, a in batch.items()})
        grads[dev.type] = ({n: p.grad.cpu() for n, p in student.named_parameters()},
                           float(metrics["loss"]))
    (g_cpu, l_cpu), (g_gpu, l_gpu) = grads["cpu"], grads["cuda"]
    assert abs(l_cpu - l_gpu) <= 1e-5 * abs(l_cpu)
    for name, ref in g_cpu.items():
        scale_of = name.replace("key.bias", "key.weight") if name.endswith("key.bias") else name
        scale = g_cpu[scale_of].abs().max().item()
        assert (g_gpu[name] - ref).abs().max().item() <= 1e-4 * scale + 1e-9, name


# ---------------------------------------------------------------------------
# the streaming search, the group gather and int8 passages
# ---------------------------------------------------------------------------
SEARCH_SHAPES = [(70, 384, 100), (512, 524288, 768)]  # small, the main path's


def search_problem(qn, n, d, dtype, seed=0):
    """Queries and passages on the card; int8 passages come with the
    int-valued f32 queries of their quantizer."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(qn, d, generator=gen, device="cuda")
    p = torch.randn(n, d, generator=gen, device="cuda")
    if dtype == torch.int8:
        quant = Int8Quantizer.fit(p[:4096].cpu().numpy())
        q = torch.from_numpy(quant.quantize_queries(q.cpu().numpy())[0]).cuda()
        p = quantize_passages_dev(p, torch.from_numpy(quant.scales).cuda())
    return q, p.to(dtype)


def random_gsel(qn, n_groups, kg, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = torch.rand(qn, n_groups, generator=gen, device="cuda")
    return torch.sort(torch.topk(keys, kg, dim=1).indices, dim=1)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("group", [8, 32, 128])
@pytest.mark.parametrize("qn,n,d", SEARCH_SHAPES)
def test_streaming_passes_equal_score_kernel(cuda, dtype, group, qn, n, d):
    q, p = search_problem(qn, n, d, dtype)
    scores, gmax = fused_scores_groupmax(q, p, group)
    before = (streaming_groupmax.launches, extract_candidate_scores.launches)
    g = streaming_groupmax(q, p, group)
    gsel = random_gsel(qn, n // group, min(101, n // group))
    cand = extract_candidate_scores(q, p, gsel, group)
    torch.cuda.synchronize()
    assert (streaming_groupmax.launches, extract_candidate_scores.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(g, gmax)
    want = torch.gather(scores.view(qn, -1, group), 1,
                        gsel[:, :, None].expand(-1, -1, group))
    assert torch.equal(cand, want)
    tol = 1e-5 * q.norm(dim=1) * p.float().norm(dim=1).max()
    assert bool(((g - streaming_groupmax_plain(q, p, group)).abs() <= tol[:, None]).all())
    plain = extract_candidate_scores_plain(q, p, gsel, group)
    assert bool(((cand - plain).abs() <= tol[:, None, None]).all())
    if dtype == torch.int8:  # integer-exact: the plain version is equal
        assert torch.equal(scores, fused_scores_groupmax_plain(q, p, group)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("qn,n,d", [(70, 1000, 100), (64, 524288, 768)])
def test_streaming_topk_equals_flat_ip_topk(cuda, dtype, group, qn, n, d):
    q, p = search_problem(qn, n, d, dtype, seed=1)
    want_s, want_i = es.flat_ip_topk(q, p, 100)
    got_s, got_i = streaming_flat_ip_topk(q, p, 100, group=group)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)
    got_s, got_i = streaming_flat_ip_topk(q, p[: n - 37], 100, group=group, valid_rows=n - 60)
    want_s, want_i = es.flat_ip_topk(q, p[: n - 37], 100, valid_rows=n - 60)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)


def test_streaming_topk_on_card_matches_oracle(cuda):
    rng = np.random.RandomState(6)
    q = rng.randn(6, 48).astype(np.float32)
    p = rng.randn(3000, 48).astype(np.float32)
    p[[7, 900, 2999]] = p[100]  # exact ties
    s, i = streaming_flat_ip_topk(torch.from_numpy(q).cuda(), torch.from_numpy(p).cuda(), 40)
    os_, oi = es.topk_oracle(q, p, 40)
    np.testing.assert_array_equal(i.cpu().numpy(), oi)
    np.testing.assert_allclose(s.cpu().numpy(), os_, rtol=1e-5)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("qn,b,k,group", [(15, 1000, 7, 8), (512, 524288, 101, 32)])
def test_gather_groups_kernel_equals_torch_gather(cuda, idx_dtype, qn, b, k, group):
    gen = torch.Generator(device="cuda").manual_seed(2)
    scores = torch.randn(qn, b, generator=gen, device="cuda")
    gsel = random_gsel(qn, b // group, k).to(idx_dtype)
    before = dma_gather_groups.launches
    out = dma_gather_groups(scores, gsel, group=group)
    torch.cuda.synchronize()
    assert dma_gather_groups.launches == before + 1
    assert torch.equal(out, dma_gather_groups_plain(scores, gsel, group=group))
    with pytest.raises(ValueError, match="f32"):
        dma_gather_groups(scores.bfloat16(), gsel, group=group)


def test_flat_ip_topk_dma_gather_equals_auto(cuda):
    # every exact search on the card gathers its candidates with the kernel;
    # ``gather`` selects no code
    q, p = search_problem(64, 100000, 768, torch.float32, seed=3)
    before = dma_gather_groups.launches
    dma = es.flat_ip_topk(q, p, 100, gather="dma")
    assert dma_gather_groups.launches > before
    before = dma_gather_groups.launches
    auto = es.flat_ip_topk(q, p, 100)
    assert dma_gather_groups.launches > before
    assert torch.equal(dma[0], auto[0]) and torch.equal(dma[1], auto[1])


@pytest.mark.parametrize("bad", [-1, 524288 // 128])
def test_extract_candidates_rejects_out_of_range_ids_on_card(cuda, bad):
    q, p = search_problem(4, 524288, 768, torch.float32, seed=7)
    gsel = random_gsel(4, 524288 // 128, 5)
    gsel[2, 3] = bad
    with pytest.raises(IndexError, match="group ids"):
        extract_candidate_scores(q, p, gsel, 128)


def selection(kind, qn, n_groups, kg, seed=0):
    """[Q, kg] ascending group ids: "random" (each query its own kg),
    "one_group" (every query picks group n_groups // 2, so it is split
    into many work items, beside kg - 1 random ones) or "sparse" (3 picks
    a query from 8 groups, so most groups have no work item)."""
    if kind == "one_group":
        h = n_groups // 2
        rest = random_gsel(qn, n_groups - 1, kg - 1, seed)
        rest = rest + (rest >= h).long()  # every group but h
        gsel = torch.cat([torch.full_like(rest[:, :1], h), rest], 1)
    elif kind == "sparse":
        pool = random_gsel(1, n_groups, 8, seed + 1)[0]
        gsel = pool[random_gsel(qn, 8, 3, seed + 2)]
    else:
        gsel = random_gsel(qn, n_groups, kg, seed)
    return torch.sort(gsel, dim=1)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("group", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("d", [100, 768, 1024])
@pytest.mark.parametrize("kind", ["random", "one_group", "sparse"])
def test_pass_b_bitwise_equals_score_kernel(cuda, dtype, group, d, kind):
    """Pass B's candidates are kernel 2's scores bit for bit, through both
    entries, at D that is (768, 1024) and is not (100: a scalar loader for
    bf16 and int8 rows) a multiple of the k-chunk."""
    qn, n = 100, 4096
    q, p = search_problem(qn, n, d, dtype, seed=5)
    scores = fused_scores_groupmax(q, p, group)[0].view(qn, n // group, group)
    gsel = selection(kind, qn, n // group, 11)
    want = torch.gather(scores, 1, gsel[:, :, None].expand(-1, -1, group))
    before = extract_candidate_scores.launches
    got = extract_candidate_scores(q, p, gsel, group)
    internal = extract_candidate_scores_unchecked(q, p, gsel.int(), group)
    torch.cuda.synchronize()
    assert extract_candidate_scores.launches == before + 2
    assert torch.equal(got, want)
    assert torch.equal(internal, want)


@pytest.mark.parametrize("group", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["random", "one_group", "sparse"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_work_list_kernel_equals_plain(cuda, group, kind, idx_dtype):
    """The counting sort's items equal the plain version's, its slots lie
    in group order as the plain version's do, and each group holds the
    same slots (in an order that atomics decide)."""
    qn, n = 100, 524288
    gsel = selection(kind, qn, n // group, 101 if kind != "sparse" else 3).to(idx_dtype)
    slots, items, n_items = candidate_work_list(gsel, n // group)
    want_slots, want_items, want_n = candidate_work_list_plain(gsel, n // group)
    torch.cuda.synchronize()
    assert torch.equal(n_items, want_n)
    k = int(n_items[0])
    assert torch.equal(items[:k], want_items[:k])
    flat = gsel.reshape(-1).long()
    by_group, want_by_group = flat[slots.long()], flat[want_slots.long()]
    assert torch.equal(by_group, want_by_group)
    key = lambda g, sl: torch.sort(g * flat.numel() + sl)[0]  # noqa: E731
    assert torch.equal(key(by_group, slots), key(want_by_group, want_slots))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("offset", [4, 16])
def test_pass_b_takes_passages_with_a_storage_offset(cuda, dtype, offset):
    # a view ``offset`` bytes into its storage: 4 is not 16-byte aligned
    # (the scalar loader), 16 is (the cp.async ring)
    qn, n, d = 40, 1024, 256
    q, p = search_problem(qn, n, d, dtype, seed=6)
    flat = torch.zeros(p.numel() * p.element_size() + offset, dtype=torch.uint8,
                       device="cuda")
    p_off = flat[offset:].view(p.dtype).view(p.shape).copy_(p)
    assert p_off.storage_offset() > 0 and (p_off.data_ptr() % 16 == 0) == (offset == 16)
    gsel = selection("random", qn, n // 32, 9, seed=3)
    want = extract_candidate_scores(q, p, gsel, 32)
    assert torch.equal(extract_candidate_scores(q, p_off, gsel, 32), want)
    assert torch.equal(extract_candidate_scores_unchecked(q, p_off, gsel, 32), want)


def test_streaming_topk_issues_no_host_sync(cuda):
    q, p = search_problem(64, 65536, 768, torch.float32, seed=8)
    want = streaming_flat_ip_topk(q, p, 100)  # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = streaming_flat_ip_topk(q, p, 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("group", [8, 32, 128])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_groups_vector_and_scalar_paths(cuda, group, idx_dtype, aligned):
    # an unaligned ``scores`` view (4 bytes into its storage) takes the
    # scalar kernel; ids out of range give NaN on both paths
    qn, b, k = 67, 128 * 40, 13
    gen = torch.Generator(device="cuda").manual_seed(4)
    flat = torch.randn(qn * b + 1, generator=gen, device="cuda")
    scores = (flat[:-1] if aligned else flat[1:]).view(qn, b)
    assert (scores.data_ptr() % 16 == 0) == aligned
    gsel = random_gsel(qn, b // group, k, seed=5).to(idx_dtype)
    out = dma_gather_groups(scores, gsel, group=group)
    assert torch.equal(out, dma_gather_groups_plain(scores, gsel, group=group))
    bad = gsel.clone()
    bad[3, 2], bad[60, 0] = -1, b // group
    out = dma_gather_groups(scores, bad, group=group)
    torch.cuda.synchronize()
    assert bool(out[3, 2].isnan().all()) and bool(out[60, 0].isnan().all())
    keep = torch.ones(qn, k, dtype=torch.bool, device="cuda")
    keep[3, 2] = keep[60, 0] = False
    want = dma_gather_groups_plain(scores, gsel, group=group)
    assert torch.equal(out[keep], want[keep])


def test_device_sq8_equals_numpy(cuda):
    gen = torch.Generator(device="cuda").manual_seed(4)
    p = torch.randn(524288, 768, generator=gen, device="cuda")
    p[:64] = torch.round(p[:64] * 4) / 4  # values on and near .5 steps
    scales = fit_int8_scales(p[:50000].cpu().numpy())
    scales[:8] = 0.5  # p / 0.5 lands on exact halves: round half to even
    got = quantize_passages_dev(p, torch.from_numpy(scales).cuda())
    want = quantize_passages(p.cpu().numpy(), scales)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("rescore", [0, 3])
def test_blocked_searcher_int8_on_card_matches_cpu(cuda, rescore):
    rng = np.random.RandomState(5)
    q = rng.randn(5, 32).astype(np.float32)
    p = rng.randn(5000, 32).astype(np.float32)
    emb2offset = np.arange(5000, dtype=np.int64) + 7
    cfg = SearchConfig(passage_block_size=1024, storage_dtype="int8",
                       max_device_block_bytes=1, rescore_factor=rescore)
    quant = Int8Quantizer.fit(p)
    outs = [
        BlockedSearcher(cfg, device=dev, quantizer=quant).search_arrays(q, p, emb2offset, 30)
        for dev in (cuda, torch.device("cpu"))
    ]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][0], outs[1][0])


@pytest.mark.parametrize("fmt", ["pickle", "native"])
@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
def test_bf16_block_file_search_on_card_matches_plain(cuda, tmp_path, fmt, storage):
    """bf16 block files (uploaded as bf16, no f32 round trip under bf16
    storage) searched on the card against the searcher's plain CPU path:
    the same top-k sets, scores within 1e-5 * |q| * max|p|."""
    import ml_dtypes

    from convdr_torch.retrieval.blocks import write_embedding_block

    rng = np.random.RandomState(9)
    q = rng.randn(7, 768).astype(np.float32)
    p = rng.randn(6000, 768).astype(np.float32).astype(ml_dtypes.bfloat16)
    p[[10, 5000]] = p[77]  # exact ties within and across blocks
    d = str(tmp_path)
    for b, lo in enumerate((0, 3000)):
        write_embedding_block(d, b, p[lo:lo + 3000], 2 * np.arange(lo, lo + 3000), fmt=fmt)
    cfg = SearchConfig(storage_dtype=storage, passage_block_size=2048)
    s_gpu, o_gpu = BlockedSearcher(cfg, device=cuda).search_blocks(d, q, 50)
    s_cpu, o_cpu = BlockedSearcher(cfg, device=torch.device("cpu")).search_blocks(d, q, 50)
    for r in range(7):
        assert set(o_gpu[r]) == set(o_cpu[r])
    tol = 1e-5 * np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(
        p.astype(np.float32), axis=1).max()
    assert np.all(np.abs(s_gpu - s_cpu) <= tol)


def test_native_library_builds_and_round_trips_on_card_machine(cuda, tmp_path):
    """The host library builds with the card machine's g++, and a bf16
    ``.cnb`` block reaches the card with the bits it was written with."""
    import ml_dtypes

    from convdr_torch import native_io
    from convdr_torch.retrieval.blocks import host_tensor

    assert native_io.native_available()
    rng = np.random.RandomState(10)
    emb = rng.randn(1000, 768).astype(np.float32).astype(ml_dtypes.bfloat16)
    ids = rng.randint(0, 1 << 40, 1000).astype(np.int64)
    path = str(tmp_path / "b.cnb")
    native_io.write_native_block(path, emb, ids)
    got, got_ids = native_io.read_native_block(path)
    np.testing.assert_array_equal(got_ids, ids)
    on_card = host_tensor(got).to(cuda)
    want = torch.from_numpy(emb.astype(np.float32)).to(cuda).to(torch.bfloat16)
    assert on_card.dtype == torch.bfloat16 and torch.equal(on_card, want)
    rows = native_io.gather_file_rows(path, 32, got.dtype, 768, np.array([999, 0, 1, 2]))
    assert rows.tobytes() == emb[[999, 0, 1, 2]].tobytes()


# ---------------------------------------------------------------------------
# the ANN layer on the card (PyTorch ops, no hand-written kernel)
# ---------------------------------------------------------------------------
def ann_mixture(n, d, n_centres, seed):
    """Seeded Gaussian mixture rows [n, d] f32 (noise comparable to the
    centre spread), the ANN's realistic regime."""
    rng = np.random.Generator(np.random.PCG64(seed))
    centres = rng.standard_normal((n_centres, d), dtype=np.float32)
    return centres[rng.integers(0, n_centres, n)] + rng.standard_normal((n, d), dtype=np.float32)


@pytest.mark.parametrize("d", [64, 768])
def test_ivf_int8_list_scores_exact_on_card(cuda, d):
    """int8 lists score in f32 on the int values: exact integers (a bf16
    product would round every sum above 256), equal to the integer oracle
    score for score at a full probe."""
    from convdr_torch.ops.quant import int8_topk_oracle
    from convdr_torch.retrieval.ivf import IVFIndex

    x = ann_mixture(6000, d, 64, seed=1)
    q = ann_mixture(16, d, 64, seed=2)
    idx = IVFIndex.build(x, 16, storage_dtype="int8", iters=5, seed=0, device=cuda)
    s, i = idx.search(q, 50, nprobe=idx.nlist)
    q_int, tq = idx.quantizer.quantize_queries(q)
    o_s, o_i = int8_topk_oracle(q_int, idx.quantizer.quantize_passages(x), 50)
    np.testing.assert_array_equal(np.sort(s, 1), np.sort((o_s * tq).astype(np.float32), 1))
    int_scores = q_int.astype(np.int64) @ idx.quantizer.quantize_passages(x).astype(np.int64).T
    for r in range(16):
        # probe-major order breaks integer ties differently: only rows tied
        # with the 50th score may differ
        for row in set(i[r]) ^ set(o_i[r]):
            assert int_scores[r, row] == o_s[r, -1]
    assert o_s.max() > 256  # sums a bf16 product would round


def assert_topk_near(got_s, got_i, want_s, want_i, tol=1e-5):
    """Scores within ``tol`` (relative and absolute) and, per row, equal id
    sets but for near-ties at the cut (within ``tol`` of the k-th score)."""
    np.testing.assert_allclose(got_s, want_s, rtol=tol, atol=tol)
    for r in range(got_i.shape[0]):
        diff = set(got_i[r].tolist()) ^ set(want_i[r].tolist())
        if diff:
            kth = want_s[r, -1]
            assert abs(got_s[r, -1] - kth) <= tol * max(1.0, abs(kth)), (r, diff)


@pytest.mark.parametrize("nbits,packed", [(4, False), (4, True), (8, False)])
def test_adc_on_card_equals_cpu(cuda, nbits, packed):
    """The flat ADC scan and the IVF candidate ADC on the card equal the
    same functions on the CPU: scores within 1e-5 (f32 sums of another
    order), ids equal but for near-ties at the cut."""
    from convdr_torch.ops.pq import PQCodec, pack_codes_4bit, pq_flat_topk
    from convdr_torch.retrieval.ivf import IVFIndex

    x = ann_mixture(4000, 64, 32, seed=3)
    q = ann_mixture(24, 64, 32, seed=4)
    codec = PQCodec.fit(x, 16, nbits, iters=6, seed=0, device=cuda)
    codes = codec.encode(x, device=cuda)
    assert (codes == codec.encode(x, device="cpu")).mean() > 0.999  # f32 near-ties
    stored = pack_codes_4bit(codes) if packed else codes
    lut = torch.from_numpy(codec.lut(q))
    got = pq_flat_topk(lut.cuda(), torch.from_numpy(stored).cuda(), 100, codec.ksub,
                       packed=packed)
    want = pq_flat_topk(lut, torch.from_numpy(stored), 100, codec.ksub, packed=packed)
    assert_topk_near(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].numpy(),
                     want[1].numpy())
    idx = IVFIndex.build(x, 16, storage_dtype=f"pq{nbits}", pq_m=16, iters=5, seed=0,
                         pack=packed, device=cuda)
    s_card, i_card = idx.search(q, 50, nprobe=4)
    idx._device, idx._dev = "cpu", None
    s_cpu, i_cpu = idx.search(q, 50, nprobe=4)
    assert_topk_near(s_card, i_card, s_cpu, i_cpu)


def test_ivf_full_probe_equals_flat_on_card(cuda):
    """A full probe scores every row: its top-100 sets equal flat_ip_topk's
    on the same rows, up to near-ties at the cut (1e-5 * |q| * max|p|)."""
    from convdr_torch.retrieval.ivf import IVFIndex

    x = ann_mixture(20000, 128, 128, seed=5)
    q = ann_mixture(32, 128, 128, seed=6)
    idx = IVFIndex.build(x, 64, iters=8, seed=0, device=cuda)
    s, i = idx.search(q, 100, nprobe=idx.nlist)
    qt, pt = torch.from_numpy(q).cuda(), torch.from_numpy(x).cuda()
    f_s, f_i = es.flat_ip_topk(qt, pt, 100)
    f_s, f_i = f_s.cpu().numpy(), f_i.cpu().numpy()
    pmax = np.linalg.norm(x, axis=1).max()
    for r in range(32):
        tol = 1e-5 * np.linalg.norm(q[r]) * pmax
        for row in set(i[r]) ^ set(f_i[r]):
            assert abs(float(q[r] @ x[row]) - f_s[r, -1]) <= tol
    np.testing.assert_allclose(s[:, 0], f_s[:, 0], rtol=1e-5)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_ivf_search_peak_stays_near_the_candidate_budget(cuda, storage):
    """The card's allocator peak of a full probe stays under
    ``max_candidate_bytes`` plus the [Q, nprobe * cap] scores, row ids and
    their top-k (a slack of 64 bytes a candidate slot), where one query's
    gathered candidates alone are several times the budget."""
    from convdr_torch.retrieval.ivf import IVFIndex

    x = ann_mixture(40000, 256, 64, seed=7)
    q = ann_mixture(8, 256, 64, seed=8)
    idx = IVFIndex.build(x, 32, iters=5, seed=0, storage_dtype=storage, device=cuda)
    budget = 4 << 20
    idx.search(q[:1], 10, nprobe=1)  # uploads the index
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want = idx.search(q, 10, nprobe=idx.nlist)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base > 4 * budget  # the default budget
    torch.cuda.reset_peak_memory_stats()
    got = idx.search(q, 10, nprobe=idx.nlist, max_candidate_bytes=budget)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= budget + 64 * idx.nlist * idx.cap, (peak, budget)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# online serving: one captured CUDA graph a (Q, capacity) (tiny width, seeded weights)
# ---------------------------------------------------------------------------
SERVE_HISTORIES = [
    ["tell me about coral reefs", "where are they found"],
    ["what is jazz harmony", "who shaped it", "how is it taught today"],
    ["bronze age trade routes"],
    ["lucid dreaming", "is it safe", "how do people learn it", "any risks"],
]


@pytest.fixture(scope="module")
def serve_dirs(tmp_path_factory):
    """Two seeded f32 blocks of tiny-width rows (1500 each: the corpus pads
    to the score kernel's tile), an IVF int8 index and a packed IVFPQ pq4
    index with an OPQ rotation over the same rows."""
    from convdr_torch.retrieval.blocks import write_embedding_block
    from convdr_torch.retrieval.ivf import IVFIndex

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    root = tmp_path_factory.mktemp("serve")
    rows = ann_mixture(3000, 32, 24, seed=20)
    for b in range(2):
        write_embedding_block(str(root / "blocks"), b, rows[b * 1500:(b + 1) * 1500],
                              1000 + np.arange(b * 1500, (b + 1) * 1500))
    offsets = 1000 + np.arange(3000)
    IVFIndex.build(rows, 8, rowids=offsets, storage_dtype="int8", iters=5,
                   device="cuda").save(str(root / "ivf_int8"))
    IVFIndex.build(rows, 8, rowids=offsets, storage_dtype="pq4", pq_m=8, opq_iters=2,
                   pack=True, iters=5, device="cuda").save(str(root / "ivfpq"))
    return root


def serve_searcher(dirs, backend, cuda):
    from convdr_torch.retrieval.online import OnlineSearcher

    kw = dict(top_n=20, max_concat_length=32, arch_preset="tiny", device=cuda)
    if backend.startswith("flat"):
        return OnlineSearcher.from_blocks(None, str(dirs / "blocks"),
                                          storage_dtype=backend[5:], **kw)
    return OnlineSearcher.from_ivf(None, str(dirs / backend), nprobe=3, **kw)


def eager_turn(searcher, ids, mask):
    """The serving program run eagerly on the same inputs, its rows mapped
    as ``search_tokens`` maps them."""
    dev = searcher.device
    s, i = searcher.program(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
    return s.cpu().numpy(), searcher.rows_to_offsets(i.cpu().numpy())


def turn_inputs(searcher, history):
    from convdr_torch.retrieval.online import history_to_inputs

    return history_to_inputs(searcher.tokenizer, history, max_concat_length=32)


SERVE_BACKENDS = ["flat_float32", "flat_bfloat16", "flat_int8", "ivf_int8", "ivfpq"]


@pytest.mark.parametrize("backend", SERVE_BACKENDS)
def test_captured_serve_equals_eager_program(cuda, serve_dirs, backend):
    """Every replay equals the eager program on the same inputs bit for bit
    (the same kernels and cuBLAS calls at the same shapes); each replay
    reads the static inputs copied in for its own turn (turns differ); the
    graph records kernel 1 (and, on the flat backends, kernels 2 and 5)."""
    searcher = serve_searcher(serve_dirs, backend, cuda)
    searcher.warmup()
    assert list(searcher.graphs) == [(1, None)]
    results = []
    for history in SERVE_HISTORIES + SERVE_HISTORIES[:1]:
        ids, mask = turn_inputs(searcher, history)
        got = searcher.search_tokens(ids, mask)
        want = eager_turn(searcher, ids, mask)
        assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
        results.append(got)
    assert not np.array_equal(results[0][1], results[1][1])  # turns differ
    assert np.array_equal(results[0][1], results[-1][1])
    g = searcher.graphs[(1, None)]
    assert g.replays == len(SERVE_HISTORIES) + 2  # the warm-up call replays too
    assert g.launches["flash_attention_fwd"] == 2  # the tiny model's two layers
    flat = backend.startswith("flat")
    assert (g.launches["fused_scores_groupmax"] > 0) == flat
    assert (g.launches["dma_gather_groups"] > 0) == flat
    assert searcher.replayed_launches()["flash_attention_fwd"] == 2 * g.replays
    assert searcher.resident_bytes > 0 and g.pool_bytes >= 0 and g.capture_s > 0


def test_distinct_q_captures_its_own_graph(cuda, serve_dirs):
    """A batch of 3 turns captures a second graph; its rows equal the Q=3
    eager program's, and the Q=1 graph still serves."""
    searcher = serve_searcher(serve_dirs, "flat_float32", cuda)
    searcher.warmup()
    inputs = [turn_inputs(searcher, h) for h in SERVE_HISTORIES[:3]]
    ids = np.concatenate([x[0] for x in inputs])
    mask = np.concatenate([x[1] for x in inputs])
    got = searcher.search_tokens(ids, mask)
    want = eager_turn(searcher, ids, mask)
    assert sorted(searcher.graphs) == [(1, None), (3, None)]
    assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
    one = searcher.search_tokens(*inputs[1])
    assert searcher.graphs[(1, None)].replays == 2 and searcher.graphs[(3, None)].replays == 1
    assert one[0].tobytes() == eager_turn(searcher, *inputs[1])[0].tobytes()


def test_replay_issues_no_host_sync(cuda, serve_dirs):
    """Between the copy-in and the read-back a turn waits for nothing: the
    copies go through pinned buffers without a stream sync, and the one
    wait is the event after the read-back (not a sync the debug mode
    reports)."""
    searcher = serve_searcher(serve_dirs, "flat_int8", cuda)
    searcher.warmup()
    ids, mask = turn_inputs(searcher, SERVE_HISTORIES[1])
    want = searcher.search_tokens(ids, mask)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = searcher.search_tokens(ids, mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])


def batch_call(searcher, seed, lengths):
    """Seeded ids and prefix-layout mask of one batched call: row r holds
    ``lengths[r]`` valid tokens at the searcher's concat length."""
    t = searcher.max_concat_length
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
    vocab = searcher.model.config.arch.vocab_size
    ids = rng.randint(4, vocab, size=mask.shape).astype(np.int32) * mask
    return ids, mask


def eager_packed_turn(searcher, ids, mask, capacity):
    """The serving program run eagerly on the packing a graph of
    ``capacity`` rows replays, its rows mapped as ``search_tokens`` maps
    them."""
    from convdr_torch.models.transformer import Packing
    from convdr_torch.retrieval.online import fill_packing

    dev = searcher.device
    index, first = np.empty(capacity, np.int64), np.empty(len(mask), np.int64)
    fill_packing(mask, index, first)
    packing = Packing(torch.from_numpy(index).to(dev), torch.from_numpy(first).to(dev))
    s, i = searcher.program(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                            packing)
    return s.cpu().numpy(), searcher.rows_to_offsets(i.cpu().numpy())


def test_packed_replay_equals_eager_packed_and_padded_programs(cuda, serve_dirs):
    """A Q=512 call of prefix rows packs: its replay equals the eager packed
    program bit for bit, and judged against the padded program's embeddings
    (exact f64 scores of the corpus) its scores and ranks lie within the
    benchmark's ``correct`` limits (1.5e-5 of |q| sqrt(D)), rows distinct."""
    from convdr_torch.retrieval.online import PACK_STEP, packed_capacity

    searcher = serve_searcher(serve_dirs, "flat_float32", cuda)
    lengths = np.random.RandomState(21).randint(1, 33, size=512)
    ids, mask = batch_call(searcher, 22, lengths)
    capacity = packed_capacity(mask)
    assert capacity == -(-int(lengths.sum()) // PACK_STEP) * PACK_STEP < mask.size
    got = searcher.search_tokens(ids, mask)
    assert list(searcher.graphs) == [(512, capacity)]
    want = eager_packed_turn(searcher, ids, mask, capacity)
    assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
    g = searcher.graphs[(512, capacity)]
    assert g.capacity == capacity and g.packing.index.shape == (capacity,)
    assert g.launches["flash_attention_fwd"] == 2

    corpus = searcher._operands[0][:3000].double()
    q_pad = searcher.encode(torch.from_numpy(ids).to(cuda),
                            torch.from_numpy(mask).to(cuda)).double()
    exact = q_pad @ corpus.T
    unit = q_pad.norm(dim=1, keepdim=True) * corpus.shape[1] ** 0.5
    rows = torch.from_numpy(got[1] - 1000).to(cuda)  # the blocks' offsets start at 1000
    given = exact.gather(1, rows)
    best = exact.topk(rows.shape[1], dim=1).values
    score_gap = ((torch.from_numpy(got[0]).to(cuda).double() - given).abs() / unit).max()
    rank_gap = ((best - given) / unit).max()
    assert score_gap < 1.5e-5 and rank_gap < 1.5e-5, (score_gap, rank_gap)
    assert all(len(set(r.tolist())) == len(r) for r in got[1])


def test_packed_graphs_by_capacity_share_one_pool(cuda, serve_dirs):
    """Calls of one capacity replay one graph; a call that fits a captured
    capacity replays it; a larger capacity captures its own, in the pool of
    its Q; a call that would not save rows keeps the padded graph; a Q=1
    turn still captures one padded graph. Each replay equals the eager
    program on its graph's packing bit for bit; the counter reads the
    packed calls and their token share."""
    searcher = serve_searcher(serve_dirs, "flat_float32", cuda)
    searcher.warmup()
    calls = [(16, 8192), (15, 8192), (6, 8192), (20, 12288), (32, None)]
    for seed, (length, graph_capacity) in enumerate(calls):
        ids, mask = batch_call(searcher, 30 + seed, [length] * 512)
        got = searcher.search_tokens(ids, mask)
        want = (eager_turn(searcher, ids, mask) if graph_capacity is None else
                eager_packed_turn(searcher, ids, mask, graph_capacity))
        assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
    assert sorted(searcher.graphs, key=str) == [(1, None), (512, 12288), (512, 8192),
                                                (512, None)]
    replays = {k: g.replays for k, g in searcher.graphs.items()}
    assert replays == {(1, None): 1, (512, 8192): 3, (512, 12288): 1, (512, None): 1}
    pools = {searcher.graphs[k].graph.pool() for k in [(512, 8192), (512, 12288), (512, None)]}
    assert len(pools) == 1 and searcher.graphs[(1, None)].graph.pool() not in pools
    stats = searcher.packing_stats()
    assert stats["calls"] == 6 and stats["packed_calls"] == 4
    assert stats["token_share"] == 512 * (16 + 15 + 6 + 20) / (3 * 8192 + 12288)


def test_packed_replay_issues_no_host_sync(cuda, serve_dirs):
    """A packed call builds its token index on the host and copies it in
    through pinned buffers: between the copy-in and the read-back it waits
    for nothing (the debug mode reports no sync)."""
    searcher = serve_searcher(serve_dirs, "flat_float32", cuda)
    ids, mask = batch_call(searcher, 40, np.random.RandomState(41).randint(1, 33, size=512))
    want = searcher.search_tokens(ids, mask)
    assert searcher.packing_stats()["packed_calls"] == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = searcher.search_tokens(ids, mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
    assert searcher.packing_stats()["packed_calls"] == 2


def test_q1_turns_capture_one_padded_graph(cuda, serve_dirs):
    """Q=1 turns never pack, the longest included: one padded graph, no
    token index, no packed call counted."""
    searcher = serve_searcher(serve_dirs, "flat_float32", cuda)
    searcher.warmup()
    for history in SERVE_HISTORIES + [["a long question"] * 12]:
        searcher.search_tokens(*turn_inputs(searcher, history))
    assert list(searcher.graphs) == [(1, None)]
    g = searcher.graphs[(1, None)]
    assert g.capacity is None and g.packing is None and g.replays == len(SERVE_HISTORIES) + 2
    assert searcher.packing_stats()["packed_calls"] == 0


def test_fold_int8_queries_on_card_bit_equal_to_host(cuda):
    """The serving program's SQ8 fold on the card equals the host's
    ``quantize_queries`` bit for bit (tolerance 0) on 4096 seeded rows and
    a zero row: the same f32 IEEE divides, no reciprocal multiply."""
    from convdr_torch.ops.quant import quantize_queries
    from convdr_torch.retrieval.online import _fold_int8_queries

    rng = np.random.default_rng(0)
    q = rng.standard_normal((4096, 768)).astype(np.float32)
    q[7] = 0.0
    scales = (rng.random(768).astype(np.float32) + 0.5) / 127.0
    got_int, got_t = _fold_int8_queries(torch.from_numpy(q).to(cuda),
                                        torch.from_numpy(scales).to(cuda))
    want_int, want_t = quantize_queries(q, scales)
    assert got_t.cpu().numpy().tobytes() == want_t.tobytes()
    assert got_int.cpu().numpy().tobytes() == want_int.tobytes()


def test_concurrent_turns_get_their_own_results(cuda, serve_dirs):
    """Turns served from several threads at once share one graph's static
    buffers; the searcher's lock keeps each turn's results its own."""
    from concurrent.futures import ThreadPoolExecutor

    searcher = serve_searcher(serve_dirs, "flat_float32", cuda)
    searcher.warmup()
    inputs = [turn_inputs(searcher, h) for h in SERVE_HISTORIES] * 8
    want = [eager_turn(searcher, ids, mask) for ids, mask in inputs]
    with ThreadPoolExecutor(max_workers=4) as pool:
        got = list(pool.map(lambda x: searcher.search_tokens(*x), inputs))
    for g, w in zip(got, want):
        assert g[0].tobytes() == w[0].tobytes() and np.array_equal(g[1], w[1])
    assert searcher.graphs[(1, None)].replays == len(inputs) + 1


def test_traced_turn_spans_hold_the_replays_launches(cuda, serve_dirs, tmp_path):
    """Under the profiler one Q=1 turn records one ``convdr.serve.replay``
    span whose launches (the graph's kernels, under ``cudaGraphLaunch``'s
    correlation id) are at least the counted kernels the graph recorded,
    with device time; the turn holds the copy-in, the replay and the wait."""
    import json

    from torch.profiler import ProfilerActivity, profile, record_function

    from h100_bench import devtrace
    from h100_bench.spans import read_spans

    searcher = serve_searcher(serve_dirs, "flat_float32", cuda)
    searcher.warmup()
    ids, mask = turn_inputs(searcher, SERVE_HISTORIES[1])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.SPAN):
            searcher.search_tokens(ids, mask)
            torch.cuda.synchronize()
    path = tmp_path / "turn.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    (seg,) = [e for e in events if e.get("name") == devtrace.SPAN
              and e.get("cat") == "user_annotation"]
    spans = read_spans(events, seg["ts"], seg["ts"] + seg["dur"], [], pid=seg["pid"])
    for name in ("turn", "copy_in", "replay", "wait"):
        assert spans[f"convdr.serve.{name}"]["count"] == 1, name
    replay = spans["convdr.serve.replay"]
    assert replay["launches"] >= sum(searcher.graphs[(1, None)].launches.values()) > 0
    assert replay["device_s"] > 0
    assert spans["convdr.serve.turn"]["launches"] >= replay["launches"] + 4  # + the copies


def test_failed_capture_raises_without_fallback(cuda, serve_dirs):
    """A program that waits on the host cannot be captured: the call
    raises, and nothing serves it eagerly."""
    searcher = serve_searcher(serve_dirs, "flat_float32", cuda)
    real = searcher.search_embeddings

    def syncing(q):
        if q.abs().sum().item() < 0:  # a host sync inside the program
            q = -q
        return real(q)

    searcher.search_embeddings = syncing
    with pytest.raises(RuntimeError):
        searcher.warmup()
    assert searcher.stats.latencies == []


# ---------------------------------------------------------------------------
# multi-GPU: world size 1 over NCCL (the card holds one rank), and S shards
# searched in one process and merged (what an S-card run computes)
# ---------------------------------------------------------------------------
def shards_of(p, n_shards):
    """The padded row shards of ``p`` (every shard ``rows`` rows, a multiple
    of the score kernel's tile; the last ones short or empty)."""
    from convdr_torch.ops.fused_search import ROW_TILE
    from convdr_torch.parallel.mesh import shard_rows

    out = []
    for s in range(n_shards):
        lo, hi, rows = shard_rows(p.shape[0], n_shards, s, ROW_TILE)
        shard = torch.zeros((rows, p.shape[1]), dtype=p.dtype, device=p.device)
        shard[: hi - lo] = p[lo:hi]
        out.append(shard)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_sharded_flat_emulation_equals_unsharded(cuda, dtype, n_shards):
    """Each shard's local search (kernels 2 and 5 at a nonzero base) plus
    the merge equals the unsharded search, scores and indices; at S = 3
    the last shard is short."""
    from convdr_torch.parallel.sharded_search import local_flat_ip_topk, merge_shard_topk

    q, p = search_problem(512, 524288, 768, dtype)
    want_s, want_i = es.flat_ip_topk(q, p, 100)
    parts = [local_flat_ip_topk(q, shard, 100, s, n_shards, valid_rows=p.shape[0])
             for s, shard in enumerate(shards_of(p, n_shards))]
    got_s, got_i = merge_shard_topk(torch.stack([s for s, _ in parts]),
                                    torch.stack([i for _, i in parts]), 100)
    assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)


def test_world1_nccl_sharded_flat_equals_flat(cuda):
    from convdr_torch.parallel.dryrun import single_rank
    from convdr_torch.parallel.mesh import get_mesh
    from convdr_torch.parallel.sharded_search import sharded_flat_ip_topk

    for dtype in (torch.float32, torch.int8):
        q, p = search_problem(512, 524288, 768, dtype)
        want = es.flat_ip_topk(q, p, 100)
        with single_rank(no_cuda=False):
            got = sharded_flat_ip_topk(get_mesh(("index",)), q, p, 100)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_world1_nccl_dp_step_equals_unmeshed(cuda):
    """One KD + ranking step of the tiny model through the flash kernels,
    with and without a one-rank NCCL mesh: the same loss and gradients, bit
    for bit (the all-reduce of one rank and the divide by 1 are exact)."""
    import dataclasses

    from convdr_torch.core.config import TrainConfig
    from convdr_torch.core.loading import load_model_and_params
    from convdr_torch.parallel.dryrun import single_rank
    from convdr_torch.parallel.mesh import get_mesh
    from convdr_torch.train.trainer import create_train_state, make_train_step

    rng = np.random.RandomState(6)
    b, k, t, length = 4, 3, 40, 56
    ids = rng.randint(5, 200, size=(b, t)).astype(np.int32)
    mask = (np.arange(t)[None, :] < rng.randint(3, t + 1, size=b)[:, None]).astype(np.int32)
    doc_mask = (np.arange(length) < rng.randint(1, length + 1, size=(b, k, 1))).astype(np.int32)
    batch = {"concat_ids": ids, "concat_mask": mask, "target_ids": ids[:, :16],
             "target_mask": mask[:, :16], "doc_mask": doc_mask,
             "doc_ids": rng.randint(5, 200, size=(b, k, length)).astype(np.int32)}
    cfg = dataclasses.replace(TrainConfig(ranking_task=True, num_negatives=k - 1),
                              learning_rate=1e-3)

    def one_step(mesh):
        student, teacher = (
            load_model_and_params("rdot_nll", None, device=cuda, arch_preset="tiny",
                                  seed=seed)[2]
            for seed in (1, 2))
        state, tx = create_train_state(student, cfg, 10)
        step = make_train_step(student, teacher, tx, cfg, mesh=mesh)
        _, metrics = step(state, {n: torch.from_numpy(a).to(cuda) for n, a in batch.items()})
        return ({n: float(v) for n, v in metrics.items()},
                {n: p.grad.clone() for n, p in student.named_parameters()})

    want_m, want_g = one_step(None)
    with single_rank(no_cuda=False):
        got_m, got_g = one_step(get_mesh(("data",)))
    assert got_m == want_m
    for name, g in want_g.items():
        assert torch.equal(got_g[name], g), name


# ---------------------------------------------------------------------------
# --matmul_precision high / default on the card
# ---------------------------------------------------------------------------
# The normalized score error |s - s_highest| / (|q| |p|) of each reduced
# precision is bounded by 2u + u^2 of sum |q_i p_i| <= |q| |p| (u the unit
# roundoff of its operands: TF32 2^-10 even if the unit truncates, bf16
# 2^-8) plus both products' f32 accumulation (2 D 2^-24).
PRECISION_BOUND = {"high": 2 * 2 ** -10 + 2 ** -20 + 2 * 768 * 2 ** -24,
                   "default": 2 * 2 ** -8 + 2 ** -16 + 2 * 768 * 2 ** -24}


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_reduced_precision_rounds_within_its_bound(cuda, precision, storage):
    """``rounded_scores`` differs from the "highest" scores (the rounding
    happened) and stays within the bound above; "default" is within 1e-5 of
    |q| |p| of its plain emulation (bf16 operands, f32 products); the
    top-k after it is the "highest" selection code on those scores
    (``flat_ip_topk`` equal to a stable sort of ``rounded_scores``)."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    q = torch.randn(64, 768, generator=gen, device="cuda")
    p = torch.randn(4096, 768, generator=gen, device="cuda").to(storage)
    exact = fused_scores_groupmax(q, p, 32)[0]
    got = es.rounded_scores(q, p, precision)
    assert got.dtype == torch.float32 and not torch.equal(got, exact)
    norms = q.norm(dim=1)[:, None] * p.float().norm(dim=1)[None, :]
    err = ((got - exact).abs() / norms).max().item()
    assert 0 < err <= PRECISION_BOUND[precision], err
    if precision == "default":
        plain = es.rounded_scores_plain(q, p.float(), precision)
        assert ((got - plain).abs() / norms).max().item() <= 1e-5
    s, i = es.flat_ip_topk(q, p, 50, block_rows=4096, precision=precision)
    ref_s, ref_i = es.stable_topk(got, 50)
    assert torch.equal(s, ref_s) and torch.equal(i, ref_i)
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


def test_highest_after_high_is_bit_equal(cuda):
    """A "highest" search after a "high" one in the same process is bit for
    bit the "highest" search before it: the TF32 switch is held only
    around the "high" product."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    q = torch.randn(32, 768, generator=gen, device="cuda")
    p = torch.randn(8192, 768, generator=gen, device="cuda")
    matmul_before = q @ p.T
    before = es.flat_ip_topk(q, p, 100, block_rows=4096)
    high = es.flat_ip_topk(q, p, 100, block_rows=4096, precision="high")
    after = es.flat_ip_topk(q, p, 100, block_rows=4096)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not torch.equal(high[0], before[0])
    assert torch.equal(q @ p.T, matmul_before)  # a plain f32 product too


@pytest.mark.parametrize("precision", ["high", "default"])
def test_online_searcher_reduced_precision_replays_bit_equal_to_eager(cuda, serve_dirs,
                                                                      precision):
    """``OnlineSearcher.from_blocks(precision=)``: the graph is captured
    with the reduced-precision product (kernel 2 not launched, the gather
    kernel still), every replay equals the eager program bit for bit, and a
    "highest" searcher built afterwards serves as before."""
    from convdr_torch.retrieval.online import OnlineSearcher

    kw = dict(top_n=20, max_concat_length=32, arch_preset="tiny", device=cuda)
    exact = OnlineSearcher.from_blocks(None, str(serve_dirs / "blocks"), **kw)
    exact.warmup()
    first = [exact.search_tokens(*turn_inputs(exact, h)) for h in SERVE_HISTORIES]
    searcher = OnlineSearcher.from_blocks(None, str(serve_dirs / "blocks"),
                                          precision=precision, **kw)
    searcher.warmup()
    for history in SERVE_HISTORIES:
        ids, mask = turn_inputs(searcher, history)
        got = searcher.search_tokens(ids, mask)
        want = eager_turn(searcher, ids, mask)
        assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
    g = searcher.graphs[(1, None)]
    assert g.launches["fused_scores_groupmax"] == 0 and g.launches["dma_gather_groups"] > 0
    assert torch.get_float32_matmul_precision() == "highest"
    again = [exact.search_tokens(*turn_inputs(exact, h)) for h in SERVE_HISTORIES]
    for a, b in zip(first, again):
        assert a[0].tobytes() == b[0].tobytes() and np.array_equal(a[1], b[1])
