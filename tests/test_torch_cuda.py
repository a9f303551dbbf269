"""convdr_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU: each skips, with its reason,
where there is none. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which the machine with
the card does not have; this file imports nothing of JAX.)

Tolerances: attention f32 1e-5 absolute (same softmax, another summation
order), bf16 one bf16 ulp (2^-7 relative; both versions round one f32
result); scores 1e-5 * |q| * max|p| (f32 dot products of another order);
the attention backward 1e-5 * max|ref| per gradient (f32 sums of up to T
terms in another order, P recomputed from the forward's log-sum-exp); in
bf16, within 2x the error of autograd through masked SDPA in bf16 (floor
1e-3 of scale) from the f64 plain backward, and the bf16 forward's lse
within 1e-5 relative of a torch.logsumexp.
Equal, not close: the streaming passes against the score kernel (the same
f32 FMA chain per score; int8: exact integer sums, on the tensor cores in
the score kernel), int8 scores against the plain version (exact integer
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
    flash_attention_plain,
)
from convdr_torch.ops import exact_search as es
from convdr_torch.ops.fused_search import (
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


# (Q, N, D) cutting the kernel's tiles: 64- and 128-query blocks, 128-row
# tiles, D padded to 16 bytes of the passages; D=1040 is int8's exact limit
SCORE_SHAPES = [(70, 384, 100), (512, 4096, 768), (1, 128, 8), (63, 384, 768),
                (64, 4224, 100), (65, 4224, 8), (129, 384, 768), (512, 4224, 100),
                (65, 384, 1040)]


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
    if dtype == torch.int8:  # tensor-core integer sums: equal
        assert torch.equal(s, s_ref) and torch.equal(g, g_ref)
    tol = 1e-5 * q.norm(dim=1)[:, None] * p.float().norm(dim=1).max()
    assert bool(((s - s_ref).abs() <= tol).all())
    assert torch.equal(g, s.view(qn, n // group, group).amax(-1))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_score_kernels_take_unaligned_operands(cuda, dtype):
    # views 4 bytes (one f32) past a 16-byte boundary: the wrapper copies them
    q, p = search_problem(65, 384, 96, dtype, seed=2)
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
@pytest.mark.parametrize("qn,n,d", [(1, 128, 8), (65, 4224, 100), (129, 384, 768)])
def test_pass_b_over_every_group_equals_score_kernel(cuda, dtype, group, qn, n, d):
    """Pass B given every group of the block scores every (query, row):
    equal to kernel 2's whole score matrix, the direct proof that both keep
    one FMA chain order (f32, bf16) or exact integer sums (int8)."""
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


def test_flash_bwd_config_fits_three_blocks_an_sm(cuda):
    cfg = flash_attention_bwd_config(4, 256, 12, 64)
    assert (cfg["threads"], cfg["block_rows"], cfg["tile_rows"]) == (128, 64, 32)
    assert cfg["blocks_per_sm"] == 3 and cfg["smem_bytes"] <= 227 * 1024 // 3


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
# online serving: one captured CUDA graph a Q (tiny width, seeded weights)
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
    assert list(searcher.graphs) == [1]
    results = []
    for history in SERVE_HISTORIES + SERVE_HISTORIES[:1]:
        ids, mask = turn_inputs(searcher, history)
        got = searcher.search_tokens(ids, mask)
        want = eager_turn(searcher, ids, mask)
        assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
        results.append(got)
    assert not np.array_equal(results[0][1], results[1][1])  # turns differ
    assert np.array_equal(results[0][1], results[-1][1])
    g = searcher.graphs[1]
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
    assert sorted(searcher.graphs) == [1, 3]
    assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
    one = searcher.search_tokens(*inputs[1])
    assert searcher.graphs[1].replays == 2 and searcher.graphs[3].replays == 1
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
    assert searcher.graphs[1].replays == len(inputs) + 1


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
    g = searcher.graphs[1]
    assert g.launches["fused_scores_groupmax"] == 0 and g.launches["dma_gather_groups"] > 0
    assert torch.get_float32_matmul_precision() == "highest"
    again = [exact.search_tokens(*turn_inputs(exact, h)) for h in SERVE_HISTORIES]
    for a, b in zip(first, again):
        assert a[0].tobytes() == b[0].tobytes() and np.array_equal(a[1], b[1])
