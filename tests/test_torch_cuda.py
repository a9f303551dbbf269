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
terms in another order, P recomputed from the forward's log-sum-exp).
Equal, not close: the streaming passes against the score kernel (the same
f32 FMA chain per score; int8: exact integer sums, on the tensor cores in
the score kernel), int8 scores against the plain version (exact integer
arithmetic), the gathers against ``torch.gather`` (copies), and two
backward calls on the same inputs (no atomics).
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


def test_flash_bwd_rejects_bf16(cuda):
    q, k, v, mask = attention_problem(2, 16, 2, 64, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        FlashAttentionFn.apply(q.requires_grad_(), k, v, mask)


def test_train_step_on_card_matches_cpu(cuda):
    """One KD + ranking step of the tiny model: the card's gradients (both
    flash kernels) against the CPU's (both plain versions)."""
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
        _, _, student = load_model_and_params("rdot_nll", None, device=dev,
                                              arch_preset="tiny", seed=1)
        _, _, teacher = load_model_and_params("rdot_nll", None, device=dev,
                                              arch_preset="tiny", seed=2)
        state, tx = create_train_state(student, cfg, 10)
        step = make_train_step(student, teacher, tx, cfg)
        _, metrics = step(state, {n: torch.from_numpy(a).to(dev) for n, a in batch.items()})
        grads[dev.type] = ({n: p.grad.cpu() for n, p in student.named_parameters()},
                           float(metrics["loss"]))
    (g_cpu, l_cpu), (g_gpu, l_gpu) = grads["cpu"], grads["cuda"]
    assert abs(l_cpu - l_gpu) <= 1e-5 * abs(l_cpu)
    for name, ref in g_cpu.items():
        assert (g_gpu[name] - ref).abs().max().item() <= 1e-4 * ref.abs().max().item() + 1e-9, name


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
