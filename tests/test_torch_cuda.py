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
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from convdr_torch.ops import exact_search as es
from convdr_torch.ops.fused_search import (
    fused_flat_ip_topk,
    fused_scores_groupmax,
    fused_scores_groupmax_plain,
)
from convdr_torch.retrieval.searcher import BlockedSearcher

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    set_exact_matmul()
    return torch.device("cuda")


def attention_problem(b, t, h, d, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
        for _ in range(3)
    )
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lens[-1] = 0  # all-pad row
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]).int()
    return q, k, v, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,t,h,d",
    [(3, 100, 2, 64), (4, 64, 12, 64), (2, 77, 3, 32), (2, 40, 2, 16), (2, 512, 12, 64),
     (512, 64, 12, 64)],  # the last: enough outputs near zero to expose rounding of P
)
def test_flash_kernel_matches_plain(cuda, dtype, b, t, h, d):
    q, k, v, mask = attention_problem(b, t, h, d, dtype)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [8, 16, 32, 128])
@pytest.mark.parametrize("qn,n,d", [(70, 384, 100), (512, 4096, 768)])
def test_scores_groupmax_kernel_matches_plain(cuda, dtype, group, qn, n, d):
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(qn, d, generator=gen, device="cuda")
    p = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    before = fused_scores_groupmax.launches
    s, g = fused_scores_groupmax(q, p, group)
    torch.cuda.synchronize()
    assert fused_scores_groupmax.launches == before + 1
    s_ref, _ = fused_scores_groupmax_plain(q, p, group)
    tol = 1e-5 * q.norm(dim=1)[:, None] * p.float().norm(dim=1).max()
    assert bool(((s - s_ref).abs() <= tol).all())
    assert torch.equal(g, s.view(qn, n // group, group).amax(-1))


def test_scores_groupmax_kernel_rejects_bad_shapes(cuda):
    q = torch.randn(4, 32, device="cuda")
    with pytest.raises(ValueError, match="tile"):
        fused_scores_groupmax(q, torch.randn(100, 32, device="cuda"), 32)
    with pytest.raises(ValueError, match="group"):
        fused_scores_groupmax(q, torch.randn(128, 32, device="cuda"), 24)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fused_scores_groupmax(q, torch.randn(128, 32, device="cuda").half(), 32)


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


@pytest.mark.parametrize(
    "b,t,h,d",
    [(3, 100, 2, 64), (2, 77, 3, 32), (2, 40, 2, 16), (4, 64, 12, 64), (4, 256, 12, 64),
     (5, 200, 12, 64)],
)
def test_flash_bwd_kernel_matches_plain(cuda, b, t, h, d):
    q, k, v, mask = attention_problem(b, t, h, d, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(7)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    before = flash_attention_bwd.launches
    out = FlashAttentionFn.apply(q.requires_grad_(), k.requires_grad_(),
                                 v.requires_grad_(), mask)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2  # dK/dV and dQ
    want = flash_attention_bwd_plain(q, k, v, out.detach(), do, mask)
    for g, r in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()


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
