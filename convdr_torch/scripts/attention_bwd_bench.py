"""Time the flash-attention backward (kernel 1b) on the card, f32 and bf16.

f32 at the f32 student's shape (B=4 T=256 H=12 D=64) and B=8 T=512; bf16 at
the bf16 student's (B=4 T=256) and the teacher documents' (B=40 T=512);
right-padded masks drawn as chip_smoke.py draws them, and (f32) a random
mask at B=4 T=256. For each: the wrapper host-paced and on the device alone
(queued behind a spin kernel), the D pre-pass alone, autograd through masked
SDPA's backward on the device, each kernel's device time by name
(``torch.profiler``), the bound (:func:`bound_ms`; f32 also the design's
seven products, :func:`design_operations`, at the bf16 peak and the CUDA
cores' floor, :func:`cuda_core_bound_ms`), and the error of each gradient
over its largest entry against the plain backward in f64.

``--near-parallel`` measures the f32 kernel on near-parallel rows (q, k, v
1 + 0.01 N(0, 1); :data:`NEAR_PARALLEL_CASES`): each gradient's largest
error against the f64 plain backward over the f64 sum of the magnitudes of
its terms, and its error over its largest entry from the f64 plain
backward (the f32 plain backward's beside it) and from the f64 backward
that takes the kernel's D (:func:`near_parallel_errors`, the yardsticks of
the card test ``test_flash_bwd_f32_near_parallel_rows_against_f64``).

``--root`` imports ``convdr_torch`` from another checkout (a parent unpacked
with ``git archive``), so two versions compare within one call on one card;
``--digests`` prints a digest of each dtype's gradients on seeded problems
(a tree's bits, to compare with another's):

    python -m convdr_torch.scripts.attention_bwd_bench --root parent --label parent --digests
    python -m convdr_torch.scripts.attention_bwd_bench --label change --digests

Needs the card for the timings; prints one JSON line a version.
"""

import argparse
import json
import subprocess
import sys

import torch

from convdr_torch.scripts.attention_sweep import in_segment_pairs
from convdr_torch.scripts.score_sweep import HBM_BYTES_PER_S, PEAK_FLOPS

HEADS, HEAD_DIM = 12, 64
SHAPES = {"f32": ((4, 256), (8, 512)), "bf16": ((4, 256), (40, 512))}
DIGEST_CASES = ((4, 256, 12, 64, "random"), (3, 77, 2, 32, "left"), (2, 65, 2, 16, "middle"))
# T=8192 at B=1 (its one row all pad: one segment of 8192 tokens, a plan of
# 257 tiles, the longest sums) and the student's shape
NEAR_PARALLEL_CASES = ((1, 8192, 1, 16, "middle"), (4, 256, 12, 64, "random"))


def parts_operations(mask, heads, head_dim):
    """The f32 backward's least tensor-core work on this data: the
    function's five products (S, dP, dV, dK, dQ; 2D a pair and head each)
    in six bf16 parts, 60HD a pair in segment."""
    return 60.0 * heads * head_dim * in_segment_pairs(mask)


def design_operations(mask, heads, head_dim):
    """The f32 kernel's tensor-core operations on this data: seven six-part
    products (S and dP again in the dQ blocks), 84HD a pair in segment (the
    planned tiles' masked pairs not counted)."""
    return 84.0 * heads * head_dim * in_segment_pairs(mask)


def cuda_core_bound_ms(q, mask):
    """The function's 10HD operations a pair in segment over the CUDA
    cores' 67 TFLOP/s f32 peak (ms): the floor of any f32 design without
    the tensor cores, printed beside the f32 bound."""
    _b, _t, h, d = q.shape
    return 10.0 * h * d * in_segment_pairs(mask) / PEAK_FLOPS[torch.float32] * 1e3


def bound_ms(q, mask):
    """The least time (ms) of one backward: the bytes of q, k, v, o, dO read
    and dQ, dK, dV written (q's dtype), the f32 lse and the mask once each,
    against the operations on this data (f32: :func:`parts_operations` at
    the bf16 peak; bf16: the function's 10HD a pair at the bf16 peak); and
    which of the two bounds it."""
    b, t, h, d = q.shape
    if q.dtype == torch.float32:
        ops = parts_operations(mask, h, d)
    else:
        ops = 10.0 * h * d * in_segment_pairs(mask)
    ops_ms = ops / PEAK_FLOPS[torch.bfloat16] * 1e3
    nbytes = 8 * q.numel() * q.element_size() + b * h * t * 4 + mask.numel() * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms else "bytes")


def digest_problem(b, t, h, d, kind, dtype):
    """A seeded problem on the card: q, k, v N(0, 1), a mask whose last row
    is all pad (right / left / middle runs or random tokens), dO N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lens[-1] = 0
    pos = torch.arange(t, device="cuda")[None, :]
    if kind == "right":
        valid = pos < lens[:, None]
    elif kind == "left":
        valid = pos >= t - lens[:, None]
    elif kind == "middle":
        start = torch.randint(0, t, (b,), generator=gen, device="cuda") % (t - lens + 1)
        valid = (pos >= start[:, None]) & (pos < (start + lens)[:, None])
    else:
        valid = torch.rand((b, t), generator=gen, device="cuda") < 0.5
        valid[-1] = False
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(7),
                     device="cuda").to(dtype)
    return q, k, v, valid.int(), do


def term_magnitudes(q, k, v, do, mask):
    """f64, for each gradient, the sum of the magnitudes of the terms that
    enter it, those of its factors included (P the masked softmax, O = P V,
    dP = dO V^T, D = rowsum(dO O), dS = P (dP - D), of the f64 operands).
    A rounding of the scores or of lse moves P by P times
    a = scale sum_d |Q||K| + |lse|, one of dP or D moves dS by P times
    sum_d |dO||V| or sum_d |dO||O|, so with
    e = sum_d |dO||V| + sum_d |dO||O| + |dP - D| a:
    dQ scale sum_k P e |K|, dK scale sum_q P e |Q|, dV sum_q P (1 + a) |dO|."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    allowed = (mask[:, None, :, None] == mask[:, None, None, :])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lse = torch.logsumexp(s.masked_fill(~allowed, float("-inf")), dim=-1, keepdim=True)
    probs = torch.exp(s - lse).masked_fill(~allowed, 0.0)
    del s
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]              # [B,H,Tq,1]
    a = torch.einsum("bqhd,bkhd->bhqk", q.abs(), k.abs()) * scale + lse.abs()
    e = (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta).abs() * a
    e += torch.einsum("bqhd,bkhd->bhqk", do.abs(), v.abs())
    e += (do.abs() * o.abs()).sum(-1).transpose(1, 2)[..., None]
    pe = probs * e
    del e
    return (torch.einsum("bhqk,bkhd->bqhd", pe, k.abs()) * scale,
            torch.einsum("bhqk,bqhd->bkhd", pe, q.abs()) * scale,
            torch.einsum("bhqk,bqhd->bkhd", probs * (1.0 + a), do.abs()))


def bwd_given_delta(q, k, v, do, mask, delta, lse=None):
    """dQ, dK, dV in f64 of the f64 operands with D given ([B, H, T], the
    flash backward's rowsum(dO O)) in place of sum P dP, and with ``lse``
    ([B, H, T], the forward's) P = exp(S - lse) in place of softmax(S)."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    allowed = (mask[:, None, :, None] == mask[:, None, None, :])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if lse is None:
        probs = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
    else:
        probs = torch.exp(s - lse.double()[..., None]).masked_fill(~allowed, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = probs * (dp - delta.double()[..., None])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", probs, do))


def near_parallel_errors(ta, case, kernel_delta=True):
    """The f32 backward of ``ta`` (the port's ``models.attention``) on the
    seeded problem ``case`` of :func:`digest_problem` with q, k, v moved to
    near-parallel positive rows (1 + 0.01 N(0, 1)): for dQ, dK, dV, the
    largest error against the f64 plain backward over :func:`term_magnitudes`
    element by element (``ratio``), the error over the f64 gradient's
    largest entry (``of_scale``) and the f32 plain backward's
    (``plain_f32_of_scale``); with ``kernel_delta`` the error over the
    largest entry of the f64 backward that takes the kernel's own D (its
    pre-pass, ``flash_attention_bwd_delta``), which leaves out D's f32
    roundings (``given_d_of_scale``), and of the one that also takes the
    forward's f32 lse, which leaves out its roundings too
    (``given_d_lse_of_scale``); and whether the kernel's gradients are
    finite."""
    q, k, v, mask, do = digest_problem(*case, torch.float32)
    q, k, v = (1.0 + 0.01 * x for x in (q, k, v))
    out, lse = ta.flash_attention_fwd(q, k, v, mask, with_lse=True)
    got = ta.flash_attention_bwd(q, k, v, out, do, mask, lse)
    plain = ta.flash_attention_bwd_plain(q, k, v, out, do, mask)
    x = [y.double() for y in (q, k, v, do)]
    want = ta.flash_attention_bwd_plain(x[0], x[1], x[2], None, x[3], mask)
    bounds = term_magnitudes(q, k, v, do, mask)

    def of_scale(grads, refs):
        return [((g.double() - w).abs().max() / w.abs().max()).item()
                for g, w in zip(grads, refs)]

    given_d = given_d_lse = None
    if kernel_delta:
        delta = ta.flash_attention_bwd_delta(out, do)
        given_d = of_scale(got, bwd_given_delta(q, k, v, do, mask, delta))
        given_d_lse = of_scale(got, bwd_given_delta(q, k, v, do, mask, delta, lse))
    return {
        "ratio": [((g.double() - w).abs() / m).max().item()
                  for g, w, m in zip(got, want, bounds)],
        "of_scale": of_scale(got, want),
        "plain_f32_of_scale": of_scale(plain, want),
        "given_d_of_scale": given_d,
        "given_d_lse_of_scale": given_d_lse,
        "finite": all(bool(torch.isfinite(g).all()) for g in got),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default="", help="checkout to import convdr_torch from")
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--dtype", default="f32,bf16", help="f32, bf16 or both")
    parser.add_argument("--digests", action="store_true",
                        help="print the gradients' digests of seeded problems")
    parser.add_argument("--near-parallel", action="store_true",
                        help="f32 errors on near-parallel rows (NEAR_PARALLEL_CASES) alone")
    args = parser.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules if m.split(".")[0] == "convdr_torch"]:
            del sys.modules[name]
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd_bench needs a CUDA device")
    from convdr_torch.core.device import set_exact_matmul
    from convdr_torch.models import attention as ta
    from convdr_torch.ops import cuda_build
    from convdr_torch.scripts.score_sweep import digest

    set_exact_matmul()
    cuda_build.build(["flash_attention", "flash_attention_bwd"])
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    def inputs(batch, t, dtype, gen, random_mask=False):
        shape = (batch, t, HEADS, HEAD_DIM)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
        if random_mask:
            mask = (torch.rand((batch, t), generator=gen, device="cuda") < 0.5).to(torch.int32)
            mask[:, 0] = 1
            return q, k, v, do, mask
        lens = torch.randint(1, t + 1, (batch,), generator=gen, device="cuda")
        lens[0] = t
        lens[-1] = 0
        mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        return q, k, v, do, mask

    def host_paced_ms(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def device_ms(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def kernel_ms(fn, calls=20):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            dev = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            if dev and "kernel" in ev.key:
                name = ev.key.split("(anonymous namespace)::")[-1].split("(")[0]
                out[name] = dev / ev.count / 1e3
        return out

    # a parent checkout's (--root) pre-pass may take bf16 alone
    f32_delta = True
    if args.root:
        try:
            ta.flash_attention_bwd_delta(*[torch.zeros((1, 1, 1, 16), device="cuda")] * 2)
        except ValueError:
            f32_delta = False

    def prepass(out, do):
        if out.dtype == torch.float32 and not f32_delta:
            return None
        return device_ms(lambda: ta.flash_attention_bwd_delta(out, do))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"label": args.label, "card": smi}
    if args.near_parallel:
        for case in NEAR_PARALLEL_CASES:
            key = "near_parallel_B{}xT{}xH{}xD{}_{}".format(*case)
            result[key] = near_parallel_errors(ta, case, f32_delta)
        print(json.dumps(result), flush=True)
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.dtype.split(","):
        dtype = dtypes[name]
        cases = [(b, t, False) for b, t in SHAPES[name]]
        if name == "f32":
            cases.append((4, 256, True))
        for batch, t, random_mask in cases:
            q, k, v, do, mask = inputs(batch, t, dtype, gen, random_mask)
            out, lse = ta.flash_attention_fwd(q, k, v, mask, with_lse=True)
            call = lambda: ta.flash_attention_bwd(q, k, v, out, do, mask, lse)  # noqa: E731
            bound, by = bound_ms(q, mask)
            row = {"host_paced_ms": [host_paced_ms(call) for _ in range(3)],
                   "device_ms": [device_ms(call) for _ in range(3)],
                   "bound_ms": bound, "bound_by": by,
                   "prepass_device_ms": prepass(out, do),
                   "kernel_ms": kernel_ms(call)}
            if dtype == torch.float32:
                row["design_operations_ms"] = (design_operations(mask, HEADS, HEAD_DIM)
                                               / PEAK_FLOPS[torch.bfloat16] * 1e3)
                row["cuda_core_bound_ms"] = cuda_core_bound_ms(q, mask)
            leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
            allowed = mask[:, None, :, None] == mask[:, None, None, :]
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
            dot = do.transpose(1, 2)
            row["sdpa_bwd_device_ms"] = device_ms(
                lambda: torch.autograd.grad(lib_out, leaves, dot, retain_graph=True))
            if batch * t <= 4096:
                got = call()
                x = [y.double() for y in (q, k, v, do)]
                want = ta.flash_attention_bwd_plain(x[0], x[1], x[2], None, x[3], mask)
                row["error_of_scale_vs_f64"] = [
                    ((g.double() - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
            result[f"{name}_B{batch}xT{t}" + ("_random" if random_mask else "")] = row
        if args.digests:
            for b, t, h, d, kind in DIGEST_CASES:
                q, k, v, mask, do = digest_problem(b, t, h, d, kind, dtype)
                out, lse = ta.flash_attention_fwd(q, k, v, mask, with_lse=True)
                grads = ta.flash_attention_bwd(q, k, v, out, do, mask, lse)
                result[f"digest_{name}_B{b}xT{t}xH{h}xD{d}_{kind}"] = digest(*grads)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
