"""Time the bf16 flash-attention backward (kernel 1b) on the card.

At the bf16 student's shape (B=4 T=256 H=12 D=64) and the teacher
documents' (B=40 T=512), right-padded masks drawn as chip_smoke.py draws
them: the wrapper host-paced and on the device alone (queued behind a spin
kernel), the D pre-pass alone where the package has it, autograd through
masked SDPA's backward on the device, each kernel's device time by name
(``torch.profiler``), and the error of each gradient over its largest entry
against the plain backward in f64.

``--root`` imports ``convdr_torch`` from another checkout (a parent unpacked
with ``git archive``), so two versions compare within one call on one card:

    python -m convdr_torch.scripts.attention_bwd_bench --root parent --label parent
    python -m convdr_torch.scripts.attention_bwd_bench --label change

Needs the card; prints one JSON line a version.
"""

import argparse
import json
import subprocess
import sys

HEADS, HEAD_DIM = 12, 64
SHAPES = ((4, 256), (40, 512))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default="", help="checkout to import convdr_torch from")
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules if m.split(".")[0] == "convdr_torch"]:
            del sys.modules[name]
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd_bench needs a CUDA device")
    from convdr_torch.models import attention as ta
    from convdr_torch.ops import cuda_build

    cuda_build.build(["flash_attention", "flash_attention_bwd"])
    bf16 = torch.bfloat16

    def inputs(batch, t, gen):
        shape = (batch, t, HEADS, HEAD_DIM)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(bf16) for _ in range(4))
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"label": args.label, "card": smi}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch, t in SHAPES:
        q, k, v, do, mask = inputs(batch, t, gen)
        out, lse = ta.flash_attention_fwd(q, k, v, mask, with_lse=True)
        call = lambda: ta.flash_attention_bwd(q, k, v, out, do, mask, lse)  # noqa: E731
        row = {"host_paced_ms": [host_paced_ms(call) for _ in range(3)],
               "device_ms": [device_ms(call) for _ in range(3)]}
        if hasattr(ta, "flash_attention_bwd_delta"):
            row["prepass_device_ms"] = device_ms(lambda: ta.flash_attention_bwd_delta(out, do))
        row["kernel_ms"] = kernel_ms(call)
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
        result[f"B{batch}xT{t}"] = row
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
