"""Kernels 2 and 3 (``csrc/scores_groupmax.cu``) across the query count, on the card.

Over one block of 524,288 seeded N(0, 1) rows of D=768, stored in f32 and
in bf16, at Q = 1, 2, 4, 8, 16, 32, 64, 128, 256 and 512: kernel 2
(``fused_scores_groupmax``, G=32) and kernel 3 (``streaming_groupmax``,
G=128) are called at Q and held bit for bit (``torch.equal``) to the first
rows of a Q=65 batch (the 128-query tiles of the six-part (f32) or
three-part (bf16) ``wgmma`` kernel, against its small-Q tiles up to Q=64
and its other tiles above); a mismatch raises. Each is timed on the device
(the calls queued behind a spin kernel, so no host time is in it) beside
its bound, one library call of the same function (``torch.matmul`` with
TF32 off on f32 operands, then ``amax``; the bf16 block cast to f32
beforehand) and the Q=65 batch. The bound is the larger of the bytes over
3.35 TB/s and the operations over the peak of the units that do them: the
six-part (f32) or three-part (bf16) product's 6 or 3 x 2QND at the 989
TFLOP/s bf16 tensor-core peak (both printed). Kernel 2 at Q=1 is also
timed host-paced.

Kernel 4 (pass B, ``extract_candidate_scores_unchecked``, G=128) on the
same f32 and bf16 rows at Q = 64 and 512, over the 101 groups kernel 3's
maxima pick (the streaming search's selection): held bit for bit to
kernel 2's scores of those groups, timed on the device beside its bound
(the picked groups' rows, the queries and ids read once, the [Q, 101, G]
scores written once; the six- or three-part operations at the bf16
peak).

With int8 passages (the device SQ8 of the same rows, scales fitted on the
first 65,536, and the int-valued queries of the same quantizer) at Q = 1,
8, 32, 64, 128, 256 and 512: kernels 2 and 3 held bit for bit to the plain
version (integer sums, exact in f32), timed on the device beside their
bound (bytes, or 2QND at the 1979 TOP/s int8 peak) and one library call
(``torch._int_mm``, then ``.float()`` and ``amax``; none below Q=17, which
``_int_mm`` does not take).

``--root`` imports ``convdr_torch`` from another checkout (a parent
unpacked with ``git archive``), so two versions compare within one call on
one card; ``--digests`` adds a digest of every output, and of kernels 2
and 3 at Q=512 (f32, bf16) and with int8 passages at Q = 1, 64 and 512, so
that the outputs of two checkouts compare bit for bit across processes,
and the worst error of kernel 2's f32 and bf16 scores at Q=512 against the
f64 product of the same operands, as a share of sum |q_k p_k|, with that
of its f32 scores on near-parallel positive rows (1 + 0.01 N(0, 1): long
one-signed sums, the hardest case of a truncating tensor-core sum) and
their worst error as a share of the f32 tolerance 1e-5 |q| max|p| from
the plain f32 product:

    python -m convdr_torch.scripts.score_sweep --root parent --label parent --digests
    python -m convdr_torch.scripts.score_sweep --label change --digests

Needs the card; prints one JSON line a version.
"""

import argparse
import hashlib
import json
import sys

import torch

N, D, GROUP, STREAM_GROUP = 524288, 768, 32, 128
QS = (1, 2, 4, 8, 16, 32, 64)
BF16_QS = QS + (128, 256, 512)  # f32 and bf16 passages
TILE_Q = 65  # the smallest batch the 128-row query tile takes
# the bf16 tensor-core products a score kernel issues for 2QND: f32
# passages six (the parts of q and p), bf16 three (the parts of q)
PRODUCT_PARTS = {torch.float32: 6, torch.bfloat16: 3}
INT8_QS = (1, 8, 32, 64, 128, 256, 512)
INT8_MM_MIN_Q = 17  # torch._int_mm takes no fewer rows
DIGEST_QS = (1, 64, 512)  # int8 passages, and Q=512 in f32 and bf16
PASS_B_QS, PASS_B_GROUPS = (64, 512), 101  # kernel 4: Q, and the groups a query picks
# published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit),
# which chip_smoke and scripts/attention_sweep.py take from here
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}


def device_ms(fn, iters=20):
    """Mean device time of ``fn()`` in ms, the calls queued behind a ~50 ms
    spin kernel so that the events time the kernels back to back."""
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


def host_paced_ms(fn, iters=50):
    """Mean time of ``fn()`` in ms with the host launching each call."""
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


def bound_parts(qn, p, group, scores):
    """(bytes ms, operations ms) of one call at Q=qn over passages ``p``:
    each input read once (f32 queries; int8 queries for int8 passages),
    each output written once ([Q, N] scores if ``scores``, [Q, N/G]
    maxima); the operations 2QND at the int8 tensor-core peak (int8
    passages), or six (f32: the six-part product) or three (bf16: the
    three-part product) times that at the bf16 tensor-core peak."""
    n, d = p.shape
    int8 = p.dtype == torch.int8
    nbytes = qn * d * (1 if int8 else 4) + p.numel() * p.element_size() + qn * (n // group) * 4
    if scores:
        nbytes += qn * n * 4
    flops = 2.0 * qn * n * d * PRODUCT_PARTS.get(p.dtype, 1)
    unit = torch.int8 if int8 else torch.bfloat16
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[unit] * 1e3


def bound_ms(qn, p, group, scores):
    """The least time (ms) of one call (:func:`bound_parts`: the larger of
    the two) and which of the two bounds it."""
    bytes_ms, ops_ms = bound_parts(qn, p, group, scores)
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms else "bytes")


def digest(*tensors):
    """A digest of the tensors' bytes (any dtype, bf16 included)."""
    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        h.update(t.contiguous().flatten().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def sweep(qs=BF16_QS, n=N, d=D, seed=0, digests=False, int8_qs=INT8_QS, log=print):
    """The readings above, as ``{dtype: {"Q<q>": row, "tile_Q65": ...},
    "int8": {"Q<q>": row}}``; with ``digests``, each row's ``digest`` and a
    ``digests`` entry of the Q=512 and int8 outputs and the f32 and bf16
    errors. ``qs`` is the f32 and bf16 sweep's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q_all = torch.randn(TILE_Q, d, generator=gen, device="cuda")
    p32 = torch.randn(n, d, generator=gen, device="cuda")
    # from Q=65 up: more queries of the same generator after the first 65
    q_more = torch.randn(max(qs) - TILE_Q, d, generator=gen, device="cuda")
    q_all = torch.cat([q_all, q_more])
    out = {"float32": q_sweep(q_all, p32, qs, digests, log)}
    out["bfloat16"] = q_sweep(q_all, p32.to(torch.bfloat16), qs, digests, log)
    out["pass_b"] = pass_b_sweep(q_all, p32, digests, log)
    out["int8"] = int8_sweep(p32, seed, int8_qs, digests, log)
    if digests:
        out["digests"] = other_digests(p32, seed)
    del p32
    torch.cuda.empty_cache()
    return out


def q_sweep(q_all, p, qs, digests, log):
    """Kernels 2 and 3 on f32 or bf16 passages ``p`` at each Q of ``qs``
    (the first Q rows of ``q_all``): equal to the first rows of the Q=65
    batch (else raises), device ms beside the bound and ``matmul`` +
    ``amax`` on the f32 cast."""
    from convdr_torch.ops.fused_search import fused_scores_groupmax
    from convdr_torch.ops.streaming_search import streaming_groupmax

    name = str(p.dtype)[6:]
    pf = p.float()
    q_tile = q_all[:TILE_Q].contiguous()
    s_tile, g_tile = fused_scores_groupmax(q_tile, p, GROUP)
    m_tile = streaming_groupmax(q_tile, p, STREAM_GROUP)
    rows = {"tile_Q65": {
        "kernel2_ms": device_ms(lambda: fused_scores_groupmax(q_tile, p, GROUP)),
        "kernel3_ms": device_ms(lambda: streaming_groupmax(q_tile, p, STREAM_GROUP))}}
    for qn in qs:
        q = q_all[:qn].contiguous()
        s, g = fused_scores_groupmax(q, p, GROUP)
        m = streaming_groupmax(q, p, STREAM_GROUP)
        c = min(qn, TILE_Q)
        if not (torch.equal(s[:c], s_tile[:c]) and torch.equal(g[:c], g_tile[:c])
                and torch.equal(m[:c], m_tile[:c])):
            raise AssertionError(f"{name} Q={qn}: kernels 2 / 3 differ from the first "
                                 f"{c} rows of the Q={TILE_Q} batch")
        k2 = lambda: fused_scores_groupmax(q, p, GROUP)  # noqa: E731
        k3 = lambda: streaming_groupmax(q, p, STREAM_GROUP)  # noqa: E731
        lib2 = lambda: torch.matmul(q, pf.T).view(qn, -1, GROUP).amax(-1)  # noqa: E731
        lib3 = lambda: torch.matmul(q, pf.T).view(qn, -1, STREAM_GROUP).amax(-1)  # noqa: E731
        b2, by2 = bound_ms(qn, p, GROUP, True)
        b3, by3 = bound_ms(qn, p, STREAM_GROUP, False)
        bytes2, ops2 = bound_parts(qn, p, GROUP, True)
        bytes3, ops3 = bound_parts(qn, p, STREAM_GROUP, False)
        row = {"equal_to_tile_batch": True,
               "kernel2_ms": device_ms(k2), "kernel2_bound_ms": b2,
               "kernel2_bound_by": by2, "kernel2_bytes_ms": bytes2, "kernel2_operations_ms": ops2,
               "kernel2_library_ms": device_ms(lib2),
               "kernel3_ms": device_ms(k3), "kernel3_bound_ms": b3,
               "kernel3_bound_by": by3, "kernel3_bytes_ms": bytes3, "kernel3_operations_ms": ops3,
               "kernel3_library_ms": device_ms(lib3)}
        if qn == 1:
            row["kernel2_host_paced_ms"] = host_paced_ms(k2)
            row["kernel2_library_host_paced_ms"] = host_paced_ms(lib2)
        if digests:
            row["digest"] = digest(s, g, m)
        rows[f"Q{qn}"] = row
        log(f"  {name} Q={qn}: kernel 2 {row['kernel2_ms']:.4f} ms (bound {b2:.4f}, {by2}: "
            f"bytes {bytes2:.4f}, operations {ops2:.4f}; library "
            f"{row['kernel2_library_ms']:.4f}), kernel 3 {row['kernel3_ms']:.4f} ms (bound "
            f"{b3:.4f}, {by3}; library {row['kernel3_library_ms']:.4f}); equal to the "
            f"Q={TILE_Q} batch's rows")
        del s, g, m
    log(f"  {name} Q={TILE_Q}: kernel 2 {rows['tile_Q65']['kernel2_ms']:.4f} ms, "
        f"kernel 3 {rows['tile_Q65']['kernel3_ms']:.4f} ms")
    del pf, s_tile, g_tile, m_tile
    torch.cuda.empty_cache()
    return rows


def pass_b_sweep(q_all, p32, digests, log):
    """Kernel 4 on f32 and bf16 passages at each Q of :data:`PASS_B_QS`
    over the groups kernel 3's maxima pick: equal to kernel 2's scores of
    those groups (else raises), device ms beside the bound."""
    from convdr_torch.ops.exact_search import grouped_topk_last_axis
    from convdr_torch.ops.fused_search import fused_scores_groupmax
    from convdr_torch.ops.streaming_search import (
        extract_candidate_scores_unchecked,
        streaming_groupmax,
    )

    rows = {}
    for p in (p32, p32.to(torch.bfloat16)):
        name = str(p.dtype)[6:]
        d = p.shape[1]
        for qn in PASS_B_QS:
            q = q_all[:qn].contiguous()
            gmax = streaming_groupmax(q, p, STREAM_GROUP)
            gsel = torch.sort(grouped_topk_last_axis(gmax, PASS_B_GROUPS, 32)[1], dim=1)[0]
            call = lambda: extract_candidate_scores_unchecked(q, p, gsel, STREAM_GROUP)  # noqa: E731
            cand = call()
            s = fused_scores_groupmax(q, p, STREAM_GROUP)[0].view(qn, -1, STREAM_GROUP)
            if not torch.equal(cand, torch.gather(s, 1, gsel[:, :, None].expand(
                    -1, -1, STREAM_GROUP))):
                raise AssertionError(f"{name} Q={qn}: kernel 4 differs from kernel 2's scores")
            del s
            picked = int(torch.unique(gsel).numel())
            nbytes = (picked * STREAM_GROUP * d * p.element_size() + q.numel() * 4
                      + gsel.numel() * gsel.element_size() + cand.numel() * 4)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = (2.0 * cand.numel() * d * PRODUCT_PARTS[p.dtype]
                      / PEAK_FLOPS[torch.bfloat16] * 1e3)
            row = {"equal_to_kernel2": True, "picked_groups": picked,
                   "kernel4_ms": device_ms(call), "kernel4_bound_ms": max(bytes_ms, ops_ms),
                   "kernel4_bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                   "kernel4_bytes_ms": bytes_ms, "kernel4_operations_ms": ops_ms}
            if digests:
                row["digest"] = digest(cand)
            rows[f"{name}_Q{qn}"] = row
            log(f"  kernel 4 {name} Q={qn} kg={PASS_B_GROUPS} G={STREAM_GROUP}: "
                f"{row['kernel4_ms']:.4f} ms (bound {row['kernel4_bound_ms']:.4f}, "
                f"{row['kernel4_bound_by']}; {picked} groups picked); equal to kernel 2's scores")
            del cand
    return rows


def int8_operands(p32, q32):
    """The device SQ8 of ``p32`` (scales fitted on its first 65536 rows)
    and the int-valued f32 queries of the same quantizer."""
    from convdr_torch.ops.quant import Int8Quantizer, quantize_passages_dev

    quant = Int8Quantizer.fit(p32[:65536].cpu().numpy())
    p8 = quantize_passages_dev(p32, torch.from_numpy(quant.scales).cuda())
    q8 = torch.from_numpy(quant.quantize_queries(q32.cpu().numpy())[0]).cuda()
    return q8, p8


def int8_sweep(p32, seed, qs, digests, log):
    """Kernels 2 and 3 on int8 passages at each Q: equal to the plain
    version (else raises), device ms beside the bound and ``_int_mm`` +
    ``.float()`` + ``amax`` (None below :data:`INT8_MM_MIN_Q`)."""
    from convdr_torch.ops.fused_search import fused_scores_groupmax, fused_scores_groupmax_plain
    from convdr_torch.ops.streaming_search import streaming_groupmax

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    q_all, p = int8_operands(p32, torch.randn(max(qs), p32.shape[1], generator=gen,
                                              device="cuda"))
    pt = p.T
    rows = {}
    for qn in qs:
        q = q_all[:qn].contiguous()
        s, g = fused_scores_groupmax(q, p, GROUP)
        m = streaming_groupmax(q, p, STREAM_GROUP)
        s_ref, g_ref = fused_scores_groupmax_plain(q, p, GROUP)
        m_ref = s_ref.view(qn, -1, STREAM_GROUP).amax(-1)
        if not (torch.equal(s, s_ref) and torch.equal(g, g_ref) and torch.equal(m, m_ref)):
            raise AssertionError(f"int8 Q={qn}: kernels 2 / 3 differ from the plain version")
        del s_ref, g_ref, m_ref
        b2, by2 = bound_ms(qn, p, GROUP, True)
        b3, by3 = bound_ms(qn, p, STREAM_GROUP, False)
        row = {"equal_to_plain": True,
               "kernel2_ms": device_ms(lambda: fused_scores_groupmax(q, p, GROUP)),
               "kernel2_bound_ms": b2, "kernel2_bound_by": by2, "kernel2_library_ms": None,
               "kernel3_ms": device_ms(lambda: streaming_groupmax(q, p, STREAM_GROUP)),
               "kernel3_bound_ms": b3, "kernel3_bound_by": by3, "kernel3_library_ms": None}
        if qn >= INT8_MM_MIN_Q:
            q8 = q.to(torch.int8)
            for k, group in (("kernel2", GROUP), ("kernel3", STREAM_GROUP)):
                row[f"{k}_library_ms"] = device_ms(
                    lambda grp=group: torch._int_mm(q8, pt).float().view(qn, -1, grp).amax(-1))
        if digests:
            row["digest"] = digest(s, g, m)
        rows[f"Q{qn}"] = row
        lib = lambda k: ("none" if row[f"{k}_library_ms"] is None  # noqa: E731
                         else f"{row[f'{k}_library_ms']:.4f}")
        log(f"  int8 Q={qn}: kernel 2 {row['kernel2_ms']:.4f} ms (bound {b2:.4f}, {by2}; "
            f"library {lib('kernel2')}), kernel 3 {row['kernel3_ms']:.4f} ms (bound {b3:.4f}, "
            f"{by3}; library {lib('kernel3')}); equal to the plain version")
        del s, g, m
    return rows


def other_digests(p32, seed):
    """Digests of kernels 2 and 3 at Q=512 (f32, bf16) and with int8
    passages (the device SQ8 of the rows, scales fitted on the first 65536,
    and the int-valued queries of the same quantizer) at Q = 1, 64, 512;
    ``float32_worst_share`` and ``bfloat16_worst_share``: the largest |s -
    s64| / sum_k |q_k p_k| of kernel 2's f32 and bf16 scores at Q=512
    against the f64 product of the same operands; and
    :func:`near_parallel_shares`."""
    from convdr_torch.ops.fused_search import fused_scores_groupmax
    from convdr_torch.ops.streaming_search import streaming_groupmax

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q512 = torch.randn(512, p32.shape[1], generator=gen, device="cuda")
    q8, p8 = int8_operands(p32, q512)
    out = {}
    for name, q, p, qs in (("float32", q512, p32, (512,)),
                           ("bfloat16", q512, p32.to(torch.bfloat16), (512,)),
                           ("int8", q8, p8, DIGEST_QS)):
        for qn in qs:
            s, g = fused_scores_groupmax(q[:qn], p, GROUP)
            out[f"{name}_Q{qn}"] = digest(s, g, streaming_groupmax(q[:qn], p, STREAM_GROUP))
            if name != "int8":
                out[f"{name}_worst_share"] = worst_share(s, q[:qn], p)
            del s, g
    out.update(near_parallel_shares(seed))
    return out


def near_parallel_shares(seed, qn=64, n=65536, d=D):
    """Kernel 2's f32 scores on near-parallel positive rows, 1 + 0.01 N(0,
    1) for queries and passages (Q=64, N=65536): the worst error as a share
    of sum |q_k p_k| from the f64 product (``float32_nearparallel_worst_share``)
    and as a share of the f32 tolerance 1e-5 |q| max|p| from the plain f32
    product (``float32_nearparallel_tolerance_share``)."""
    from convdr_torch.ops.fused_search import fused_scores_groupmax, fused_scores_groupmax_plain

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    q = 1 + 0.01 * torch.randn(qn, d, generator=gen, device="cuda")
    p = 1 + 0.01 * torch.randn(n, d, generator=gen, device="cuda")
    s = fused_scores_groupmax(q, p, GROUP)[0]
    tol = 1e-5 * q.norm(dim=1)[:, None] * p.norm(dim=1).max()
    return {"float32_nearparallel_worst_share": worst_share(s, q, p),
            "float32_nearparallel_tolerance_share":
                ((s - fused_scores_groupmax_plain(q, p, GROUP)[0]).abs() / tol).max().item()}


def worst_share(s, q, p, chunk=64):
    """max |s - q p^T| / (|q| |p|^T) over every score, the product in f64
    (queries ``chunk`` at a time)."""
    pd = p.double()
    worst = 0.0
    for lo in range(0, q.shape[0], chunk):
        qd = q[lo:lo + chunk].double()
        err = (s[lo:lo + chunk].double() - qd @ pd.T).abs() / (qd.abs() @ pd.abs().T)
        worst = max(worst, err.max().item())
        del qd, err
    del pd
    torch.cuda.empty_cache()
    return worst


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default="", help="checkout to import convdr_torch from")
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--digests", action="store_true",
                        help="also digest every output (Q=512 and int8 included)")
    args = parser.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules if m.split(".")[0] == "convdr_torch"]:
            del sys.modules[name]
    if not torch.cuda.is_available():
        raise SystemExit("score_sweep needs a CUDA device")
    from convdr_torch.core.device import set_exact_matmul
    from convdr_torch.ops import cuda_build

    set_exact_matmul()
    cuda_build.build(["scores_groupmax"])
    result = sweep(digests=args.digests, log=lambda *a: print(*a, file=sys.stderr, flush=True))
    print(json.dumps({"label": args.label, "card": torch.cuda.get_device_name(0),
                      "sweep": result}), flush=True)


if __name__ == "__main__":
    main()
