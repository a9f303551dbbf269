"""The readings that set the limits of a cell's comparison, on the card.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 100-111 \
        --control-seeds 200-202 --seconds 2 --out <file.json>

In one process: the program's numbers on each of ``--seeds`` (set-up, a
short window at the cell's own load, the check, as a run makes them), then
on each of ``--control-seeds`` the control's (the plain reference in TF32
put in the program's place) and, where the driver plants faults, each
fault's. The largest of the program's readings is a limit's lower end; the
smallest of the control's (or a training fault's) its upper end. The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def program_numbers(manifest, cell, seed, seconds, device):
    from h100_bench import harness

    _wl, cfg, mix = harness.load_cell(manifest, cell)
    ctx = harness.Ctx(cfg, mix, seed, seconds, device)
    driver = harness.load_driver(mix["driver"])
    st = driver.setup(ctx)
    obs = driver.window(ctx, st)
    numbers = driver.check(ctx, st, obs)
    if getattr(st, "diagnostics", None):
        print(f"  seed {seed}: {st.diagnostics}", flush=True)
    return numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, default=[])
    parser.add_argument("--control-seeds", type=seeds, default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    import torch

    from h100_bench import harness, program

    device = torch.device("cuda", 0)
    manifest = harness.load_manifest()
    _wl, cfg, mix = harness.load_cell(manifest, args.workload)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    program.build_kernels()
    driver = harness.load_driver(mix["driver"])
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
           "program": {}, "control": {}, "faults": {}}

    def save():
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    for seed in args.seeds:
        t0 = time.perf_counter()
        out["program"][seed] = program_numbers(manifest, args.workload, seed, args.seconds, device)
        print(f"program seed {seed}: {out['program'][seed]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        save()
    for seed in args.control_seeds:
        ctx = harness.Ctx(cfg, mix, seed, args.seconds, device)
        out["control"][seed] = driver.control(ctx)
        print(f"control seed {seed}: {out['control'][seed]}", flush=True)
        if hasattr(driver, "faults"):
            out["faults"][seed] = driver.faults(ctx)
            print(f"faults seed {seed}: {out['faults'][seed]}", flush=True)
        save()
    for side in ("program", "control"):
        if out[side]:
            names = next(iter(out[side].values()))
            print(side, {n: (min(r[n] for r in out[side].values()),
                             max(r[n] for r in out[side].values())) for n in names})
    print(f"total {time.perf_counter() - T_START:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
