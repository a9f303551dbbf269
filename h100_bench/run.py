"""Run one cell of the benchmark of convdr_torch on the card.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the comparison's numbers beside their
limits as the last lines of standard error, and one JSON object as the last
line of standard output. Exits non-zero with no result when the card is
missing, when the cell asks for more cards than there are, or when JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# import the benchmark as a package, and the program, from the checkout's
# root: never the benchmark's modules by their bare names, never an
# installed copy of the program
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "convdr_torch")):
        print(f"error: no convdr_torch in {ROOT}: the program under test is missing",
              file=sys.stderr)
        return 2
    import torch

    from h100_bench import harness

    manifest = harness.load_manifest()
    wl, _cfg, _mix = harness.load_cell(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {wl['chips']} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run_cell(manifest, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T_START)
    found = result.pop("_forbidden")
    if found:
        print(f"error: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
