"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix and
its metrics are found by name (benchmark/spec.py). The last line of standard
output is the result, one JSON object; the numbers compared with the plain
reference, each with its limit, are the last lines of standard error and the
result's last key. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits with 2.
"""

import time

T_PROCESS = time.monotonic()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The checkout's root, in place of this script's folder, whose module names
# would shadow top-level ones.
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Every cache a run could write stays inside the checkout, at fixed paths.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))

    from benchmark import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    t_torch = time.monotonic()
    import torch

    t_cuda = time.monotonic()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    t_run = time.monotonic()
    # Set-up before the harness: Python's start, the torch import, the driver's start.
    before = {"python": t_torch - T_PROCESS, "torch_import": t_cuda - t_torch,
              "cuda_driver": t_run - t_cuda}
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS,
                           before)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for note in out["notes"]:
        print(note, file=sys.stderr)
    for name, v in out["compared"].items():
        print(f"compared {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
