"""The control of the comparison that decides `correct`: the plain reference
put in the system's place, with its visited set keyed by a salted 32-bit
hash of each state where the system keeps a 64-bit fingerprint (the
reference module's `control_key`). States whose keys collide are merged,
which breaks the configuration's guarantee that every reachable state is
visited. Its counts and its discoveries' paths go through the harness's own
`judge` and `verdict` as one completed check of a run, so `correct` comes
out of the same code that decides a real run. The benchmark's own runs
never run this.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 [--device cuda]

prints one JSON line per seed: the numbers compared, each beside its limit,
and the verdict.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from benchmark import harness, spec  # noqa: E402


def readings(cell, seed: int, device: str, exact=None, key=None) -> dict:
    """The control's check on `seed`, judged against `exact` (the
    reference's own search; searched here when not given). `key` replaces
    the reference's control key."""
    ref = spec.reference_module(cell.config, cell.root)
    if exact is None:
        exact = ref.expected(cell.config, device=device)
    t0 = time.monotonic()
    ctl = ref.expected(cell.config, device=device, keep_levels=True,
                       key=key or ref.control_key(cell.config, seed))
    check = harness.CheckRecord(generated=ctl.generated, unique=ctl.unique, depth=ctl.depth,
                                complete=True, paths=ref.shortest_paths(ctl))
    run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                      kind="control", checks=[check], expected=exact, reference=ref)
    compared, notes, _ = harness.judge(run)
    return {"seed": seed, "seconds": time.monotonic() - t0, "notes": notes[:5],
            "compared": compared, "correct": harness.verdict(compared)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control of the comparison")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    ref = spec.reference_module(cell.config, cell.root)
    t0 = time.monotonic()
    exact = ref.expected(cell.config, device=args.device)
    print(json.dumps({"exact": [exact.generated, exact.unique, exact.depth],
                      "seconds": time.monotonic() - t0}), flush=True)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.device, exact)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
