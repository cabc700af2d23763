"""The compiled CPU baseline checker (baseline_bfs.cpp): build it and run it.

The baseline is a multithreaded level-synchronous BFS over the same models
the device engines run (`paxos C`, `2pc N`, `increment_lock N`), with a
mutex-sharded visited set of 64-bit fingerprints. Its generated and unique
counts equal the engines' goldens; its seconds are the yardstick that the
port's device numbers are reported against.

    from stateright_tpu_torch._native.baseline import run_baseline
    run_baseline("paxos", 3)  # {'states': 2420477, 'unique': 1194428, ...}

or from a shell, one run printed as a JSON line with its states/s and the
host's CPU model:

    python -m stateright_tpu_torch._native.baseline paxos 3 [threads]

`run_baseline` runs the executable once and raises on any failure (a build
error, a nonzero exit, a timeout, an unparseable line): repeats and their
statistics belong to the caller.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Optional

from . import build

#: The one stdout line the checker prints.
LINE = re.compile(
    r"model=(\S+) states=(\d+) unique=(\d+) depth=(\d+) sec=([\d.]+) "
    r"threads=(\d+) violations=(\d+)"
)
POOL = re.compile(r"max_pool_used=(\d+)")
RUN_TIMEOUT_S = 1800.0


class BaselineError(RuntimeError):
    """The checker exited nonzero or timed out; `returncode` is its exit
    code (None after a timeout)."""

    def __init__(self, msg: str, returncode: Optional[int]):
        super().__init__(msg)
        self.returncode = returncode


def compile_baseline() -> Path:
    """Build (once per source and flags) and return the baseline executable.
    Raises RuntimeError with the compiler's output when the build fails."""
    return build("baseline_bfs", exe=True)


def parse_line(stdout: str, stderr: str = "") -> dict:
    """The checker's report as a dict: `model`, `states`, `unique`, `depth`,
    `sec`, `threads`, `violations`, and `max_pool_used` when stderr carries
    it (Paxos). Raises ValueError on output without the report line."""
    m = LINE.search(stdout)
    if m is None:
        raise ValueError(f"baseline output has no report line: {stdout!r}")
    out = {
        "model": m.group(1),
        "states": int(m.group(2)),
        "unique": int(m.group(3)),
        "depth": int(m.group(4)),
        "sec": float(m.group(5)),
        "threads": int(m.group(6)),
        "violations": int(m.group(7)),
    }
    p = POOL.search(stderr)
    if p is not None:
        out["max_pool_used"] = int(p.group(1))
    return out


def run_baseline(model: str, n: int, threads: Optional[int] = None,
                 timeout: float = RUN_TIMEOUT_S, exe: Optional[Path] = None) -> dict:
    """Run the baseline once on `model n` (`threads` pins the checker's
    thread count; None lets it take the host's hardware concurrency) and
    return `parse_line`'s dict. `exe` defaults to `compile_baseline()`.

    Raises BaselineError (a RuntimeError) on a nonzero exit, with the exit
    code (2: bad arguments, such as an unknown model or paxos with more
    than 3 clients; 3: the Paxos pool overflowed) and the checker's stderr,
    or on a timeout; and ValueError on an unparseable line."""
    exe = compile_baseline() if exe is None else exe
    cmd = [str(exe), model, str(n)] + ([] if threads is None else [str(threads)])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise BaselineError(f"baseline {model} {n} timed out after {timeout} s", None) from e
    if proc.returncode != 0:
        raise BaselineError(
            f"baseline {model} {n} exited {proc.returncode}: {proc.stderr.strip()}",
            proc.returncode)
    return parse_line(proc.stdout, proc.stderr)


def host_cpu() -> str:
    """The host's CPU model: `lscpu`'s "Model name" (or "BIOS Model name"),
    else /proc/cpuinfo's, else its vendor, family and model numbers, where
    a virtual machine names no model."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        out = ""
    fields = {}
    for line in out.splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip(), value.strip())
    known = [v for v in (fields.get("Model name"), fields.get("BIOS Model name"))
             if v and v.lower() not in ("unknown", "-")]
    if known:
        return known[0]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() == "model name" and value.strip().lower() not in ("", "unknown"):
                    return value.strip()
    except OSError:
        pass
    if fields.get("Vendor ID"):
        return (f"{fields['Vendor ID']} family {fields.get('CPU family', '?')} "
                f"model {fields.get('Model', '?')} (no model name)")
    return "unknown"


def main(argv: list) -> int:
    if len(argv) not in (2, 3):
        print("usage: python -m stateright_tpu_torch._native.baseline "
              "(paxos CLIENTS | 2pc RMS | increment_lock N) [threads]", file=sys.stderr)
        return 2
    r = run_baseline(argv[0], int(argv[1]), int(argv[2]) if len(argv) == 3 else None)
    r["states_per_s"] = r["states"] / r["sec"]
    r["host_cpu"] = host_cpu()
    r["cpu_count"] = os.cpu_count()
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
