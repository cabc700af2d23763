"""Shared CLI plumbing for the example commands of `__main__.py` — the
port's copy of the root `examples/_cli.py`. The reference's examples are
pico_args subcommand CLIs; these keep that shape, one example name ahead:
`python -m stateright_tpu_torch.examples 2pc check 3`.

The device subcommands (`check-cuda`, `check-cuda-sym`, raft's `check` and
`simulate`) run on the CUDA card. `--device cpu` anywhere on the line is the
only way to the CPU (the counterpart of the JAX CLIs' `JAX_PLATFORMS`); with
no flag and no card they raise. Host subcommands never import torch.
"""

from __future__ import annotations

import os
from typing import Optional

from ..actor import Network
from ..core.report import WriteReporter

PROG = "python -m stateright_tpu_torch.examples"


class CliArgs:
    """The words after the example's name, positioned like the root scripts'
    `sys.argv` (1 is the subcommand), with `--device` taken out."""

    def __init__(self, example: str, words: list):
        words = list(words)
        self.device_flag: Optional[str] = None
        if "--device" in words:
            i = words.index("--device")
            if i + 1 >= len(words):
                raise SystemExit("--device needs a value: cpu or cuda")
            self.device_flag = words[i + 1]
            del words[i:i + 2]
        self.argv = [example] + words

    def subcommand(self) -> Optional[str]:
        return self.argv[1] if len(self.argv) > 1 else None

    def int(self, pos: int, default: int) -> int:
        try:
            return int(self.argv[pos])
        except (IndexError, ValueError):
            return default

    def str(self, pos: int, default: str) -> str:
        try:
            return self.argv[pos]
        except IndexError:
            return default

    def network(self, pos: int, default: str = "unordered_nonduplicating") -> Network:
        try:
            return Network.from_str(self.argv[pos])
        except IndexError:
            return Network.from_str(default)

    def device(self) -> str:
        """The torch device of a device subcommand: the card unless
        `--device cpu` was given; raises when the card is asked for and
        there is none."""
        import torch

        device = self.device_flag or "cuda"
        if device not in ("cpu", "cuda"):
            raise ValueError(f"--device must be cpu or cuda, got {device!r}")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the device subcommands run on the card; "
                "pass --device cpu to run them on the CPU"
            )
        return device


def report(checker) -> None:
    checker.report(WriteReporter())


def thread_count() -> int:
    return os.cpu_count() or 1


def network_names() -> str:
    return " | ".join(Network.names())


def usage(example: str, lines: list) -> None:
    print("USAGE:")
    for line in lines:
        print(f"  {PROG} {example} {line}")
