"""Host ms issuing one step (tiered cell): the `step.*` spans' self
seconds over the probe check's steps (program_layers)."""

from benchmark.program_layers import issue_ms


def read(run):
    return issue_ms(run)
