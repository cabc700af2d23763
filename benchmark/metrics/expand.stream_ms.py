"""Stream ms a step of the expand and boundary inside the search: the
`step.expand` span's CUDA-event seconds over the probe check's steps
(program_layers)."""

from benchmark.program_layers import per_step_ms


def read(run):
    return per_step_ms(run, "step.expand", "stream_s")
