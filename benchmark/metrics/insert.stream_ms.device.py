"""Stream ms a step of the plain insert inside the search (device
cell): the `step.insert` span's CUDA-event seconds over the probe check's
steps (program_layers)."""

from benchmark.program_layers import per_step_ms


def read(run):
    return per_step_ms(run, "step.insert", "stream_s")
