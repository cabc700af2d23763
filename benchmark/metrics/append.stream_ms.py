"""Stream ms a step of the queue append and the step's counters inside
the search: the `step.append` span's CUDA-event seconds over the probe
check's steps (program_layers)."""

from benchmark.program_layers import per_step_ms


def read(run):
    return per_step_ms(run, "step.append", "stream_s")
