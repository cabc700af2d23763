"""Process start to the window's first instant: the torch import, the CUDA
context, the insert kernel's build or load, the engine's buffers and the
warm chunks."""


def read(run):
    return run.setup_s
