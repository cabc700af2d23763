"""Device ms of the queue append of that step's outputs."""


def read(run):
    return run.probe.append_ms if run.probe is not None else None
