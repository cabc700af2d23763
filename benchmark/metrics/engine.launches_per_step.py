"""Device operations (kernels, copies, fills) over the traced slice, per
engine step; the slice holds whole chunks of steps."""


def read(run):
    s = run.slice
    return s.device_ops / s.steps if s is not None and s.steps else None
