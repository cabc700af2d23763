"""The device's idle share over the window's untraced steps (device-store
cell): 100 less the traced slice's device seconds per step over the
seconds per step of the engines' runs outside the slice
(profiling.Slice.idle_pct)."""


def read(run):
    return run.slice.idle_pct() if run.slice is not None else None
