"""States generated per second over the window: every state the window's
checks generated (the cut check's up to its last chunk) over the window's
host-clock seconds."""


def read(run):
    return run.generated_per_s()
