"""The tiered store's service (the engine's service_seconds["service"],
summed over the window's checks) as a share of the window, less
the time the profiler's start and stop held the engine in a traced run."""


def read(run):
    s = sum(c.service_seconds.get("service", 0.0) for c in run.checks)
    return 100.0 * s / run.traced_window_s() if run.checks else None
