"""The share of the window outside the engines' own run() durations: each
check's engine build, thread start and join, and its discoveries' paths. In
a traced run both leave out the time the profiler's start and stop held
the engine."""


def read(run):
    if not run.checks:
        return None
    stall = run.window_s - run.traced_window_s()
    engine = sum(c.engine_s for c in run.checks) - stall
    return 100.0 * (1.0 - engine / run.traced_window_s())
