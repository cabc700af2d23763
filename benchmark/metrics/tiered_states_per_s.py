"""states_per_s of a tiered cell: the same count over the same clock."""


def read(run):
    return run.generated_per_s()
