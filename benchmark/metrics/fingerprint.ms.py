"""Device ms of the fingerprint fold of that batch's successor rows."""


def read(run):
    return run.probe.fingerprint_ms if run.probe is not None else None
