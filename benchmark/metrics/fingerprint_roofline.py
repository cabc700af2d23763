"""The fold's bytes (each successor lane read once, each key written once)
at the card's HBM rate, over fingerprint.ms."""

from benchmark.roofline import fold_bytes, roofline_pct


def read(run):
    p = run.probe
    if p is None:
        return None
    flat, _ = p.expanded
    nbytes = fold_bytes(flat.shape[0], flat.shape[1])
    return roofline_pct(nbytes, p.fingerprint_ms, run.peaks["hbm_bytes_per_s"])
