"""The fused Bloom insert's bytes at the tiered step's shape (hot tier at
high water, the older states in the summary), at the card's HBM rate, over
the call's device time."""

from benchmark.roofline import insert_fused_bytes, roofline_pct


def read(run):
    p = run.probe
    if p is None:
        return None
    ins = p.insert_fused
    nbytes = insert_fused_bytes(p.lanes, p.n_active, ins["n_new"], ins["hashes"])
    return roofline_pct(nbytes, ins["device_ms"], run.peaks["hbm_bytes_per_s"])
