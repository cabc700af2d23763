"""The plain insert's bytes for that step's successors into the mid-search
table, at the card's HBM rate, over the call's device time."""

from benchmark.roofline import insert_bytes, roofline_pct


def read(run):
    p = run.probe
    if p is None:
        return None
    ins = p.insert
    nbytes = insert_bytes(p.lanes, p.n_active, ins["n_new"])
    return roofline_pct(nbytes, ins["device_ms"], run.peaks["hbm_bytes_per_s"])
