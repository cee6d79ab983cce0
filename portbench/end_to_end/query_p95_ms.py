"""The 95th percentile, over every query batch the window sent, of the
time from its submission to its answers on the host (ms)."""
from portbench.window import p95_ms


def read(w):
    return p95_ms([r for r in w.recs if r.kind == "query"])
