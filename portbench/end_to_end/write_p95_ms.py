"""The 95th percentile, over every write (one insert or one delete call)
the window sent, of the time from its submission to its acknowledgement
(ms)."""
from portbench.window import p95_ms


def read(w):
    return p95_ms([r for r in w.recs if r.kind in ("insert", "delete")])
