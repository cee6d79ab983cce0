"""``query_p95_ms`` in the batch job's cells, which hold a bound of
their own: the 95th percentile of a call's time to its answers (ms)."""
from portbench.window import p95_ms


def read(w):
    return p95_ms([r for r in w.recs if r.kind == "query"])
