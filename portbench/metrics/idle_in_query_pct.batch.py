"""The card's idle time while the program is inside its query path (any
``lsh.*`` span: the upload, the three stages, the fetch), as a share of
the traced window, in % (``portbench/spans.py``).  With
``device_idle_pct.batch`` it splits the window's idle time into the
program's share and the harness's between calls; idle inside a call
lengthens that call, so it moves ``query_p95_ms.batch``.  Nothing where
the program records no spans or their attribution is not complete."""
from portbench import spans


def read(tr):
    att = spans.attribution(tr)
    if att is None or not att.complete or tr.window_s <= 0:
        return None
    us = sum(v for k, v in att.idle_us.items() if k.startswith("lsh."))
    return 100.0 * us * 1e-6 / tr.window_s
