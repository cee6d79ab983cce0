"""Device time launched inside the program's exchanges (``lsh.exchange``:
a send buffer's build, its scatter and the ``AllToAll`` block transpose,
for the dispatch and the return), as a share of the traced window, in %
(``portbench/spans.py``).  The card paces the batch job, so this moves
``query_throughput.batch``.  Nothing where the program records no
spans or their attribution is not complete."""
from portbench import spans

SPANS = ("lsh.exchange",)


def read(tr):
    att = spans.attribution(tr)
    return None if att is None else att.device_pct(SPANS, tr.window_s)
