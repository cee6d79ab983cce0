"""The dispatch exchange's live share over the traced window, in %: the
routed rows the send side shipped (``lsh.dispatch.rows_live``, the sum
of the fetched ``fq``) over the slots its exchange moves
(``lsh.dispatch.rows_shipped``, S x S x the query capacity).  The
paper's network cost against what the exchange pays for it; padding is
device time in the send buffer's build and transpose, so it moves
``query_throughput.batch``.  Nothing where the program counts no rows or
dropped a record of the window."""
from portbench import spans


def read(tr):
    return spans.ratio_pct(tr, "lsh.dispatch.rows_live",
                           "lsh.dispatch.rows_shipped")
