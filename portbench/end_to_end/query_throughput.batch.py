"""``query_throughput`` in the batch job's cells, which hold a bound of
their own: queries answered a second over the window."""
from portbench.window import queries_per_s


def read(w):
    return queries_per_s(w)
