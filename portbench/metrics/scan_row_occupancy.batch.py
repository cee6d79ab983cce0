"""The receive side's live share over the traced window, in %: the routed
rows each shard keeps (``lsh.scan.rows_live``) over the rows whose
offsets it regenerates and scans (``lsh.scan.rows_processed``, S x the
busiest shard's count: every shard is padded to it).  Padding is device
time in the offsets, hash and scan, so it moves
``query_throughput.batch``.  Nothing where the program counts no rows or
dropped a record of the window."""
from portbench import spans


def read(tr):
    return spans.ratio_pct(tr, "lsh.scan.rows_live",
                           "lsh.scan.rows_processed")
