"""Device time launched inside the program's offset regeneration, on the
send side (``lsh.dispatch.offsets``) and the receive side
(``lsh.scan.offsets``), as a share of the traced window, in %
(``portbench/spans.py``: each kernel, copy or fill goes to the innermost
span open when it was launched).  The card paces the batch job, so this
moves ``query_throughput.batch``.  Nothing where the program records no
spans or their attribution is not complete."""
from portbench import spans

SPANS = ("lsh.dispatch.offsets", "lsh.scan.offsets")


def read(tr):
    att = spans.attribution(tr)
    return None if att is None else att.device_pct(SPANS, tr.window_s)
