"""The card's idle share of the traced window: 100 x (1 - the union of
the intervals in which a kernel, copy or fill ran / the window).  Idle
time is host time the card waits for: it moves ``query_throughput``."""


def read(tr):
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
