"""The closed window an end-to-end reader (``end_to_end/<metric>.py``)
reads, and the arithmetic the readers share.  Each reader's ``read(w)``
takes a ``Window`` and returns its number, or None where the window
holds nothing to read."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Window:
    recs: list        # every request admitted, with host send/done times
    t_start: float    # the window's start on the same clock
    setup_s: float    # the process's start to the window's start


def p95_ms(recs):
    """The 95th percentile of send-to-completion times, in ms, over every
    request given; None for none."""
    if not recs:
        return None
    return float(np.percentile(
        np.asarray([(r.t_done - r.t_sent) * 1e3 for r in recs], np.float64),
        95))


def queries_per_s(w):
    """Every query the window sent and got answered over the time from
    the window's start to its last answer: all the window's work and all
    its time, with no step that lands on either side of the window's
    end."""
    if not w.recs:
        return None
    t_last = max(r.t_done for r in w.recs)
    done = sum(r.n for r in w.recs if r.kind == "query" and r.error is None)
    return done / (t_last - w.t_start)
