"""Queries answered a second over the window (queries/s): every query
the window sent and got answered, over the time from the window's start
to its last answer."""
from portbench.window import queries_per_s


def read(w):
    return queries_per_s(w)
