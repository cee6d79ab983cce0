"""Kernel launches a query batch: the kernels torch.profiler saw run on
the card in the traced steps (copies and fills left out), over the query
batches traced.  Each launch costs the engine thread host time, which
paces the card: it moves ``query_throughput``."""


def read(tr):
    if not tr.batches:
        return None
    return len(tr.kernels()) / tr.batches
