"""Host syncs a query batch: every synchronizing CUDA call the program
made in the traced steps (``repro_torch.analysis.device_pass.SyncLog``,
torch's sync-debug "warn" mode), over the query batches traced.  A sync
stalls the engine thread until the card drains, so it lengthens each
batch's wait: it moves ``query_p95_ms``."""


def read(tr):
    if not tr.batches:
        return None
    return tr.syncs / tr.batches
