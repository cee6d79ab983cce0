"""``host_syncs_per_batch``, read the same way in the batch job's
cells, where a call of the index is the batch and it moves
``query_p95_ms.batch``."""
from portbench.metrics.host_syncs_per_batch import read  # noqa: F401
