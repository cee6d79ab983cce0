"""``launches_per_batch``, read the same way in the batch job's cells,
where a call of the index is the batch and it moves
``query_throughput.batch``."""
from portbench.metrics.launches_per_batch import read  # noqa: F401
