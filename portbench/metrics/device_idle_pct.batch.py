"""``device_idle_pct``, read the same way in the batch job's cells,
where a call of the index is the batch and it moves
``query_throughput.batch``."""
from portbench.metrics.device_idle_pct import read  # noqa: F401
