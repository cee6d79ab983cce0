"""``lsh_hash_roofline``, read the same way in the batch job's cells,
where a call of the index is the batch and it moves
``query_throughput.batch``."""
from portbench.metrics.lsh_hash_roofline import read  # noqa: F401
