"""The CSR gather kernel's share of its roofline over the traced steps:
the sum of each launch's bound (``portbench/roofline.gather_bound``) over
the sum of the launches' device time.  Nothing is read where the
recorded launches and the profiled ones do not pair up."""
from portbench import roofline

KERNELS = ("bucket_gather_kernel",)


def read(tr):
    calls = tr.calls.get("bucket_gather", [])
    n, secs = tr.device_time(KERNELS)
    if not calls or n != len(calls) or secs <= 0:
        return None
    return 100.0 * sum(roofline.gather_bound(c) for c in calls) / secs
