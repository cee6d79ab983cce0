"""The hash kernel's share of its roofline over the traced steps: the sum
of each launch's bound (``portbench/roofline.hash_bound``) over the sum
of the launches' device time.  Nothing is read where the recorded
launches and the profiled ones do not pair up."""
from portbench import roofline

KERNELS = ("lsh_hash_kernel",)


def read(tr):
    calls = tr.calls.get("lsh_hash", [])
    n, secs = tr.device_time(KERNELS)
    if not calls or n != len(calls) or secs <= 0:
        return None
    return 100.0 * sum(roofline.hash_bound(c) for c in calls) / secs
