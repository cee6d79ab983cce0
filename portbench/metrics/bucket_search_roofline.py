"""The full-scan bucket kernels' share of their roofline over the traced
steps (one launch of the wrapper runs its four kernels: live rows, probe
tables, the split scan, the merge): the sum of each launch's bound
(``portbench/roofline.scan_bound``) over the sum of the four kernels'
device time.  Nothing is read where the launches do not pair up."""
from portbench import roofline

KERNELS = ("live_rows_kernel", "probe_table_kernel", "bucket_scan_kernel",
           "bucket_search_merge_kernel")


def read(tr):
    calls = tr.calls.get("bucket_search", [])
    n, _ = tr.device_time(KERNELS[:1])
    _, secs = tr.device_time(KERNELS)
    if not calls or n != len(calls) or secs <= 0:
        return None
    return 100.0 * sum(roofline.scan_bound(c) for c in calls) / secs
