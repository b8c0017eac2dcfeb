"""``cam_search_topk``'s share of its roofline over the traced slice.

The bound is the benchmark's own arithmetic, group by group: the larger of
the group's symbol compares at the int8 peak and the least bytes it reads
(the rows it scans and its queries, each symbol at the table's bits) at
the HBM bandwidth.  Groups and their unique lookups are those the service
dispatched inside the slice (its ``readbacks``, ``dispatched`` and
``dedup_hits``), each group taken at the slice's mean size; the max is
convex, so that bound is at most the sum over the real sizes.  Rows
scanned: the live rows of a flat table, or the mean candidate rows of the
reference's probed sets behind the index (bytes: one lookup's candidates,
the least a group reads).  Time: the device time of the kernels the
launch runs (``cam_topk_*``) in the slice's trace.
"""

from ambench.frozen import peaks

KERNELS = "cam_topk_"


def rows_scanned(record):
    """Rows one lookup's top-k scans, or None if unknown."""
    if record["config"].get("index") is None:
        return record["config"]["table"]["rows"]
    return record["reference"].get("candidate_rows_mean")


def unique_lookups(record):
    """(groups, lookups compared) the service dispatched in the slice."""
    c = record["counters"]
    return c["groups"], c["dispatched"] - c["dedup_hits"]


def read(record):
    trace = record["trace"]
    rows = rows_scanned(record)
    groups, lookups = unique_lookups(record)
    if trace is None or rows is None or not groups:
        return None
    kernel_s = sum(s for name, s in trace["device_ops_s"].items()
                   if KERNELS in name)
    if kernel_s <= 0.0:
        return None
    t = record["config"]["table"]
    q = lookups / groups
    group_s = peaks.bound_s(peaks.search_ops(q, rows, t["width"]),
                            peaks.search_bytes(q, rows, t["width"],
                                               t["bits"]))
    return 100.0 * groups * group_s / kernel_s
