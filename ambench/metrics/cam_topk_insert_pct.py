"""Share of the fused top-k partial pass's per-query tile votes that
passed, so that the warp offered the tile's rows to the query's list
(``insert_rows``).  Read from the kernel's own counters
(``repro_torch.obs``: ``cam_topk.inserts`` over ``cam_topk.votes``), which
count only while the profiler records, so over the traced slice.  None
untraced, or where nothing was counted."""

from ambench import spans


def read(record):
    if record["trace"] is None:
        return None
    c = spans.counters()
    if c is None or not c["cam_topk.votes"]:
        return None
    return 100.0 * c["cam_topk.inserts"] / c["cam_topk.votes"]
