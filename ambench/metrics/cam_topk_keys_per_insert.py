"""Keys the fused top-k partial pass offered to its lists per vote that
called ``insert_rows``: how many single inserts one merge of a tile's
candidates stands for (above k = 32, where a vote's keys go into the list
in one merge).  Read from the kernel's own counters (``repro_torch.obs``:
``cam_topk.offered`` over ``cam_topk.inserts``), which count only while
the profiler records, so over the traced slice.  None untraced, where
nothing was inserted, or for a program without the ``offered`` counter."""

from ambench import spans


def read(record):
    if record["trace"] is None:
        return None
    c = spans.counters()
    if c is None or not c.get("cam_topk.inserts") \
            or "cam_topk.offered" not in c:
        return None
    return c["cam_topk.offered"] / c["cam_topk.inserts"]
