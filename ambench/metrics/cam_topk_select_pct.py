"""Share of the fused top-k partial pass's cycles spent outside the tile
compare: the distance store, the two barriers, the vote and the inserts of
each 128-row tile, over those and the compare.  Read from the kernel's own
counters (``repro_torch.obs``: ``cam_topk.cycles_select`` and
``cam_topk.cycles_compare``), which count only while the profiler records,
so over the traced slice.  None untraced, or where nothing was counted."""

from ambench import spans


def read(record):
    if record["trace"] is None:
        return None
    c = spans.counters()
    if c is None:
        return None
    total = c["cam_topk.cycles_compare"] + c["cam_topk.cycles_select"]
    return 100.0 * c["cam_topk.cycles_select"] / total if total else None
