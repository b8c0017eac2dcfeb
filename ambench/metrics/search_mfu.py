"""The whole search's share of the int8 peak over the traced slice: the
symbol compares that the lookups the service dispatched in the slice need
(each distinct lookup of a group once; flat: the live rows each; indexed:
the centroids plus the mean candidate rows each) over the slice's seconds
at the peak."""

from ambench.frozen import peaks


def read(record):
    if record["trace"] is None:
        return None
    cfg = record["config"]
    index = cfg.get("index")
    if index is None:
        rows = cfg["table"]["rows"]
    else:
        cand = record["reference"].get("candidate_rows_mean")
        if cand is None:
            return None
        rows = index["sets"] + cand
    c = record["counters"]
    ops = peaks.search_ops(c["dispatched"] - c["dedup_hits"], rows,
                           cfg["table"]["width"])
    return 100.0 * ops / (record["trace"]["window_s"] * peaks.PEAK_OPS_INT8)
