"""Fine-stage ``cam_search_topk`` launches per dispatched group of an
indexed table over the traced slice (one per distinct probed set)."""


def read(record):
    c = record["counters"]
    if record["config"].get("index") is None or not c["groups"]:
        return None
    return c["launches"]["cam_search_topk"] / c["groups"]
