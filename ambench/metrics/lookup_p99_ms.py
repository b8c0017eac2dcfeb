"""99th percentile of an open loop's lookups, each timed from when it was
due to when the client saw its answer (None elsewhere): what an independent
user of an AM response cache waits, over every lookup of the window, or in
a traced run over those the profiler left alone (due from ``SETTLE_S``
after the traced slice closed to the window's end)."""

import statistics


def read(record):
    lat = record.get("latency_s")
    a = record.get("after_slice")
    if lat is None or a is None or lat.size - a < 100:
        return None
    return statistics.quantiles(lat[a:], n=100)[98] * 1e3
