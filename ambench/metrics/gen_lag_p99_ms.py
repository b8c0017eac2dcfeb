"""99th percentile of how late the open loop sent each lookup against its
schedule, over the lookups of a traced run that the profiler left alone
(due from ``SETTLE_S`` after the traced slice closed to the window's
end)."""

import statistics


def read(record):
    lag = record.get("gen_lag_s")
    a = record.get("after_slice")
    if lag is None or a is None or lag.size - a < 100:
        return None
    return statistics.quantiles(lag[a:], n=100)[98] * 1e3
