"""Share of the traced slice in which no kernel, copy or fill ran on the
card (open-loop cells)."""


def read(record):
    t = record["trace"]
    if t is None or t["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
