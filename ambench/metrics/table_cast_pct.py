"""Share of the traced slice's device busy time spent casting to int8 (the
search API hands the fused kernel an int8 copy of the int32 table, and of
the queries, on every call): PyTorch's copy kernels whose output is
``signed char``.  None where no such copy ran."""

CAST = ("direct_copy_kernel", "signed char")


def read(record):
    t = record["trace"]
    if t is None or t["busy_s"] <= 0.0:
        return None
    cast_s = sum(s for name, s in t["device_ops_s"].items()
                 if all(part in name for part in CAST))
    return 100.0 * cast_s / t["busy_s"] if cast_s > 0.0 else None
