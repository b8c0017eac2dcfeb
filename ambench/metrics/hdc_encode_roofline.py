"""``hdc_encode``'s share of its roofline over the traced slice.

The bound is the benchmark's own arithmetic (``ambench/frozen/
hdc_peaks.py``), batch by batch: the larger of the 3xTF32 product's
3 x 2 x Q x n x D operations at the TF32 tensor-core peak and its least
bytes, (Q n + n D + Q D) x 4, at the HBM bandwidth.  Batches and their
lookups are those the system dispatched inside the slice, each batch taken
at the slice's mean size.  Time: the device time of ``hdc_encode_kernel``
in the slice's trace.  None where the run was not traced or ran no such
kernel.
"""

from ambench.frozen import hdc_peaks

KERNEL = "hdc_encode_kernel"


def read(record):
    trace = record["trace"]
    c = record["counters"]
    if trace is None or not c["groups"]:
        return None
    kernel_s = sum(s for name, s in trace["device_ops_s"].items()
                   if KERNEL in name)
    if kernel_s <= 0.0:
        return None
    t = record["config"]["table"]
    q = c["dispatched"] / c["groups"]
    bound_s = hdc_peaks.encode_bound_s(q, t["features"], t["dim"])
    return 100.0 * c["groups"] * bound_s / kernel_s
