"""Share of the traced slice's device busy time in work that the program
launched inside its ``cam.expand.l1`` span (``repro_torch``'s
``core/am.py``, ``_expand_l1``: the thermometer expansion of the queries
and the table for the L1 distance), placed by ``ambench/spans.py``.  None
where the run was not traced or the program has no such span."""

from pathlib import Path

from ambench import spans

ROOT = Path(__file__).resolve().parents[2]
SPAN = "cam.expand.l1"


def read(record):
    s = spans.of_record(record, ROOT)
    if s is None or SPAN not in s["host"]:
        return None
    busy_s = sum(b - a for a, b in s["busy"]) * 1e-6
    if busy_s <= 0.0:
        return None
    return 100.0 * s["device_s"].get(SPAN, 0.0) / busy_s
