"""Share of the traced slice in which the card ran nothing while a thread
was inside the program's ``am.search`` span: the search API's own host path
holding the card, as against the client's.  Read from the slice's trace by
``ambench/spans.py``; None where the run was not traced, the program has no
such span, or no device work ran."""

from pathlib import Path

from ambench import spans

ROOT = Path(__file__).resolve().parents[2]
SPAN = "am.search"


def read(record):
    s = spans.of_record(record, ROOT)
    if s is None or SPAN not in s["host"] or not s["busy"]:
        return None
    return 100.0 * spans.overlap_s(s["gaps"], s["host"][SPAN]) / s["window_s"]
