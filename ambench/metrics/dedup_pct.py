"""Share of the traced slice's dispatched lookups that the service answered
from another lookup's row in the same group (``dedup_hits``)."""


def read(record):
    c = record["counters"]
    return 100.0 * c["dedup_hits"] / c["dispatched"] if c["dispatched"] else None
