"""Lookups per dispatched group over the traced slice: the service's
``dispatched`` over its ``readbacks`` (one readback a group)."""


def read(record):
    c = record["counters"]
    return c["dispatched"] / c["groups"] if c["groups"] else None
