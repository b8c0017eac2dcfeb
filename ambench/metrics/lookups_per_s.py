"""Lookups answered inside the window over the window's seconds."""


def read(record):
    return record["completed"] / record["window_s"]
