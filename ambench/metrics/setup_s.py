"""Set-up seconds: process start to the window's first timed lookup."""


def read(record):
    return record["setup_s"]
