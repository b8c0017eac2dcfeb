"""Peak device memory allocated by the program over set-up and window
(``torch.cuda.max_memory_allocated``, reset once the benchmark's own inputs
were made), in GiB."""


def read(record):
    return record["peak_bytes"] / 2 ** 30 if record["peak_bytes"] else None
