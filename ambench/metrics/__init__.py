"""One reader per metric of ``BENCHMARK.json``: ``<name>.py`` defines
``read(record) -> float | None``; ``None`` leaves the metric out."""
