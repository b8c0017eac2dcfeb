"""The benchmark of ``repro_torch``: cells of configuration x traffic on one card.

``python3 ambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints its result as the last
line of standard output.  Configurations (``configs/``), traffic mixes
(``traffic/``), metric readers (``metrics/``), systems under test
(``systems/``) and plain references (``references/``) are found by the names
``BENCHMARK.json`` and the configuration files give them, so a new cell,
mix or metric is new files and entries, not an edit.  ``frozen/`` holds the
yardstick's copies of program arithmetic; nothing here imports ``jax`` or
``repro``, and the references import nothing of ``repro_torch``.
"""
