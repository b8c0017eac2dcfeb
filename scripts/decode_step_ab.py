#!/usr/bin/env python3
"""Time the serving engine's decode step for one or more source trees.

    python3 scripts/decode_step_ab.py SRC [SRC ...]

Each ``SRC`` is a ``src`` directory holding ``repro_torch`` (this repo's
``src``, or that of an older commit unpacked with ``git archive``).  For
each, in its own process and in the order given, yi-6b at full width is
drawn on the GPU from seed 0 and a fresh one-slot ``Engine`` (``max_len``
32) is fed an 8-token prompt four times; the script prints the card's
name and power limit, then each tree's ms a decode step per repetition
(the first includes cuBLAS's first use).  Give the trees in turns (A B B
A) to compare two commits on one card.
"""

import subprocess
import sys
import time


def _time_tree(src: str) -> list[float]:
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine
    cfg = get_config("yi-6b")
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8))
    out = []
    for _ in range(4):
        eng = Engine.create(cfg, params, batch=1, max_len=32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill(prompt)                      # ends in a host copy
        out.append((time.perf_counter() - t0) * 1e3 / prompt.shape[1])
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(f"{argv[1]}: ms a decode step "
              f"{[round(x, 2) for x in _time_tree(argv[1])]}", flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for src in argv:
        subprocess.run([sys.executable, __file__, "--one", src], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
