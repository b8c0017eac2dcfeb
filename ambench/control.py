"""The control of a cell's check: the reference one precision step down.

    python3 ambench/control.py --workload am_flat_1m.bulk_k10 --seeds 1,2,3

For each seed it makes the run's inputs and draws as many keys as a run
checks from the cell's own key distribution, then answers them with the
configuration's reference at one bit a symbol fewer (3-bit cells compared
as 2-bit ones: the same table, the top two bits of each symbol) and holds
those answers to the full reference as a run's are.  Prints one JSON line a
seed with the mismatched count; a sound control reads far above the limit
of 0.  No measured window: the answers do not depend on timing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ambench import registry, run, traffic  # noqa: E402


def reading(name: str, seed: int, device, *, root: Path = ROOT,
            config_over=None, mix_over=None) -> dict:
    """The control's mismatched count for one seed of cell ``name``."""
    bench = registry.benchmark(root)
    cell = registry.cell(bench, name)
    cfg = run._update(registry.config(bench, cell["config"], root),
                      config_over)
    mix = run._update(registry.traffic(cell["traffic"], root), mix_over)
    seeds = traffic.seeds(seed)
    systems = registry.module("systems", cfg["system"], root)
    reference = registry.module("references", cfg["reference"], root)
    inputs = systems.make_inputs(cfg, mix, seeds["rows"], device)
    keys = traffic.Keys(mix, inputs.words.shape[0], seeds["keys"],
                        seeds["order"]).draw(run.CHECK_LOOKUPS)
    low = reference.expected(inputs.stored, inputs.words[keys], cfg,
                             mix["k"], device, bits=cfg["table"]["bits"] - 1)
    items = list(zip(keys.tolist(), reference.answers(low)))
    checked = reference.check(inputs, cfg, mix, items, device)
    return {"cell": name, "seed": seed, "checked": len(items),
            "control_mismatched": checked["mismatched"], "limit": 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ambench.control: no CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        row = reading(args.workload, int(s), torch.device("cuda", 0))
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
