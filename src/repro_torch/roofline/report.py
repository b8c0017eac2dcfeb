"""Aggregate the dry-run's JSON records into the roofline tables.

Port of :mod:`repro.roofline.report`, reading the records that
:mod:`repro_torch.launch.dryrun` writes under
``torch_benchmarks/results/dryrun/``.  Given the same records, its table
is the reference's text.

  PYTHONPATH=src python -m repro_torch.roofline.report [--mesh pod16x16]
"""

from __future__ import annotations

import argparse
import json
import pathlib

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "torch_benchmarks" / \
    "results" / "dryrun"

ARCH_ORDER = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "granite-20b",
              "minitron-4b", "yi-6b", "internlm2-20b", "recurrentgemma-2b",
              "musicgen-medium", "xlstm-125m", "pixtral-12b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str) -> list[dict]:
    out = []
    for p in sorted(RESULTS.glob(f"*_{mesh}.json")):
        out.append(json.loads(p.read_text()))
    out.sort(key=lambda r: (ARCH_ORDER.index(r["arch"])
                            if r["arch"] in ARCH_ORDER else 99,
                            SHAPE_ORDER.index(r["shape"])))
    return out


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def table(mesh: str) -> str:
    rows = [
        "| arch | shape | status | t_comp (s) | t_mem (s) | t_coll (s) | "
        "bottleneck | useful/HLO | MFU_bound | mem/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load(mesh):
        if r["status"] != "ok":
            reason = "skip: quadratic attn @524k" if r["status"] == "skipped" \
                else r.get("reason", "")[:40]
            rows.append(f"| {r['arch']} | {r['shape']} | {r['status']} "
                        f"| - | - | - | - | - | - | {reason} |")
            continue
        rl = r["roofline"]
        mem = r["memory"]["total_bytes"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {rl['t_compute_s']:.4f} | {rl['t_memory_s']:.4f} "
            f"| {rl['t_collective_s']:.4f} | **{rl['bottleneck']}** "
            f"| {rl['useful_flop_ratio']:.2f} | {rl['mfu_bound']:.3f} "
            f"| {fmt_bytes(mem)} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None,
                    choices=["pod16x16", "pod2x16x16", None])
    args = ap.parse_args(argv)
    for mesh in [args.mesh] if args.mesh else ["pod16x16", "pod2x16x16"]:
        print(f"\n### Mesh {mesh}\n")
        print(table(mesh))


if __name__ == "__main__":
    main()
