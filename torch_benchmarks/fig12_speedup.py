"""Fig. 12: speedup / energy-efficiency of SEE-MCAM HDC inference vs GPU.

Port of ``benchmarks/fig12_speedup.py``.  Three sides, each labelled:
  * CAM side  — the calibrated array model: one parallel associative search
    of K class words of D cells takes max(bank latency) and E/bit * bits;
  * GPU proxy — the reference's analytic GTX 1080 Ti model at the paper's
    operating point (11.3 TFLOP/s peak fp32, 30% matmul efficiency, 180 W
    board power), kept unchanged: it is the paper's comparison;
  * measured — the same top-1 search through the port's ``am.search`` on
    ``--device`` (default the GPU, where it runs the fused CAM kernel), at
    batch 1 and at the proxy's batch, in ns per query, and the CAM model's
    speedup over that time.  On a GPU the energy per query is given only
    as an upper bound, time x the board's power limit read from
    ``nvidia-smi`` (the card draws at most that), with the card's name and
    limit beside it; so the CAM's energy efficiency over the card is an
    upper bound as well.
Derived: speedup_x / energy_eff_x — the paper reports up to 3 orders of
magnitude for both against its GPU.  The first row per shape keeps the
reference's fields (``host_measured_ns_per_q`` is the measured search at
the proxy's batch, where this script runs); the second holds the measured
side.

``--smoke`` runs one tiny shape with minimal timing iterations.

  PYTHONPATH=src python torch_benchmarks/fig12_speedup.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch_benchmarks.common import emit, time_call  # noqa: E402
from repro_torch.core import am, energy  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

GPU_PEAK_FLOPS = 11.3e12
GPU_EFF = 0.30
GPU_POWER_W = 180.0
GPU_DISPATCH_S = 10e-6         # per-op launch/dispatch floor (Aten profiler)
CAM_BANK_CELLS = 64            # cells per physical word; wide words are banked


def cam_search_cost(n_rows: int, d_cells: int, bits: int):
    """(latency_s, energy_J) of one query over the full class array."""
    # banks searched in parallel; digital mismatch-count merge adds ~1 cycle
    lat_ps = energy.search_latency("nor", min(d_cells, CAM_BANK_CELLS)) + 100.0
    e_fj = energy.search_energy_array("nor", n_rows, d_cells, bits) * bits
    return lat_ps * 1e-12, e_fj * 1e-15


def gpu_cost(n_rows: int, d_cells: int, batch: int):
    """Analytic GPU exact-match proxy: int compare+popcount as 2*K*D ops,
    plus the per-dispatch launch floor the paper's Aten profiling includes."""
    flops = 2.0 * n_rows * d_cells * batch
    t = flops / (GPU_PEAK_FLOPS * GPU_EFF)
    # memory floor: stream K*D codes + batch*D queries at 480 GB/s
    t = max(t, (n_rows * d_cells + batch * d_cells) / 480e9)
    t = t + GPU_DISPATCH_S
    return t, t * GPU_POWER_W


def card_info():
    """(name, power limit in W) of GPU 0 as ``nvidia-smi`` reads them, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), float(limit.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def make_case(k_classes: int, d: int, batch: int, seed: int = 0):
    """(K, D) class codes and (batch, D) queries, 3-bit, from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 8, (k_classes, d), dtype=np.int32),
            rng.integers(0, 8, (batch, d), dtype=np.int32))


def top1(table, queries):
    """The measured search: top-1 over the class table, CAM kernel backend."""
    return am.search(table, queries, k=1, backend="cuda")


def run(smoke: bool = False, device=None) -> list[dict]:
    """Emit the CSV rows; return each shape's numbers (``searches`` is the
    count of ``am.search`` calls the shape made)."""
    dev = resolve_device(device)
    shapes = ((5, 128),) if smoke else ((26, 1024), (26, 4096), (12, 1024),
                                        (5, 1024))
    batch = 8 if smoke else 1024
    iters = 2 if smoke else 5
    card = card_info() if dev.type == "cuda" else None
    out = []
    for k_classes, d in shapes:
        t_cam, e_cam = cam_search_cost(k_classes, d, 3)
        # online single-query regime (the AM lookup inside an inference loop)
        t_g1, e_g1 = gpu_cost(k_classes, d, batch=1)
        # large-batch amortized regime
        t_gb, e_gb = gpu_cost(k_classes, d, batch)
        t_gb, e_gb = t_gb / batch, e_gb / batch
        # measured: the functional top-1 search, at the batch and at 1
        codes, queries = make_case(k_classes, d, batch)
        table = am.make_table(codes, bits=3, device=dev)
        qb = torch.from_numpy(queries).to(dev)
        us_b = time_call(top1, table, qb, iters=iters) / batch
        us_1 = time_call(top1, table, qb[:1], iters=iters)
        emit(f"fig12_K{k_classes}_D{d}", us_b,
             f"cam_ns={t_cam * 1e9:.2f};"
             f"speedup_single_x={t_g1 / t_cam:.0f};"
             f"speedup_batched_x={t_gb / t_cam:.0f};"
             f"energy_eff_single_x={e_g1 / e_cam:.0f};"
             f"energy_eff_batched_x={e_gb / e_cam:.0f};"
             f"host_measured_ns_per_q={us_b * 1e3:.0f}")
        row = {"k_classes": k_classes, "d": d, "batch": batch,
               "cam_ns": t_cam * 1e9, "ns_per_q_b1": us_1 * 1e3,
               "ns_per_q_batched": us_b * 1e3,
               "speedup_vs_measured_b1_x": us_1 * 1e-6 / t_cam,
               "speedup_vs_measured_batched_x": us_b * 1e-6 / t_cam,
               "searches": 2 * (1 + iters)}
        derived = (f"device={dev.type};ns_per_q_b1={row['ns_per_q_b1']:.1f};"
                   f"ns_per_q_b{batch}={row['ns_per_q_batched']:.2f};"
                   f"speedup_vs_measured_b1_x="
                   f"{row['speedup_vs_measured_b1_x']:.0f};"
                   f"speedup_vs_measured_batched_x="
                   f"{row['speedup_vs_measured_batched_x']:.0f}")
        if card is not None:
            name, limit_w = card
            for tag, us in (("b1", us_1), ("batched", us_b)):
                ub_j = us * 1e-6 * limit_w
                row[f"energy_ub_nj_per_q_{tag}"] = ub_j * 1e9
                row[f"energy_eff_vs_measured_ub_{tag}_x"] = ub_j / e_cam
            row.update(card=name, power_limit_w=limit_w)
            derived += (f";card={name};power_limit_w={limit_w:.2f};"
                        f"energy_ub_nj_per_q_b1="
                        f"{row['energy_ub_nj_per_q_b1']:.1f};"
                        f"energy_ub_nj_per_q_b{batch}="
                        f"{row['energy_ub_nj_per_q_batched']:.3f};"
                        f"energy_eff_vs_measured_ub_b1_x="
                        f"{row['energy_eff_vs_measured_ub_b1_x']:.0f};"
                        f"energy_eff_vs_measured_ub_batched_x="
                        f"{row['energy_eff_vs_measured_ub_batched_x']:.0f}")
        emit(f"fig12_K{k_classes}_D{d}_measured", us_1, derived)
        out.append(row)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes + minimal iterations (CI guard)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
