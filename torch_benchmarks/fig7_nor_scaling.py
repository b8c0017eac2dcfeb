"""Fig. 7: 2FeFET-1T (NOR) SEE-MCAM search energy/latency vs rows & cells.

Port of ``benchmarks/fig7_nor_scaling.py``.  Energy and latency come from
the calibrated circuit model (:mod:`repro_torch.core.energy`), the same
numbers as the reference's; the timed call is the behavioural array's
batched search on ``--device`` (default the GPU), with codes drawn from
numpy where the reference draws from a JAX key.

  PYTHONPATH=src python torch_benchmarks/fig7_nor_scaling.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch_benchmarks.common import emit, time_call  # noqa: E402
from repro_torch.core import cam_array, energy  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def timed_search(variant: str, rows: int, device) -> float:
    """Median us of one 16-query ``search_batch`` over a programmed
    ``rows`` x 32-cell, 3-bit array (the functional device model)."""
    cfg = cam_array.SEEMCAMConfig(bits=3, n_cells=32, n_rows=rows,
                                  variant=variant)
    arr = cam_array.SEEMCAMArray(cfg, device=device)
    rng = np.random.default_rng(rows)
    arr.program(rng.integers(0, 8, (rows, 32)))
    q = rng.integers(0, 8, (16, 32))
    return time_call(lambda qq: arr.search_batch(qq)[1], q)


def run(device=None):
    dev = resolve_device(device)
    # (a) energy/latency vs number of rows at 32 cells/word, 3 bits
    for rows in (16, 32, 64, 128, 256):
        e = energy.search_energy_array("nor", rows, 32, 3)
        lat = energy.search_latency("nor", 32)
        us = timed_search("nor", rows, dev)
        emit(f"fig7a_rows{rows}", us,
             f"energy_fj={e:.2f};latency_ps={lat:.1f}")

    # (b) vs cells per row at 64 rows
    for cells in (4, 8, 16, 32, 64):
        e = energy.search_energy_array("nor", 64, cells, 3)
        lat = energy.search_latency("nor", cells)
        emit(f"fig7b_cells{cells}", 0.0,
             f"energy_fj={e:.2f};latency_ps={lat:.1f};"
             f"e_per_bit_fj={energy.search_energy_per_bit('nor', cells, 3):.4f}")

    # derived claims: linear-in-rows energy; latency grows with cells
    e64 = energy.search_energy_array("nor", 64, 32, 3)
    e128 = energy.search_energy_array("nor", 128, 32, 3)
    emit("fig7_derived", 0.0,
         f"rows_linearity={e128 / e64:.3f};"
         f"lat_32c_over_8c={energy.search_latency('nor', 32) / energy.search_latency('nor', 8):.2f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
