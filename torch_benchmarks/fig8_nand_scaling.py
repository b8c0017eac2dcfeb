"""Fig. 8: 2FeFET-2T (NAND, precharge-free) search energy/latency scaling.

Port of ``benchmarks/fig8_nand_scaling.py``: the circuit model's energy
and latency, the behavioural array's batched search timed on ``--device``
(default the GPU), and the precharge-free accounting (a repeated search
charges no chain node).  Codes are drawn from numpy.

  PYTHONPATH=src python torch_benchmarks/fig8_nand_scaling.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch_benchmarks.common import emit  # noqa: E402
from torch_benchmarks.fig7_nor_scaling import timed_search  # noqa: E402
from repro_torch.core import cam_array, energy  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def run(device=None):
    dev = resolve_device(device)
    for rows in (16, 32, 64, 128, 256):
        e = energy.search_energy_array("nand", rows, 32, 3)
        lat = energy.search_latency("nand", 32)
        us = timed_search("nand", rows, dev)
        emit(f"fig8a_rows{rows}", us,
             f"energy_fj={e:.2f};latency_ps={lat:.1f}")

    for cells in (4, 8, 16, 32, 64):
        e = energy.search_energy_array("nand", 64, cells, 3)
        lat = energy.search_latency("nand", cells)
        emit(f"fig8b_cells{cells}", 0.0,
             f"energy_fj={e:.2f};latency_ps={lat:.1f};"
             f"e_per_bit_fj={energy.search_energy_per_bit('nand', cells, 3):.4f}")

    # precharge-free accounting: consecutive identical searches are free
    cfg = cam_array.SEEMCAMConfig(bits=3, n_cells=16, n_rows=8,
                                  variant="nand")
    arr = cam_array.SEEMCAMArray(cfg, device=dev)
    rng = np.random.default_rng(0)
    arr.program(rng.integers(0, 8, (8, 16)))
    q = rng.integers(0, 8, (16,))
    arr.search(q)
    t1 = arr.transition_count
    arr.search(q)
    emit("fig8_derived", 0.0,
         f"repeat_search_transitions={arr.transition_count - t1};"
         f"nand_vs_nor_energy_ratio="
         f"{energy.nand_search_energy_word(32, 3) / energy.nor_search_energy_word(32, 3):.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
