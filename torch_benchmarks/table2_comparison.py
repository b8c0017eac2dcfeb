"""Table II: CAM design comparison — our calibrated model vs published rows.

Port of ``benchmarks/table2_comparison.py``: arithmetic of the circuit
model (:mod:`repro_torch.core.energy`), no device work, so it takes no
``--device``.

  PYTHONPATH=src python torch_benchmarks/table2_comparison.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch_benchmarks.common import emit  # noqa: E402
from repro_torch.core import energy  # noqa: E402


def run(device=None):
    """Emit Table II; ``device`` is accepted for the harness and unused."""
    s = energy.model_summary(n_cells=32, bits=3)
    for variant, pub in (("nor", energy.THIS_WORK_NOR),
                         ("nand", energy.THIS_WORK_NAND)):
        m = s[variant]
        emit(f"table2_thiswork_{variant}", 0.0,
             f"energy_fj_bit={m['energy_fj_per_bit']:.4f}"
             f"(pub={pub.energy_fj_per_bit});"
             f"latency_ps={m['latency_ps']:.1f}(pub={pub.latency_ps});"
             f"area_um2_bit={m['area_um2_per_bit']:.3f}"
             f"(pub={pub.area_um2_per_bit})")

    ratios = energy.energy_ratios()
    for d in energy.TABLE_II:
        emit(f"table2_{d.name.split(' ')[0]}", 0.0,
             f"energy_fj_bit={d.energy_fj_per_bit};"
             f"our_energy_ratio_x={ratios[d.name]:.2f}")

    # headline claims
    emit("table2_claims", 0.0,
         f"vs_cmos_energy_x={ratios['16T CMOS [8]']:.1f}(paper=9.8);"
         f"vs_reram_x={ratios[chr(78) + chr(67) + chr(39) + '20 [15]']:.1f}(paper=8.7);"
         f"vs_fefet_mcam_x={ratios[chr(73) + 'EDM' + chr(39) + '20 [18]']:.1f}(paper=4.9);"
         f"latency_vs_cmos_x={582.4 / energy.search_latency('nor', 32):.2f}(paper=1.6);"
         f"area_vs_cmos_pct="
         f"{100 * energy.area_per_bit('nor', 3) / 1.12:.1f}(paper~8-11)")


if __name__ == "__main__":
    run()
