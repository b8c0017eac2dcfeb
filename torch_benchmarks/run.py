"""Benchmark harness of the port: one module per paper table/figure.

Port of ``benchmarks/run.py``.  Each emits ``name,us_per_call,derived`` CSV
lines (see ``torch_benchmarks/common.py``) and runs on ``--device``
(default the GPU).

  PYTHONPATH=src python torch_benchmarks/run.py              # everything
  PYTHONPATH=src python torch_benchmarks/run.py fig11        # one figure
  PYTHONPATH=src python torch_benchmarks/run.py --device cpu --smoke
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch_benchmarks import (fig7_nor_scaling, fig8_nand_scaling,  # noqa: E402
                              fig9_robustness, fig11_hdc_accuracy,
                              fig12_speedup, table2_comparison)

ALL = {
    "fig7": fig7_nor_scaling.run,
    "fig8": fig8_nand_scaling.run,
    "table2": table2_comparison.run,
    "fig9": fig9_robustness.run,
    "fig11": fig11_hdc_accuracy.run,
    "fig12": fig12_speedup.run,
}

#: the figures whose full size a ``--smoke`` run cuts
SMOKE = ("fig11", "fig12")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="*",
                    help=f"tables/figures to run, of {list(ALL)} "
                         "(default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--smoke", action="store_true",
                    help="fig11 and fig12 at their smoke sizes")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.which) - set(ALL))
    if unknown:
        ap.error(f"unknown table/figure {unknown}; expected of {list(ALL)}")
    print("name,us_per_call,derived")
    for name in args.which or list(ALL):
        kw = {"smoke": True} if args.smoke and name in SMOKE else {}
        ALL[name](device=args.device, **kw)


if __name__ == "__main__":
    main()
