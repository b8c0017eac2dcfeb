"""Fig. 9: Monte-Carlo robustness under device variation (sigma = 54 mV).

Port of ``benchmarks/fig9_robustness.py``.  Distributions of the matchline
discharge current for the match case vs the worst case (single
adjacent-level mismatch), through ``mibo_mc`` — the hand-written kernel on
the GPU, its plain version on the CPU.  Derived: sense-margin ratio and MC
sensing-error rate across 3-bit words.  The V_TH noise comes from a
``torch.Generator`` seeded as the reference seeds its key (42), and each
pair of distributions shares one draw, as the reference's shares its key.

  PYTHONPATH=src python torch_benchmarks/fig9_robustness.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch_benchmarks.common import emit, time_call  # noqa: E402
from repro_torch.core import mibo  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.mibo_mc import ops as mc_ops  # noqa: E402

N_MC = 2048   # paper shows 100 transients; we push the same study further
SEED = 42


def run(device=None):
    dev = resolve_device(device)

    def currents(stored, query, bits=3):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return mc_ops.monte_carlo_ml_currents(stored, query, bits,
                                              n_samples=N_MC, generator=gen)

    rng = np.random.default_rng(SEED)
    stored = torch.from_numpy(rng.integers(0, 8, 32)).to(dev)
    us = time_call(lambda: currents(stored, stored), warmup=1, iters=3)

    i_match = currents(stored, stored)
    worst = stored.clone()
    worst[0] = (stored[0] + 1) % 8
    i_mm = currents(stored, worst)

    thr = mibo.I_D_THRESHOLD * 3  # TIQ SA trip point above the D threshold
    leak_rate = float((i_match > thr).float().mean())   # false discharge
    miss_rate = float((i_mm < thr).float().mean())      # missed mismatch
    emit("fig9_margin", us,
         f"n_mc={N_MC};sa_threshold_A={thr:.2e};"
         f"p1_mismatch_A={float(torch.quantile(i_mm, 0.01)):.3e};"
         f"match_leak_rate={leak_rate:.5f};mismatch_miss_rate={miss_rate:.5f}")

    # per-bits margin scan: more bits -> tighter ladder -> smaller margin
    for bits in (1, 2, 3):
        st = torch.from_numpy(rng.integers(0, 1 << bits, 32)).to(dev)
        wc = st.clone()
        wc[0] = (st[0] + 1) % (1 << bits)
        im = currents(st, st, bits)
        ix = currents(st, wc, bits)
        m = float(ix.min()) / max(float(im.max()), 1e-12)
        emit(f"fig9_bits{bits}", 0.0, f"min_margin_x={m:.1f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
