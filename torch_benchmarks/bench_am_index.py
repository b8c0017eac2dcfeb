"""IVF index tier vs flat search: recall/candidate-fraction/wall-clock.

Port of ``benchmarks/bench_am_index.py``.  The index tier's claim is that
a set-associative coarse pass turns the O(N) flat scan into O(S + P*N/S)
fine work while staying *contract-compatible* with ``am.search``:

  * at ``probes == sets`` the result is bitwise-identical to the flat
    path — indices AND distances, including the ascending (distance, row)
    tie-break — because in-set slabs keep ascending global-id order and the
    cross-set merge is the same two-key order;
  * at ``probes < sets`` the candidate fraction drops to ~P/S while
    recall@k degrades gracefully on clusterable data.

This benchmark generates clustered synthetic data (S Gaussian centers,
3-bit CDF-equalized quantization), sweeps probes for the recall/fraction
frontier, and wall-clocks indexed vs flat search over growing row counts,
on the GPU's kernels (``cuda`` backend) unless ``--device cpu`` is given.
Results land in ``BENCH_index.json`` (in the working directory) next to
the CSV lines.

``--smoke`` shrinks the sweeps and asserts the acceptance gates:

  * ``probes == sets`` reproduces ``am.search`` bitwise on a tie-heavy
    shape, for both the ``"ref"`` and ``"cuda"`` backends;
  * recall@10 >= 0.9 at P=4 / S=32 on the clustered data;
  * mean candidate fraction <= P/S * 1.5 (the coarse pass actually
    prunes — probing P sets must not touch much more than P/S of rows).

  PYTHONPATH=src:. python torch_benchmarks/bench_am_index.py
  PYTHONPATH=src:. python torch_benchmarks/bench_am_index.py --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch_benchmarks.common import emit, time_call  # noqa: E402
from repro_torch import index as rindex  # noqa: E402
from repro_torch.core import am, quantize  # noqa: E402

BITS = 3
SETS = 32
PROBES_GATE = 4          # the acceptance gate probes P=4 / S=32
RECALL_GATE = 0.9        # recall@10 floor at the gate point
FRAC_SLACK = 1.5         # candidate fraction <= P/S * slack


def make_clustered(n, q, *, d=32, sets=SETS, noise=0.35, center_scale=2.0,
                   seed=0):
    """S Gaussian clusters quantized to 3-bit codes with global stats.

    ``center_scale`` spreads the centers relative to the within-cluster
    noise so the clusters survive the CDF-equalizing quantizer.
    """
    rng = np.random.default_rng(seed)
    centers = center_scale * rng.normal(size=(sets, d)).astype(np.float32)
    owner = rng.integers(0, sets, size=n)
    x = centers[owner] + noise * rng.normal(size=(n, d)).astype(np.float32)
    qsrc = rng.integers(0, sets, size=q)
    qx = centers[qsrc] + noise * rng.normal(size=(q, d)).astype(np.float32)
    mu, sigma = float(x.mean()), float(x.std())
    codes = quantize.quantize(torch.from_numpy(x), BITS, mu=mu, sigma=sigma)
    qcodes = quantize.quantize(torch.from_numpy(qx), BITS, mu=mu,
                               sigma=sigma)
    return codes.numpy(), qcodes.numpy()


def recall_at_k(approx, exact):
    """Fraction of (query, slot) distances matching the exact top-k
    (tie-safe: equal-distance rows may legally swap slots)."""
    return float((approx == exact).double().mean())


def check_bitwise(backend, device):
    """probes == sets must reproduce the flat path bitwise — indices AND
    distances — on a tie-heavy shape (binary codes force collisions)."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2, size=(96, 8)) * 7   # levels {0,7}: many ties
    t = am.make_table(codes, bits=BITS, device=device)
    idx = rindex.build(t, sets=8, seed=0)
    ex = am.search(t, codes[:16], k=12, backend=backend)
    r = rindex.search(idx, codes[:16], k=12, probes=8, backend=backend)
    assert torch.equal(r.indices, ex.indices), backend
    assert torch.equal(r.distances, ex.distances), backend


def run(smoke: bool = False, device=None) -> dict:
    k = 10
    n, q = (2048, 64) if smoke else (8192, 128)
    probes_sweep = (1, 2, 4, 8, 32) if smoke else (1, 2, 4, 8, 16, 32)
    rows_sweep = (2048,) if smoke else (1024, 4096, 16384)
    iters = 3 if smoke else 10
    report: dict = {"sets": SETS, "k": k, "n": n, "queries": q,
                    "probes": {}, "wall": {}}

    if smoke:
        for backend in ("ref", "cuda"):
            check_bitwise(backend, device)

    codes, qcodes = make_clustered(n, q)
    table = am.make_table(codes, bits=BITS, device=device)
    index = rindex.build(table, sets=SETS, seed=0)
    qt = torch.as_tensor(qcodes, device=table.device)
    exact = am.search(table, qt, k=k, backend="cuda")

    for probes in probes_sweep:
        us = time_call(lambda: rindex.search(index, qt, k=k, probes=probes,
                                             backend="cuda"), iters=iters)
        r = rindex.search(index, qt, k=k, probes=probes, backend="cuda")
        rec = recall_at_k(r.distances, exact.distances)
        frac = float(r.candidate_fraction.mean())
        proxy = float(r.recall_proxy.mean())
        report["probes"][probes] = {"recall_at_k": rec,
                                    "candidate_fraction": frac,
                                    "recall_proxy": proxy,
                                    "us_per_call": us}
        emit(f"am_index_s{SETS}_p{probes}_n{n}_k{k}", us,
             f"recall@{k}={rec:.3f};frac={frac:.4f};proxy={proxy:.3f}")
        if smoke and probes == SETS:
            assert rec == 1.0 and proxy == 1.0, (rec, proxy)

    if smoke:
        gate = report["probes"][PROBES_GATE]
        assert gate["recall_at_k"] >= RECALL_GATE, gate
        bound = PROBES_GATE / SETS * FRAC_SLACK
        assert gate["candidate_fraction"] <= bound, (gate, bound)
        recs = [report["probes"][p]["recall_at_k"] for p in probes_sweep]
        assert all(a <= b + 1e-9 for a, b in zip(recs, recs[1:])), recs

    # wall-clock vs row count: flat O(N) scan vs indexed O(S + P*N/S); on
    # the GPU the indexed search makes one fused launch per probed set
    for rows in rows_sweep:
        c, qc = make_clustered(rows, q, seed=1)
        t = am.make_table(c, bits=BITS, device=device)
        ix = rindex.build(t, sets=SETS, seed=0)
        qj = torch.as_tensor(qc, device=t.device)
        flat_us = time_call(lambda: am.search(t, qj, k=k, backend="cuda"),
                            iters=iters)
        ivf_us = time_call(lambda: rindex.search(
            ix, qj, k=k, probes=PROBES_GATE, backend="cuda"), iters=iters)
        frac = float(rindex.search(ix, qj, k=k, probes=PROBES_GATE,
                                   backend="cuda").candidate_fraction.mean())
        report["wall"][rows] = {"flat_us": flat_us, "indexed_us": ivf_us,
                                "candidate_fraction": frac}
        emit(f"am_index_rows{rows}_p{PROBES_GATE}", ivf_us,
             f"flat_us={flat_us:.1f};indexed_us={ivf_us:.1f};"
             f"frac={frac:.4f}")

    report["device"] = str(table.device)
    if table.device.type == "cuda":
        report["card"] = torch.cuda.get_device_name(table.device)
    with open("BENCH_index.json", "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
    print(f"wrote BENCH_index.json ({len(report['probes'])} probe points, "
          f"{len(report['wall'])} row counts)", flush=True)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweeps + recall/bitwise assertions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
