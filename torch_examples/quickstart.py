"""Quickstart: the SEE-MCAM core in five minutes.

Port of ``examples/quickstart.py``.  Programs a 3-bit NOR SEE-MCAM array,
runs associative searches through the behavioural FeFET device model, the
plain compare, the CUDA kernels and the analog backend, shards the same
search over a multi-bank mesh, prunes it sub-linearly through the
set-associative index tier, and prints the calibrated energy/latency/area
numbers (Table II).  Codes and V_TH variation are drawn from numpy and a
``torch.Generator``, not the reference's JAX keys, so the rows differ from
its printout; the checks hold all the same.

  PYTHONPATH=src python torch_examples/quickstart.py                 # GPU
  PYTHONPATH=src python torch_examples/quickstart.py --banks 8 --device cpu

The sharded stanza banks the rows over a local mesh of ``--banks`` banks
(default 1, as the reference on one device), slices of the one device;
the reference fakes a device count with ``XLA_FLAGS`` instead.
"""

import argparse

import numpy as np
import torch

from repro_torch import index as rindex
from repro_torch.core import am, cam_array, energy
from repro_torch.device import resolve_device
from repro_torch.dist import LocalMesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--banks", type=int, default=1,
                    help="banks of the local mesh the sharded search uses")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # 1. program a 64-word x 32-cell, 3-bit/cell NOR-type SEE-MCAM
    cfg = cam_array.SEEMCAMConfig(bits=3, n_cells=32, n_rows=64, variant="nor")
    arr = cam_array.SEEMCAMArray(cfg, device=dev)
    codes = rng.integers(0, 8, (64, 32)).astype(np.int32)
    arr.program(codes, generator=torch.Generator(device=dev).manual_seed(7))

    # 2. search a stored word -> exact match on its row only
    r = arr.search(codes[21])
    rows = torch.nonzero(r.match).flatten().tolist()
    print(f"search stored word 21: match rows = {rows}")
    assert rows == [21]

    # 3. nearest-Hamming associative readout (analog ML-discharge ranking)
    noisy = codes[21].copy()
    noisy[3] = (noisy[3] + 1) % 8
    best = int(arr.best_match(noisy)[0])
    print(f"1-cell-corrupted query -> best row = {best}")

    # 4. the same search through the functional AM API, every backend
    table = am.make_table(codes, bits=3, device=dev)
    for backend in ("ref", "pallas", "analog"):
        res = am.search(table, noisy, k=3, backend=backend)
        print(f"backend={backend:7s} top3_rows={res.indices.tolist()} "
              f"distances={res.distances.tolist()}")
    want = am.search(table, noisy, k=3, backend="ref")

    # 5. the same search sharded over a multi-bank mesh: rows banked over
    #    the `model` axis, per-bank top-k reduced by the merge topology
    #    (auto: all-gather on narrow meshes, tree on wide) — bitwise the
    #    single-device am.search above
    mesh = LocalMesh((args.banks,), ("model",))
    res = am.search_sharded(table, noisy, mesh=mesh, k=3, backend="pallas",
                            merge="auto")
    print(f"sharded over {args.banks} bank(s) "
          f"[merge={am.resolve_merge('auto', args.banks)}]: "
          f"top3_rows={res.indices.tolist()} "
          f"distances={res.distances.tolist()}")
    assert torch.equal(res.indices, want.indices)
    assert torch.equal(res.distances, want.distances)

    # 6. sub-linear search through the set-associative index tier: a coarse
    #    pass over quantized centroid codes picks `probes` sets, the fine
    #    pass scans only those — probes = sets is the flat am.search bitwise
    idx = rindex.build(table, sets=8)
    r4 = rindex.search(idx, noisy, k=3, probes=4, backend="pallas")
    r8 = rindex.search(idx, noisy, k=3, probes=8, backend="pallas")
    print(f"indexed (probes=4/8): top3_rows={r4.indices.tolist()} "
          f"scanned={float(r4.candidate_fraction):.0%} of rows "
          f"(certified recall >= {float(r4.recall_proxy):.2f}); "
          f"probes=8 exact={r8.distances.tolist() == res.distances.tolist()}")

    # 7. calibrated circuit model (Table II operating point)
    s = energy.model_summary(n_cells=32, bits=3)
    print(f"\nNOR  2FeFET-1T : {s['nor']['energy_fj_per_bit']:.3f} fJ/bit, "
          f"{s['nor']['latency_ps']:.0f} ps, "
          f"{s['nor']['area_um2_per_bit']:.2f} um^2/bit")
    print(f"NAND 2FeFET-2T : {s['nand']['energy_fj_per_bit']:.3f} fJ/bit, "
          f"{s['nand']['latency_ps']:.0f} ps, "
          f"{s['nand']['area_um2_per_bit']:.2f} um^2/bit")
    r = energy.energy_ratios()
    print(f"energy efficiency vs 16T CMOS: {r['16T CMOS [8]']:.1f}x "
          f"(paper: 9.8x)")


if __name__ == "__main__":
    main()
