"""Longest-prefix-match routing on the ternary CAM tier, end to end.

Port of ``examples/lpm_routing.py``.  Builds a small synthetic IPv4-style
routing table (overlapping prefixes, a sub-symbol prefix length, a default
route), compiles it into a masked longest-prefix-first
:class:`~repro_torch.core.am.AMTable` via :mod:`repro_torch.tcam`, and
resolves a batch of addresses with a single ``am.search(..., matches=M)``
call on the CUDA kernels — CAM priority (lowest row index among exact
masked matches) *is* the longest prefix.  Every resolved hop is checked
against the pure-python :func:`repro_torch.tcam.lpm_oracle`.

  PYTHONPATH=src python torch_examples/lpm_routing.py               # GPU
  PYTHONPATH=src python torch_examples/lpm_routing.py --device cpu
"""

import argparse

import numpy as np

from repro_torch import tcam

# 16-bit addresses as 8 symbols x 2 bits/cell.
WIDTH, BITS = 8, 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    routes = [
        tcam.Route(0x0000, 0, 0),        # 0.0/0      default route
        tcam.Route(0xA000, 4, 1),        # A.*/4
        tcam.Route(0xAB00, 8, 2),        # AB.*/8     inside A.*/4
        tcam.Route(0xABC0, 12, 3),       # ABC.*/12   inside AB.*/8
        tcam.Route(0xAB80, 9, 4),        # 9-bit: sub-symbol for 2-bit cells
        tcam.Route(0x4000, 2, 5),        # 01.*/2
        tcam.Route(0x4000, 2, 6),        # duplicate rule: first-added wins
    ]
    rt = tcam.build_routing_table(routes, width=WIDTH, bits=BITS,
                                  default_hop=-1, device=args.device)
    n = rt.table.n_rows
    print(f"{len(routes)} routes -> {n} ternary rows "
          f"(sub-symbol prefixes expand via range cover) on "
          f"{rt.table.device}")

    rng = np.random.default_rng(0)
    addrs = np.concatenate([
        rng.integers(0, 1 << (WIDTH * BITS), 48),
        [0xABCD, 0xABC1, 0xAB91, 0xAB01, 0xA001, 0x4001, 0x0001],
    ]).astype(np.int64)
    hops, result = tcam.lookup(rt, addrs, matches=8, backend="cuda")
    hops = hops.cpu().numpy()
    counts = result.match_count.cpu().numpy()

    for a, h, cnt in list(zip(addrs.tolist(), hops.tolist(),
                              counts.tolist()))[-7:]:
        print(f"  addr=0x{a:04X} -> next_hop={h:2d}  "
              f"({cnt} matching rule rows)")

    want = [tcam.lpm_oracle(routes, a, width=WIDTH, bits=BITS,
                            default_hop=-1) for a in addrs.tolist()]
    assert hops.tolist() == want, "LPM lookup disagrees with the oracle"
    assert bool(result.matched[:, 0].all()), \
        "default route should cover every address"
    print(f"all {len(addrs)} lookups match lpm_oracle; "
          f"multi-match counts 1..{int(counts.max())}")
    return hops


if __name__ == "__main__":
    main()
