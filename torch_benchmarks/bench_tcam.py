"""Ternary tier cost + LPM throughput: masked vs unmasked, dense vs fused.

Port of ``benchmarks/bench_tcam.py``.  The tcam tier's claims:

  * the care-mask plane costs one extra AND inside the compare — masked
    search should track unmasked search closely on both the dense and the
    fused tier;
  * an all-care mask is *free* in semantics: bitwise-identical indices and
    distances to the unmasked path, dense and fused;
  * multi-match (``matches=M``) reproduces a numpy oracle including match
    counts, overflow, and the lowest-(distance, row) priority slot;
  * longest-prefix-match routing resolves through one
    ``am.search(..., matches=M)`` call and agrees with the pure-python
    ``lpm_oracle`` on every address.

This benchmark wall-clocks masked vs unmasked search (``ref`` and
``cuda`` backends; on the GPU ``cuda`` runs the hand-written kernels) and
batched LPM lookups, and emits the masked/unmasked overhead ratio.
``--smoke`` shrinks the sweeps and asserts the all-care identity, the
multi-match oracle, and the LPM oracle gates.  It runs on the GPU unless
``--device cpu`` is given.

  PYTHONPATH=src:. python torch_benchmarks/bench_tcam.py
  PYTHONPATH=src:. python torch_benchmarks/bench_tcam.py --smoke --device cpu
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
from repro_torch import tcam  # noqa: E402
from repro_torch.core import am  # noqa: E402

BITS = 3
WIDTH_LPM, BITS_LPM = 8, 2      # 16-bit addresses, 2-bit cells
BACKENDS = ("ref", "cuda")


def make_case(n, q, d, *, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << BITS, size=(n, d))
    queries = rng.integers(0, 1 << BITS, size=(q, d))
    care = rng.integers(0, 2, size=(n, d))
    return codes, queries, care


def make_routes(n_routes, *, seed=0):
    """Random overlapping prefixes plus a default route, first entry last."""
    rng = np.random.default_rng(seed)
    total = WIDTH_LPM * BITS_LPM
    routes = [tcam.Route(0, 0, 0)]
    for i in range(n_routes - 1):
        p = int(rng.integers(1, total + 1))
        v = int(rng.integers(0, 1 << total))
        routes.append(tcam.Route(v, p, i + 1))
    return routes


def multimatch_oracle(codes, queries, care, thr, m):
    """Fixed-width all-matches-within-threshold reference, numpy-only."""
    diff = (queries[:, None, :] != codes[None, :, :]) & (care[None] != 0)
    d = diff.sum(-1).astype(np.float64)
    idx = np.full((len(queries), m), -1, np.int64)
    dist = np.full((len(queries), m), np.inf)
    count = np.zeros(len(queries), np.int64)
    for qi in range(len(queries)):
        hits = np.flatnonzero(d[qi] <= thr)
        hits = hits[np.argsort(d[qi][hits], kind="stable")]
        count[qi] = len(hits)
        w = hits[:m]
        idx[qi, :len(w)] = w
        dist[qi, :len(w)] = d[qi][w]
    return idx, dist, count, count > m


def check_allcare_identity(backend, device):
    """All-care masked search == unmasked search, bitwise, on a tie-heavy
    shape — indices AND distances."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2, size=(96, 24)) * 7
    queries = rng.integers(0, 2, size=(16, 24)) * 7
    plain = am.make_table(codes, bits=BITS, device=device)
    allcare = am.make_table(codes, bits=BITS, care_mask=np.ones_like(codes),
                            device=device)
    want = am.search(plain, queries, k=12, threshold=9, backend=backend)
    got = am.search(allcare, queries, k=12, threshold=9, backend=backend)
    for f in ("indices", "distances", "matched", "exact"):
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      getattr(want, f).cpu().numpy(),
                                      err_msg=f"{backend}: {f}")


def check_multimatch_oracle(backend, device):
    """am.search(matches=M) == the numpy oracle — counts, overflow, and
    the (distance, row) priority ordering, masked and overflowing."""
    codes, queries, care = make_case(80, 12, 16, seed=5)
    t = am.make_table(codes, bits=BITS, care_mask=care, device=device)
    for thr, m in ((4.0, 6), (10.0, 3)):
        r = am.search(t, queries, matches=m, threshold=thr, backend=backend)
        wi, wd, wc, wo = multimatch_oracle(codes, queries, care, thr, m)
        np.testing.assert_array_equal(r.match_count.cpu().numpy(), wc)
        np.testing.assert_array_equal(r.overflow.cpu().numpy(), wo)
        np.testing.assert_array_equal(r.distances.cpu().numpy(), wd)
        np.testing.assert_array_equal(r.indices.cpu().numpy(), wi)
    assert bool(am.search(t, queries, matches=3, threshold=10.0,
                          backend=backend).overflow.any())


def check_lpm(routes, rt, addrs):
    hops, result = tcam.lookup(rt, addrs, matches=8, backend="cuda")
    want = [tcam.lpm_oracle(routes, a, width=WIDTH_LPM, bits=BITS_LPM,
                            default_hop=-1) for a in addrs.tolist()]
    assert hops.cpu().numpy().tolist() == want, "LPM disagrees with oracle"
    assert bool(result.matched[:, 0].all())


def run(smoke: bool = False, device=None) -> None:
    iters = 3 if smoke else 10
    shapes = ((512, 32, 32),) if smoke else ((512, 32, 32), (4096, 64, 32),
                                             (16384, 64, 64))
    if smoke:
        for backend in BACKENDS:
            check_allcare_identity(backend, device)
            check_multimatch_oracle(backend, device)

    # masked vs unmasked wall-clock: the one-extra-AND overhead claim
    for n, q, d in shapes:
        codes, queries, care = make_case(n, q, d)
        plain = am.make_table(codes, bits=BITS, device=device)
        masked = am.make_table(codes, bits=BITS, care_mask=care,
                               device=device)
        queries = torch.as_tensor(queries, dtype=torch.int32,
                                  device=plain.device)
        for backend in BACKENDS:
            base = time_call(lambda: am.search(plain, queries, k=8,
                                               backend=backend), iters=iters)
            cost = time_call(lambda: am.search(masked, queries, k=8,
                                               backend=backend), iters=iters)
            emit(f"tcam_masked_{backend}_n{n}_d{d}", cost,
                 f"unmasked_us={base:.1f};overhead={cost / base:.2f}x")
        mm = time_call(lambda: am.search(masked, queries, matches=8,
                                         threshold=6.0, backend="cuda"),
                       iters=iters)
        emit(f"tcam_multimatch_n{n}_d{d}_m8", mm, "threshold=6.0")

    # LPM routing throughput: addresses resolved per second, one
    # multi-match search per batch
    n_routes, n_addrs = (64, 256) if smoke else (512, 4096)
    routes = make_routes(n_routes, seed=1)
    rt = tcam.build_routing_table(routes, width=WIDTH_LPM, bits=BITS_LPM,
                                  default_hop=-1, device=device)
    rng = np.random.default_rng(2)
    addrs = rng.integers(0, 1 << (WIDTH_LPM * BITS_LPM), n_addrs)
    if smoke:
        check_lpm(routes, rt, addrs)
    qcodes = tcam.encode_addresses(rt, addrs)
    us = time_call(lambda: am.search(rt.table, qcodes, matches=8,
                                     backend="cuda"), iters=iters)
    emit(f"tcam_lpm_r{rt.table.n_rows}_a{n_addrs}", us,
         f"addrs_per_s={n_addrs / (us * 1e-6):.0f}")
    if smoke:
        print("smoke gates passed: all-care identity (ref+cuda), "
              "multi-match oracle, LPM oracle", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweeps + identity/oracle assertions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
