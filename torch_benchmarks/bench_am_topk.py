"""Dense vs fused top-k over (Q, N, k), plus the bank-merge sweep.

Port of ``benchmarks/bench_am_topk.py``.  The fused tier's claim is
architectural: the dense path writes the whole (Q, N) mismatch matrix to
memory (the ``cam_search`` kernel) and then orders it, O(Q*N) traffic to
extract O(Q*k) results, while the fused path (``cam_pack`` and
``cam_search_topk``) folds a running per-query top-k into the kernel's
stream over N, and its only outputs are the (Q, k) result pair.  This
benchmark sweeps (Q, N, k) and reports, per shape:

  * dense / fused wall-clock on the card (the dense tier is
    ``ops.mismatch_counts`` followed by the stable two-key order of the
    port's contract, ascending (distance, row): ``torch.sort(stable=True)``,
    never a bare ``torch.topk``, whose ties do not go to the lowest row);
  * the bytes each path must write, from the output shapes under
    ``FakeTensorMode`` (nothing runs), plus the shared input bytes;
  * the output-traffic ratio dense/fused ~= N*4 / (k*8), linear in N/k.

The k-sweep (k = 8 .. 256) times dense against fused across the whole
fused band, up to ``am.FUSED_K_MAX = 256``.  The reference also counts
each TPU merge network's per-block jaxpr equations (``merge_eqn_counts``)
and times its two networks (``merge_alg=``): they measure TPU merge
networks the port does not have (the CUDA kernel has one merge, and
``merge_alg=`` is not ported), so neither is here.  The
report's ``ksweep`` holds no entry, since ``scripts/check_bench_regression
.py --topk-*`` reads its ``eqns_*`` keys; the timings go to ``ksweep_us``,
and the script diffs two of the port's reports unchanged (the ceiling,
the geometry, every bank count's traffic and ``auto`` resolution).

The merge-topology sweep (``--banks-sweep`` for just this part) covers
``search_sharded``'s cross-bank candidate reduction: per-device merge
traffic is O(Q*k*banks) for the flat all-gather, O(Q*k*log banks) for the
tree merge and O(Q*k) for the ring.  Traffic comes from
``am.merge_traffic_bytes``; each bank count also runs all three merges on
``LocalMesh((banks,), ("model",))`` (banks as slices of one device), times
them and asserts them bitwise ``am.search``.  At the reference's grid
(Q = 16 queries, 4,096 rows of 24) the merges' times are launch overhead:
with Q below the bank count the ring's query chunks are mostly padding.
``run_merge_sweep(q=, k=, n=, d=)`` times them at a real table's geometry
instead, Q a multiple of every bank count.

``--smoke`` shrinks the sweeps and asserts:

  * dense == fused bitwise at every swept k, including k = 256, and fused
    output bytes = Q*k*8, independent of N;
  * ``am.search`` at k = 256 takes the fused tier (``am.fused_fallbacks()``
    stays 0);
  * tree == allgather == ring == single-device bitwise at every bank count;
  * tree merge traffic grows with ceil(log2(banks)), allgather with
    (banks - 1), and the ring's banks-normalised traffic is constant.

Entry points run on the GPU unless ``--device cpu`` is given.  Results
land in ``BENCH_topk.json`` (in the working directory) next to the CSV
lines.

  PYTHONPATH=src:. python torch_benchmarks/bench_am_topk.py
  PYTHONPATH=src:. python torch_benchmarks/bench_am_topk.py --smoke --device cpu
  PYTHONPATH=src:. python torch_benchmarks/bench_am_topk.py --banks-sweep
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch_benchmarks.common import emit, time_call  # noqa: E402
from repro_torch.core import am  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.dist import LocalMesh  # noqa: E402
from repro_torch.kernels.cam_search import ops as cam_ops  # noqa: E402

BITS = 3
#: the k grid of the sweep; the top end IS am.FUSED_K_MAX.
K_SWEEP = (8, 16, 32, 64, 128, 256)
MERGES = ("tree", "allgather", "ring")


def dense_topk(queries, table, k):
    """The dense tier: the full (Q, N) mismatch matrix (``cam_search``),
    then the stable two-key order, ascending (distance, row)."""
    mm = cam_ops.mismatch_counts(queries, table, BITS).to(torch.float32)
    vals, idx = torch.sort(mm, dim=1, stable=True)
    return idx[:, :k].to(torch.int32), vals[:, :k]


def fused_topk(queries, table, k):
    """The fused tier: ``cam_pack`` + ``cam_search_topk``."""
    return cam_ops.topk_fused(queries, table, k=k, bits=BITS)


def output_bytes(fn, *args) -> int:
    """Bytes of every tensor ``fn`` returns, from the output shapes under
    ``FakeTensorMode``: each argument stands in as a fake tensor of its
    shape and dtype, and nothing runs.  The fake tensors lie on the meta
    device, where ``ops`` takes the plain versions (in one block: nothing
    is allocated), whose outputs have the kernels' shapes and dtypes by
    contract."""
    with FakeTensorMode():
        fakes = [torch.empty(a.shape, dtype=a.dtype, device="meta")
                 for a in args]
        out = fn(*fakes)
    return sum(t.numel() * t.element_size() for t in out)


def _codes(rng, rows, d, device):
    return torch.as_tensor(rng.integers(0, 8, (rows, d), dtype=np.int32),
                           device=device)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def run(smoke: bool = False, *, d: int = 64, device=None) -> None:
    if smoke:
        grid = [(16, 256, 4), (16, 2048, 4)]
        iters = 3
    else:
        grid = [(q, n, k) for q in (64,) for n in (1024, 8192, 65536)
                for k in (4, 16)]
        iters = 10
    rng = np.random.default_rng(0)

    for q, n, k in grid:
        queries = _codes(rng, q, d, device)
        table = _codes(rng, n, d, device)
        dense_us = time_call(dense_topk, queries, table, k, iters=iters)
        fused_us = time_call(fused_topk, queries, table, k, iters=iters)

        in_bytes = q * d + n * d                        # int8 in-kernel
        # dense pays the (Q, N) matrix; fused pays only the (Q, k) pair
        dense_out = q * n * 4 + output_bytes(
            lambda qq, tt: dense_topk(qq, tt, k), queries, table)
        fused_out = output_bytes(lambda qq, tt: fused_topk(qq, tt, k),
                                 queries, table)
        ratio = dense_out / fused_out

        if smoke:
            assert _same(fused_topk(queries, table, k),
                         dense_topk(queries, table, k)), (q, n, k)
            # fused output traffic must not scale with N: it is exactly
            # the (Q, k) index + distance pair
            assert fused_out == q * k * 8, (fused_out, q, k)
            assert dense_out > n * q, (dense_out, n, q)

        emit(f"am_topk_q{q}_n{n}_k{k}", fused_us,
             f"dense_us={dense_us:.1f};fused_us={fused_us:.1f};"
             f"dense_bytes={in_bytes + dense_out};"
             f"fused_bytes={in_bytes + fused_out};"
             f"out_traffic_ratio={ratio:.0f}x")


def sweep_inputs(q: int, n: int, d: int, device) -> tuple:
    """The k sweep's (Q, D) queries and (N, D) table, int32 3-bit codes
    drawn from seed 0 (the same tensors on every call)."""
    rng = np.random.default_rng(0)
    queries = _codes(rng, q, d, device)
    return queries, _codes(rng, n, d, device)


def run_k_sweep(smoke: bool, report: dict, *, d: int = 64, q=None, n=None,
                device=None, verify=None, iters=None) -> dict:
    """k = 8..256: dense against fused at (Q, N, D), default (16, 2048, 64)
    with ``smoke``, else (64, 8192, 64).  ``verify`` (default ``smoke``)
    holds fused to dense bitwise at every k.  Adds each k's timings and
    output bytes to ``report["ksweep_us"]`` and returns them by k."""
    q = q or (16 if smoke else 64)
    n = n or (2048 if smoke else 8192)
    verify = smoke if verify is None else verify
    iters = iters or (3 if smoke else 10)
    wall_ks = (8, 64, 256) if smoke else K_SWEEP
    queries, table = sweep_inputs(q, n, d, device)
    out = {}
    for k in wall_ks:
        dense_us = time_call(dense_topk, queries, table, k, iters=iters)
        fused_us = time_call(fused_topk, queries, table, k, iters=iters)
        dense_out = q * n * 4 + output_bytes(
            lambda qq, tt, k=k: dense_topk(qq, tt, k), queries, table)
        fused_out = output_bytes(lambda qq, tt, k=k: fused_topk(qq, tt, k),
                                 queries, table)
        if verify:
            # bitwise across the whole band, k = 256 included
            assert _same(fused_topk(queries, table, k),
                         dense_topk(queries, table, k)), (q, n, d, k)
            assert fused_out == q * k * 8, (fused_out, q, k)
        out[k] = {"dense_us": dense_us, "fused_us": fused_us,
                  "dense_out_bytes": dense_out, "fused_out_bytes": fused_out,
                  "bitwise": bool(verify)}
        report["ksweep_us"][str(k)] = out[k]
        emit(f"am_topk_ksweep_q{q}_n{n}_k{k}", fused_us,
             f"dense_us={dense_us:.1f};fused_us={fused_us:.1f};"
             f"dense_out_bytes={dense_out};fused_out_bytes={fused_out}")

    # the ceiling end to end: am.search at k = max(K_SWEEP) must take the
    # fused tier, not the dense fallback the counter surfaces
    assert am.FUSED_K_MAX >= max(K_SWEEP), am.FUSED_K_MAX
    am.reset_fused_fallbacks()
    t = am.make_table(table, bits=BITS, device=table.device)
    am.search(t, queries, k=max(K_SWEEP), backend="cuda")
    assert am.fused_fallbacks() == 0, am.fused_fallbacks()
    return out


def run_merge_sweep(smoke: bool, report: dict, *, d: int = 24, device=None,
                    banks_sweep=None, iters=None, q=None, k=None,
                    n=None) -> dict:
    """Tree vs allgather vs ring: per-device merge traffic, and each merge
    on ``LocalMesh((banks,), ("model",))`` timed and held bitwise to
    ``am.search``; smoke Q is a multiple of every bank count so the
    ring's query chunks never pad (the flat-traffic bound needs Q >=
    banks).  ``q``, ``k``, ``n`` replace the grid's geometry (default
    (64, 8, 512) with ``smoke``, else the reference's (16, 8, 4096)).
    Returns each bank count's entry."""
    gq, gk, gn = (64, 8, 512) if smoke else (16, 8, 4096)
    q, k, n = q or gq, k or gk, n or gn
    banks_sweep = banks_sweep or ((2, 4, 8, 16, 32, 64) if smoke else
                                  (2, 4, 8, 16, 32, 64, 128, 256))
    iters = iters or (3 if smoke else 10)
    rng = np.random.default_rng(0)
    codes = _codes(rng, n, d, device)
    queries = _codes(rng, q, d, device)
    table = am.make_table(codes, bits=BITS, device=codes.device)
    want = am.search(table, queries, k=k, backend="cuda")
    report["merge_geometry"] = {"q": q, "k": k, "n": n}

    traffic = {}
    for banks in banks_sweep:
        tree_b, ag_b, ring_b = (am.merge_traffic_bytes(banks, q, k, merge=m,
                                                       n_rows=n)
                                for m in MERGES)
        traffic[banks] = (tree_b, ag_b, ring_b)
        auto = am.resolve_merge("auto", banks, k)
        entry = {"tree_bytes": tree_b, "allgather_bytes": ag_b,
                 "ring_bytes": ring_b, "auto": auto}
        mesh = LocalMesh((banks,), ("model",))
        derived = (f"tree_bytes={tree_b};allgather_bytes={ag_b};"
                   f"ring_bytes={ring_b};"
                   f"tree_saving={ag_b / tree_b:.1f}x;"
                   f"ring_saving={ag_b / ring_b:.1f}x;auto={auto}")
        for merge in MERGES:
            def call(merge=merge):
                return am.search_sharded(table, queries, mesh=mesh, k=k,
                                         merge=merge, backend="cuda")
            us = time_call(call, iters=iters)
            got = call()
            assert torch.equal(got.indices, want.indices) and torch.equal(
                got.distances, want.distances), (banks, merge)
            entry[f"{merge}_us"] = us
            derived += f";{merge}_us={us:.1f}"
        report["merge"][str(banks)] = entry
        emit(f"am_merge_banks{banks}_q{q}_k{k}", entry["tree_us"], derived)

    if smoke:
        # tree traffic is O(Q*k*log banks): it grows with ceil(log2(banks)),
        # allgather with (banks - 1), and the ring's banks-normalised
        # traffic is constant at 2*Q*k*8 (each query chunk travels 2*(banks
        # - 1) times and a chunk is Q/banks)
        per_round = q * k * 8                     # (Q, k) f32+i32 pair
        for banks in banks_sweep:
            tree_b, ag_b, ring_b = traffic[banks]
            rounds = (banks - 1).bit_length()
            chunk = -(-q // banks)
            assert tree_b == rounds * per_round, (banks, tree_b, rounds)
            assert ag_b == (banks - 1) * per_round, (banks, ag_b)
            assert ring_b == 2 * (banks - 1) * chunk * k * 8, (banks, ring_b)
        assert traffic[64][0] / traffic[4][0] == 3.0      # log2(64)/log2(4)
        assert traffic[64][1] / traffic[4][1] == 21.0     # 63/3
        flat = {b * traffic[b][2] // (b - 1) for b in banks_sweep}
        assert flat == {2 * per_round}, flat     # ring: O(Q*k), banks-free
        assert traffic[64][0] < traffic[64][1]   # tree wins where it matters
        for banks in (8, 16, 32, 64):
            assert traffic[banks][2] < traffic[banks][0], (banks, traffic)
    return report["merge"]


def new_report() -> dict:
    return {"bits": BITS, "fused_k_max": am.FUSED_K_MAX, "ksweep": {},
            "ksweep_us": {}, "merge": {}, "merge_geometry": {}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweeps + bitwise/traffic assertions")
    ap.add_argument("--banks-sweep", action="store_true",
                    help="run only the merge-topology (tree vs allgather vs "
                         "ring) sweep")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("name,us_per_call,derived")
    report = new_report()
    if not args.banks_sweep:
        run(smoke=args.smoke, device=device)
        run_k_sweep(args.smoke, report, device=device)
    run_merge_sweep(args.smoke, report, device=device)
    report["device"] = str(device)
    if device.type == "cuda":
        report["card"] = torch.cuda.get_device_name(device)
    with open("BENCH_topk.json", "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
    print(f"wrote BENCH_topk.json ({len(report['ksweep_us'])} k points, "
          f"{len(report['merge'])} bank counts)", flush=True)
    return report


if __name__ == "__main__":
    main()
