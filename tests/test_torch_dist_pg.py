"""The process-group mesh gives the local mesh's bits, over gloo on the CPU.

One subprocess starts 4 ranks (``torch.multiprocessing.spawn``) joined by a
gloo process group on ``localhost``.  Each rank builds three
:class:`repro_torch.dist.ProcessGroupMesh` meshes — all 4 ranks on
``("model",)``, a 3-rank subgroup (the uneven bank count; rank 3 holds no
bank) and 2 x 2 ``("data", "model")`` (query sharding over ``data``) — and
holds, bitwise against a :class:`~repro_torch.dist.LocalMesh` of the same
shape in the same process: the allgather, tree and ring merges on the same
per-bank candidates; ``am.search_sharded`` for top-k, ``valid_rows``,
k above any bank's rows and multi-match on a ternary table; and
``ivf.search_sharded``.  The port's search code never imports JAX.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    MERGES = ("allgather", "tree", "ring")
    FIELDS = ("indices", "distances", "exact", "matched")


    def same(a, b, fields, what):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and torch.equal(x, y), (what, f)


    def rank_main(rank, world, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch import index as tindex
        from repro_torch.core import am
        from repro_torch.dist import LocalMesh, ProcessGroupMesh
        meshes = [
            ((4,), ("model",), None),
            ((3,), ("model",), [0, 1, 2]),
            ((2, 2), ("data", "model"), None),
        ]
        built = [(ProcessGroupMesh(s, a, ranks=r), LocalMesh(s, a))
                 for s, a, r in meshes]
        rng = np.random.default_rng(0)
        codes = rng.integers(0, 8, (37, 24)).astype(np.int32)
        ties = rng.integers(0, 2, (37, 24)).astype(np.int32)
        care = rng.integers(0, 2, (37, 24)).astype(np.int32)
        q = rng.integers(0, 8, (6, 24)).astype(np.int32)
        plain = am.make_table(codes, bits=3, device="cpu")
        tied = am.make_table(ties, bits=3, distance="l1", device="cpu")
        masked = am.make_table(ties, bits=3, care_mask=care, device="cpu")
        index = tindex.build(plain, sets=7, seed=3)
        for n, (pg, local) in enumerate(built):
            if pg.coords is None:
                continue
            banks = pg.shape["model"]
            me = pg.coords["model"]
            rng = np.random.default_rng(n + 1)     # the same on every rank
            cand = rng.integers(0, 4, (banks, 6, 5)).astype(np.float32)
            rows = np.argsort(rng.random((banks, 6, 40)), -1)[..., :5]
            rows = (rows + 40 * np.arange(banks)[:, None, None])
            order = np.lexsort((rows, cand), axis=-1)
            d = torch.from_numpy(np.take_along_axis(cand, order, -1))
            i = torch.from_numpy(np.take_along_axis(rows, order, -1)
                                 .astype(np.int32))
            for merge in MERGES:
                gl = am._merge_bank_candidates(d, i, mesh=local,
                                               axis="model", n_banks=banks,
                                               k=7, strategy=merge)
                gp = am._merge_bank_candidates(d[me:me + 1], i[me:me + 1],
                                               mesh=pg, axis="model",
                                               n_banks=banks, k=7,
                                               strategy=merge)
                for x, y in zip(gl, gp):
                    assert torch.equal(x[0], y[0]), (pg, merge)
                for tab, kw in ((plain, {"k": 5, "threshold": 9}),
                                (plain, {"k": 20, "valid_rows": 20}),
                                (tied, {"k": 37, "backend": "ref"}),
                                (masked, {"matches": 6, "threshold": 3.0})):
                    kw = {"backend": "cuda", **kw}
                    a = am.search_sharded(tab, q, mesh=pg, merge=merge, **kw)
                    b = am.search_sharded(tab, q, mesh=local, merge=merge,
                                          **kw)
                    fields = FIELDS + (("match_count", "overflow")
                                       if "matches" in kw else ())
                    same(a, b, fields, (pg, merge, kw))
                    same(a, am.search(tab, q, **kw), fields,
                         (pg, merge, kw, "flat"))
                a = tindex.search_sharded(index, q, mesh=pg, k=6, probes=3,
                                          merge=merge, backend="cuda")
                b = tindex.search_sharded(index, q, mesh=local, k=6,
                                          probes=3, merge=merge,
                                          backend="cuda")
                same(a, b, FIELDS + ("recall_proxy",), (pg, merge, "ivf"))
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            print("PG_OK", flush=True)


    if __name__ == "__main__":
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(rank_main, args=(4, port), nprocs=4)
""")


def test_process_group_mesh_matches_local_mesh(tmp_path):
    script = tmp_path / "pg_ranks.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script)], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "PG_OK" in out.stdout, (
        out.stdout[-2000:], out.stderr[-4000:])
