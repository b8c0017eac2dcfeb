"""Port parity: the sharded ``AMService`` placement and the serving flags.

The port's ``AMService(mesh=...)`` is held to the whole contract of
``tests/test_am_service.py::test_sharded_placement_matches_local`` (an
8-bank ``merge="tree"`` service bitwise equal to the local one, one
readback a flush, eviction by ``append`` over the banked placement, the
merge validated at construction), which the reference itself fails at its
eviction step; and to ``tests/test_am_index.py::
test_service_sharded_with_index``.  The sharded results are also held
bitwise to the reference's local service on the same inputs, and the
``--am-sharded`` / ``--am-merge`` flags to ``repro.launch.serve``'s
parsing.  All on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.serve import AMService as JaxService
from repro_torch.dist import LocalMesh
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import AMService, IndexSpec

torch.set_num_threads(2)

CPU = "cpu"


def _codes(rng, n, width=8, bits=3):
    return rng.integers(0, 1 << bits, (n, width)).astype(np.int32)


@pytest.mark.parametrize("merge", ["tree", "allgather", "ring"])
def test_sharded_placement_matches_local(merge):
    mesh = LocalMesh((8,), ("model",))
    rng = np.random.default_rng(14)
    codes = _codes(rng, 11)
    local = AMService(device=CPU)
    sharded = AMService(mesh=mesh, merge=merge, device=CPU)
    ref = JaxService()
    for svc in (local, sharded, ref):
        svc.create_table("t", width=8, bits=3, capacity=32, policy="lru",
                         backend="pallas")
        svc.append("t", codes, values=list(range(11)))
    queries = [rng.integers(0, 8, (8,)).astype(np.int32) for _ in range(5)]
    queries.append(codes[7])
    futs = [[svc.submit("t", q, k=4, threshold=3.0) for q in queries]
            for svc in (local, sharded, ref)]
    local.flush(), sharded.flush(), ref.flush()
    for a, b, c in zip(*futs):
        ra, rb, rc = a.result(), b.result(), c.result()
        for f in ("indices", "distances", "matched"):
            np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
            np.testing.assert_array_equal(getattr(rb, f), getattr(rc, f))
        assert ra.value == rb.value == rc.value
    assert sharded.stats()["sharded"] and sharded.stats()["readbacks"] == 1
    assert sharded.stats()["merge"] == merge
    assert not local.stats()["sharded"]
    # eviction works identically over the banked placement
    more = _codes(rng, 25)
    sharded.append("t", more)
    local.append("t", more)
    assert sharded.stats("t")["rows"] <= 32
    assert sharded.stats("t")["rows"] == local.stats("t")["rows"]
    for q in list(more[-3:]) + queries:
        ra, rb = local.lookup("t", q, k=4), sharded.lookup("t", q, k=4)
        np.testing.assert_array_equal(ra.indices, rb.indices)
        np.testing.assert_array_equal(ra.distances, rb.distances)
    # the merge knob is validated at construction, not at dispatch time
    with pytest.raises(ValueError, match="mesh"):
        AMService(merge="mesh", device=CPU)


def test_sharded_service_with_dp_mesh_and_multimatch():
    """A (data, model) mesh splits the query bucket over data; multi-match
    counts are summed over the banks; both bitwise the local service."""
    rng = np.random.default_rng(15)
    codes = _codes(rng, 40, width=12, bits=2)
    local = AMService(device=CPU)
    sharded = AMService(mesh=LocalMesh((2, 4), ("data", "model")),
                        device=CPU)
    for svc in (local, sharded):
        svc.create_table("t", width=12, bits=2, capacity=64, policy="lru",
                         backend="cuda")
        svc.append("t", codes, values=list(range(40)))
    queries = [codes[i] for i in (3, 9, 9, 30)] + [_codes(rng, 1, 12, 2)[0]]
    for kw in ({"k": 5}, {"matches": 6, "threshold": 4.0}):
        fl = [local.submit("t", q, **kw) for q in queries]
        fs = [sharded.submit("t", q, **kw) for q in queries]
        local.flush(), sharded.flush()
        for a, b in zip(fl, fs):
            ra, rb = a.result(), b.result()
            np.testing.assert_array_equal(ra.indices, rb.indices)
            np.testing.assert_array_equal(ra.distances, rb.distances)
            assert ra.match_count == rb.match_count
            assert ra.overflow == rb.overflow


def test_service_sharded_with_index():
    mesh = LocalMesh((8,), ("model",))
    rng = np.random.default_rng(21)
    svc = AMService(mesh=mesh, device=CPU)
    svc.create_table("t", width=8, capacity=128,
                     index=IndexSpec(sets=6, probes=2))
    codes = rng.integers(0, 8, size=(80, 8))
    svc.append("t", codes, values=[f"v{i}" for i in range(80)])
    r = svc.lookup("t", codes[33], k=2)
    assert r.hit and r.best_row == 33 and r.value == "v33"
    assert svc.stats()["sharded"] and svc.stats("t")["index"]["built"]


@pytest.mark.parametrize("flags", [["--am-sharded"],
                                   ["--am-sharded", "--am-merge", "tree"],
                                   ["--am-merge", "ring"]])
def test_am_sharded_flags_parse_as_the_reference(flags):
    ours = launch_serve.parse_args(flags + ["--device", "cpu"])
    ref = ref_serve.parse_args(flags)
    assert (ours.am_sharded, ours.am_merge) == (ref.am_sharded, ref.am_merge)
    svc = launch_serve.build_cache_service(ours, start_driver=False)
    s = svc.stats()
    assert s["sharded"] == ours.am_sharded and s["merge"] == ours.am_merge
    with pytest.raises(SystemExit):
        launch_serve.parse_args(["--am-merge", "mesh"])


def test_serving_driver_sharded_cache(capsys):
    out = launch_serve.main(["--device", "cpu", "--am-sharded",
                             "--am-merge", "ring"])
    assert sorted(out["results"]) == list(range(6))
    assert out["cache"]["hits"] > 0
    assert "AM cache [sharded/ring]" in capsys.readouterr().out
