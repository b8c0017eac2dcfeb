"""The port's Checkpointer: round trips, concurrency and the shared format.

Mirrors ``tests/test_checkpoint.py`` on
:class:`repro_torch.checkpoint.Checkpointer` (the reference's ``shardings``
trees become the spec trees of :func:`repro_torch.checkpoint.elastic.
reshard_restore`, matched to the template by key path the same way), then
holds the format to the reference's in both directions on the same numpy
inputs: a checkpoint written by either package restores in the other bit
for bit (bfloat16 included), and the two manifests of the same tree are
equal.  All on the CPU.
"""

import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.core import am as ref_am
from repro_torch.checkpoint import Checkpointer, reshard_restore
from repro_torch.core import am
from repro_torch.dist import LocalMesh

torch.set_num_threads(2)

CPU = "cpu"


def _planes(seed, rows, width, *, with_meta, with_care, bits=3):
    r = np.random.default_rng(seed)
    codes = r.integers(0, 2 ** bits, (rows, width)).astype(np.int32)
    meta = r.normal(size=(rows, 2)).astype(np.float32) if with_meta else None
    care = (r.integers(0, 2, (rows, width)).astype(np.int32)
            if with_care else None)
    return codes, meta, care


def _table(seed, rows, width, *, with_meta, with_care, bits=3):
    codes, meta, care = _planes(seed, rows, width, with_meta=with_meta,
                                with_care=with_care, bits=bits)
    return am.make_table(codes, bits=bits, meta=meta, care_mask=care,
                         device=CPU)


def _assert_tables_equal(a, b):
    assert np.array_equal(np.asarray(a.codes), np.asarray(b.codes))
    for child in ("meta", "care"):
        x, y = getattr(a, child), getattr(b, child)
        assert (x is None) == (y is None), child
        if x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y)), child
    assert a.bits == b.bits and a.distance == b.distance


# ---------------------------------------------------------------------------
# optional-children round trips
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(rows=st.integers(min_value=0, max_value=33),
       width=st.integers(min_value=1, max_value=9),
       with_meta=st.booleans(), with_care=st.booleans(),
       seed=st.integers(min_value=0, max_value=2 ** 31))
def test_amtable_roundtrip_optional_children(rows, width, with_meta,
                                             with_care, seed):
    """Same-structure restore is exact for every optional-child combo."""
    t = _table(seed, rows, width, with_meta=with_meta, with_care=with_care)
    with tempfile.TemporaryDirectory() as d:
        ckpt = Checkpointer(d)
        ckpt.save(1, t, {"rows": rows})
        restored, md = ckpt.restore(
            _table(seed + 1, rows, width, with_meta=with_meta,
                   with_care=with_care), device=CPU)
    assert md == {"rows": rows}
    assert isinstance(restored, am.AMTable)
    _assert_tables_equal(restored, t)


def test_keyed_manifest_paths(tmp_path):
    """AMTable manifests name leaves by field, stable across None children;
    dicts by sorted key, sequences by position."""
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, _table(0, 4, 3, with_meta=True, with_care=True))
    paths = [e["path"] for e in ckpt.manifest(1)["leaves"]]
    assert paths == [".codes", ".meta", ".care"]
    ckpt.save(2, _table(0, 4, 3, with_meta=False, with_care=True))
    assert [e["path"] for e in ckpt.manifest(2)["leaves"]] == \
        [".codes", ".care"]
    tree = {"meta": np.zeros(2), "codes": np.zeros(3),
            "index": {"slabs": np.zeros(1), "centroids": np.zeros(1)},
            "care": [_table(0, 2, 2, with_meta=False, with_care=False),
                     (np.zeros(1), None, np.ones(1))]}
    ckpt.save(3, tree)
    assert [e["path"] for e in ckpt.manifest(3)["leaves"]] == [
        "['care']/[0]/.codes", "['care']/[1]/[0]", "['care']/[1]/[2]",
        "['codes']", "['index']/['centroids']", "['index']/['slabs']",
        "['meta']"]


def test_restore_into_none_template_raises_strict(tmp_path):
    """A checkpoint WITH meta/care must not silently restore into a
    template WITHOUT them — that drops saved state."""
    ckpt = Checkpointer(tmp_path)
    full = _table(1, 8, 4, with_meta=True, with_care=True)
    ckpt.save(1, full)
    bare = _table(2, 8, 4, with_meta=False, with_care=False)
    with pytest.raises(ValueError, match=r"\.care.*\.meta|\.meta.*\.care"):
        ckpt.restore(bare, device=CPU)
    # explicit opt-out restores the template's subset
    got, _ = ckpt.restore(bare, strict=False, device=CPU)
    assert got.meta is None and got.care is None
    assert np.array_equal(np.asarray(got.codes), np.asarray(full.codes))


def test_restore_missing_leaf_raises(tmp_path):
    """Template wants a child the checkpoint never saved -> KeyError."""
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, _table(1, 8, 4, with_meta=False, with_care=False))
    with pytest.raises(KeyError, match=r"\.meta"):
        ckpt.restore(_table(2, 8, 4, with_meta=True, with_care=False),
                     device=CPU)


def test_empty_table_roundtrip(tmp_path):
    """n=0 tables (zero-row slabs) checkpoint and restore losslessly."""
    t = _table(3, 0, 5, with_meta=True, with_care=True)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, t)
    restored, _ = ckpt.restore(_table(4, 0, 5, with_meta=True,
                                      with_care=True), device=CPU)
    _assert_tables_equal(restored, t)
    assert tuple(restored.codes.shape) == (0, 5)


def test_spec_tree_with_none_entries(tmp_path):
    """A spec tree carrying None leaves maps by key path: a spec at
    ``.care`` is checked against ``.care`` alone, never zipped onto
    ``.codes`` (the reference's sharding-tree case)."""
    mesh = LocalMesh((2,), ("model",))
    t = _table(5, 8, 4, with_meta=True, with_care=True)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, t)
    template = _table(6, 8, 4, with_meta=True, with_care=True)
    specs = am.AMTable(codes=None, meta=None, care=("model", None),
                       bits=t.bits, distance=t.distance)
    restored, _ = reshard_restore(ckpt, template, specs, mesh, device=CPU)
    _assert_tables_equal(restored, t)
    # a spec that does not fit its own leaf is refused, naming the path
    bad = am.AMTable(codes=None, meta=None, care=("model", None, None),
                     bits=t.bits, distance=t.distance)
    with pytest.raises(ValueError, match=r"\.care.*3 entries"):
        reshard_restore(ckpt, template, bad, mesh, device=CPU)
    bad = am.AMTable(codes=None, meta=("data", None), care=None,
                     bits=t.bits, distance=t.distance)
    with pytest.raises(ValueError, match=r"\.meta.*\['data'\]"):
        reshard_restore(ckpt, template, bad, mesh, device=CPU)


def test_spec_subtree_dict(tmp_path):
    """Nested dict states accept a partial spec dict (subset of keys)."""
    mesh = LocalMesh((2,), ("model",))
    state = {"codes": np.arange(12, dtype=np.int32).reshape(6, 2),
             "aux": {"values": np.arange(5, dtype=np.uint8)}}
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, state)
    got, _ = reshard_restore(
        ckpt, {"codes": np.zeros((6, 2), np.int32),
               "aux": {"values": np.zeros((5,), np.uint8)}},
        {"codes": ("model", None), "aux": {"values": None}}, mesh,
        device=CPU)
    assert np.array_equal(got["codes"].numpy(), state["codes"])
    assert got["codes"].dtype == torch.int32
    assert np.array_equal(got["aux"]["values"].numpy(),
                          state["aux"]["values"])


def test_bfloat16_leaf_roundtrip(tmp_path):
    """bf16 meta survives the uint16-view detour."""
    meta = torch.arange(8, dtype=torch.bfloat16).reshape(4, 2)
    t = am.make_table(np.zeros((4, 3), np.int32), meta=meta, device=CPU)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, t)
    entry = ckpt.manifest(1)["leaves"][1]
    assert entry["path"] == ".meta" and entry["dtype"] == "bfloat16"
    restored, _ = ckpt.restore(
        am.make_table(np.ones((4, 3), np.int32),
                      meta=torch.zeros((4, 2), dtype=torch.bfloat16),
                      device=CPU), device=CPU)
    assert restored.meta.dtype == torch.bfloat16
    assert torch.equal(restored.meta, meta)


# ---------------------------------------------------------------------------
# save_async / wait / GC interleavings
# ---------------------------------------------------------------------------

def test_gc_keep1_does_not_delete_inflight_async_step(tmp_path):
    """keep=1 with an async save in flight: the step being written commits
    intact and the GC only ever removes *older* committed steps."""
    ckpt = Checkpointer(tmp_path, keep=1)
    trees = {s: {"x": np.full((64, 64), s, np.int32)} for s in range(1, 6)}
    for s in range(1, 6):
        ckpt.save_async(s, trees[s])
    ckpt.wait()
    assert ckpt.all_steps() == [5]
    got, _ = ckpt.restore({"x": np.zeros((64, 64), np.int32)}, device=CPU)
    assert np.array_equal(got["x"].numpy(), trees[5]["x"])


def test_sync_save_joins_inflight_async(tmp_path):
    """save() after save_async() must not interleave two writers in one tmp
    dir — both steps commit with their own leaves under their own manifest;
    and save_async's copy is taken before it returns (the slab is written
    in place right after)."""
    ckpt = Checkpointer(tmp_path, keep=8)
    slab = torch.full((128, 128), 7, dtype=torch.int32)
    b = {"x": np.full((128, 128), 9, np.int32)}
    ckpt.save_async(1, {"x": slab})
    slab[:] = 8                   # in place, as AMService.append writes
    ckpt.save(2, b)        # same-tick overlap: must serialise behind step 1
    assert ckpt.all_steps() == [1, 2]
    for step, want in ((1, 7), (2, 9)):
        got, _ = ckpt.restore({"x": np.zeros((128, 128), np.int32)},
                              step=step, device=CPU)
        assert (got["x"] == want).all(), step


def test_concurrent_restore_never_sees_gced_step(tmp_path):
    """Readers racing writers+GC always get a complete, uncorrupted step."""
    ckpt = Checkpointer(tmp_path, keep=2)
    ckpt.save(0, {"x": np.full((32, 32), 0, np.int32)})
    errors = []
    stop = threading.Event()

    def reader():
        tpl = {"x": np.zeros((32, 32), np.int32)}
        while not stop.is_set():
            try:
                got, _ = ckpt.restore(tpl, device=CPU)   # latest committed
                arr = got["x"].numpy()
                if not (arr == arr.flat[0]).all():
                    errors.append(f"torn read: {arr.flat[:4]}")
            except Exception as e:               # noqa: BLE001
                errors.append(repr(e))

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for s in range(1, 20):
        ckpt.save_async(s, {"x": np.full((32, 32), s, np.int32)})
    ckpt.wait()
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors[:3]
    assert ckpt.all_steps() == [18, 19]


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=999))
def test_wait_idempotent_across_threads(seed):
    """Concurrent wait() calls all join the same writer without racing the
    thread-slot clear."""
    with tempfile.TemporaryDirectory() as d:
        ckpt = Checkpointer(d)
        ckpt.save_async(seed, {"x": np.full((256, 64), seed, np.int32)})
        waiters = [threading.Thread(target=ckpt.wait) for _ in range(4)]
        for t in waiters:
            t.start()
        ckpt.wait()
        for t in waiters:
            t.join(timeout=30)
            assert not t.is_alive()
        assert ckpt._thread is None
        assert ckpt.all_steps() == [seed]


# ---------------------------------------------------------------------------
# the shared on-disk format, both directions
# ---------------------------------------------------------------------------

def test_no_card_means_an_error_not_the_cpu(tmp_path, monkeypatch):
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, {"x": np.zeros(3, np.int32)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore({"x": np.zeros(3, np.int32)})


@pytest.mark.parametrize("with_meta,with_care", [(True, True), (True, False),
                                                 (False, True)])
def test_amtable_checkpoints_cross_packages(tmp_path, with_meta, with_care):
    """Each package restores the other's AMTable checkpoint exactly, and
    the two manifests of the same table are equal."""
    codes, meta, care = _planes(11, 9, 5, with_meta=with_meta,
                                with_care=with_care)
    ours = am.make_table(codes, meta=meta, care_mask=care, device=CPU)
    ref = ref_am.make_table(codes, meta=meta, care_mask=care)
    Checkpointer(tmp_path / "ours").save(3, ours, {"k": [1, 2]})
    RefCheckpointer(tmp_path / "ref").save(3, ref, {"k": [1, 2]})
    assert Checkpointer(tmp_path / "ours").manifest(3) == \
        RefCheckpointer(tmp_path / "ref").manifest(3)
    for name in ("leaf_0.npy", "manifest.json"):
        assert (tmp_path / "ours/step_00000003" / name).read_bytes() == \
            (tmp_path / "ref/step_00000003" / name).read_bytes()
    got, md = Checkpointer(tmp_path / "ref").restore(ours, device=CPU)
    assert md == {"k": [1, 2]}
    _assert_tables_equal(got, ours)
    got, _ = RefCheckpointer(tmp_path / "ours").restore(ref)
    _assert_tables_equal(got, ref)


def test_bfloat16_bit_for_bit_both_directions(tmp_path):
    """A bf16 leaf crosses between the packages with every bit kept,
    NaN and subnormal patterns included."""
    bits = np.random.default_rng(3).integers(0, 1 << 16, 64, dtype=np.uint16)
    bits[:3] = (0x7FC1, 0x0001, 0x8000)          # a NaN payload, tiny, -0
    ours = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    ref = jnp.asarray(bits.view(jnp.bfloat16))
    Checkpointer(tmp_path / "ours").save(1, {"w": ours})
    RefCheckpointer(tmp_path / "ref").save(1, {"w": ref})
    assert (tmp_path / "ours/step_00000001/leaf_0.npy").read_bytes() == \
        (tmp_path / "ref/step_00000001/leaf_0.npy").read_bytes()
    got, _ = Checkpointer(tmp_path / "ref").restore({"w": ours}, device=CPU)
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy().view(np.uint16),
                          bits)
    back, _ = RefCheckpointer(tmp_path / "ours").restore({"w": ref})
    assert back["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back["w"]).view(np.uint16), bits)
