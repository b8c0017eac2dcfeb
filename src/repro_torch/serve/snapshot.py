"""Durable table snapshots + warm restart for :class:`~repro_torch.serve.AMService`.

Port of :mod:`repro.serve.snapshot`, in its on-disk format: a snapshot
written by either package restores in the other.  A snapshot serialises
every table's full state — code slab, serving meta, ternary care plane,
host payloads, live-row count, the built IVF tier and the
admission/eviction config — through
:class:`repro_torch.checkpoint.Checkpointer` (atomic per-table commits,
keep-last-k versioning), and a restore rebuilds an equivalent service from
it, on any device and optionally onto a mesh with another bank count.

Layout on disk::

    <dir>/service.json                       # commit point: step + config
    <dir>/tables/<name>/step_<n>/leaf_*.npy  # one Checkpointer per table
    <dir>/tables/<name>/step_<n>/manifest.json

Consistency contract:

* :func:`snapshot_service` first quiesces through ``AMService.drain()``:
  every in-flight group retires and every queued lookup resolves, so any
  append acknowledged before the call is in the snapshot.
* **Capture copies.**  ``append`` writes the slab in place, so holding the
  planes would let a later append tear the snapshot.  Under the service
  lock each plane (codes, meta, care) is cloned on its device, and on a GPU
  the device is synchronised before the first clone and after the last:
  every acknowledged write is in, and no later one can reach the copy.
  The index arrays are never written in place and are held as they are.
  The copy to the host and the serialisation (the slow part) run outside
  the lock.  At 2^20 × 256 int32 a clone moves 2 GiB of HBM.
* Each table commits atomically via the Checkpointer's tmp-dir rename;
  ``service.json`` is written (atomically) *last*, naming the step, so a
  crash mid-snapshot leaves the previous ``service.json`` pointing at the
  previous, still-retained step.  ``keep`` must therefore be >= 2.
* :func:`restore_service` rebuilds the tables on the service's device.  On
  a mesh the spec tree of ``Rules.am_state()`` is checked against it
  (:func:`repro_torch.checkpoint.elastic.reshard_restore`) and the full
  slabs are banked by the search as row views, so any bank count works
  and results are bitwise the snapshotted service's.
* Host payloads (``values``) ride the same atomic commit as a pickled
  (protocol 4, a plain list) uint8 leaf; restore refuses manifests whose
  ``n``/``values`` accounting disagrees.

The per-table manifest ``metadata`` dict is a versioned contract
(:data:`SNAPSHOT_FORMAT`) whose field set is :data:`MANIFEST_FIELDS`, the
reference's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import pickle
import time
import urllib.parse
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import elastic
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import am
from repro_torch.index import ivf
from repro_torch.index.ivf import IndexSpec

#: Snapshot manifest format version; restore refuses any other value.
SNAPSHOT_FORMAT = 1

#: The per-table manifest metadata contract: field -> invariant.  Every
#: field is present in every manifest this module writes.
MANIFEST_FIELDS = {
    "format": "== SNAPSHOT_FORMAT; restore refuses unknown versions",
    "table": "the table's service name (also its directory, URL-quoted)",
    "n": "live rows; 0 <= n <= capacity",
    "capacity": "slab rows; codes leaf shape is (capacity, width)",
    "width": "word width D in symbols",
    "bits": "bits per stored symbol (static table aux)",
    "distance": "distance metric, one of am.DISTANCES",
    "policy": "eviction policy, one of am_service.POLICIES",
    "ttl": "TTL in clock units; set iff policy == 'ttl'",
    "backend": "default search backend (am.get_backend-resolvable)",
    "ternary": "True iff a care plane leaf is present",
    "version": "table mutation counter at capture (monotone per table)",
    "clock": "service clock at capture; restore resumes from it",
    "admission": "qps_budget / burst / max_queue / mode sub-dict",
    "values_bytes": "byte length of the pickled payload leaf",
    "index_spec": "IndexSpec fields, or null for unindexed tables",
    "index_built": "True iff the five IVF index leaves are present",
    "index_shape": "sets / set_capacity of the built index, else null",
    "app": "caller-owned dict (snapshot(app=...)); opaque to restore",
}

#: Keys of the five IVF index arrays inside the state tree's ``index`` dict.
INDEX_KEYS = ("centroids", "slabs", "row_ids", "set_sizes", "set_radius")


def _table_dir(root: pathlib.Path, name: str) -> pathlib.Path:
    return root / "tables" / urllib.parse.quote(name, safe="")


def read_service_manifest(directory: str | os.PathLike) -> dict:
    """The committed ``service.json`` of a snapshot directory."""
    p = pathlib.Path(directory) / "service.json"
    if not p.exists():
        raise FileNotFoundError(f"no snapshot committed under {directory!r} "
                                "(service.json missing)")
    manifest = json.loads(p.read_text())
    if manifest.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(
            f"snapshot format {manifest.get('format')!r} != "
            f"{SNAPSHOT_FORMAT} (this build)")
    return manifest


def table_manifest(directory: str | os.PathLike, name: str,
                   step: int | None = None) -> dict:
    """One table's checkpoint manifest ``metadata`` dict at ``step``.

    ``step=None`` reads the step committed by ``service.json`` (not the
    table's latest: a crash mid-snapshot can leave a newer, uncommitted
    per-table step behind).
    """
    if step is None:
        step = read_service_manifest(directory)["step"]
    ckpt = Checkpointer(_table_dir(pathlib.Path(directory), name))
    return ckpt.manifest(step)["metadata"]


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------

def _capture_table(t) -> tuple[dict, dict]:
    """Service lock held: one table's (state tree, manifest metadata).

    The slab planes are cloned (``append`` writes them in place); the
    index arrays are immutable and held as they are.
    """
    payload = pickle.dumps(list(t.values), protocol=4)
    state: dict[str, Any] = {
        "codes": t.table.codes.clone(),
        "meta": t.table.meta.clone(),
        "values": np.frombuffer(payload, np.uint8).copy(),
    }
    if t.table.care is not None:
        state["care"] = t.table.care.clone()
    if t.index is not None:
        state["index"] = {k: getattr(t.index, k) for k in INDEX_KEYS}
    metadata = {
        "format": SNAPSHOT_FORMAT,
        "table": t.name,
        "n": int(t.n),
        "capacity": int(t.capacity),
        "width": int(t.table.width),
        "bits": int(t.table.bits),
        "distance": t.table.distance,
        "policy": t.policy,
        "ttl": t.ttl,
        "backend": t.backend,
        "ternary": t.table.care is not None,
        "version": int(t.version),
        "clock": 0.0,                     # stamped by snapshot_service
        "admission": {
            "qps_budget": t.qps_budget,
            "burst": t.burst,
            "max_queue": t.max_queue,
            "mode": t.admission,
        },
        "values_bytes": len(payload),
        "index_spec": (None if t.index_spec is None
                       else dataclasses.asdict(t.index_spec)),
        "index_built": t.index is not None,
        "index_shape": (None if t.index is None else
                        {"sets": int(t.index.sets),
                         "set_capacity": int(t.index.set_capacity)}),
        "app": {},                        # stamped by snapshot_service
    }
    return state, metadata


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def snapshot_service(svc, directory: str | os.PathLike, *,
                     step: int | None = None, keep: int = 2,
                     app: dict | None = None,
                     drain_timeout: float | None = 60.0) -> int:
    """Quiesce ``svc`` and commit one snapshot of every table; returns step.

    Drains first, copies all table state under the service lock (a
    consistent cut: acknowledged appends are included, later ones are
    not), then serialises outside the lock — one atomic Checkpointer commit
    per table, ``service.json`` written last as the cross-table commit
    point.  ``keep`` (>= 2) snapshots are retained per table.  ``app`` is
    an arbitrary JSON-safe dict stored in every manifest (and
    ``service.json``) for the caller — e.g. replicated-log positions.

    The seconds of the two stages land in ``svc._last_snapshot``
    (``drain_capture_s``: drain and the copy under the lock;
    ``write_s``: the copy to the host, the files and their fsyncs).
    """
    if keep < 2:
        raise ValueError(
            f"keep must be >= 2 (got {keep}): the previously committed "
            "step must survive one in-progress snapshot, or a crash "
            "between a table commit and service.json strands the restore")
    t0 = time.perf_counter()
    if not svc.drain(drain_timeout):
        raise RuntimeError(
            f"AMService.drain() did not quiesce within {drain_timeout}s; "
            "snapshot would not be driver-consistent")
    root = pathlib.Path(directory)
    root.mkdir(parents=True, exist_ok=True)
    if step is None:
        try:
            step = read_service_manifest(root)["step"] + 1
        except FileNotFoundError:
            step = 1
    app = dict(app or {})
    with svc._lock:
        _sync(svc.device)             # acknowledged writes have landed
        clock = svc._now()
        captured = []
        for name, t in svc._tables.items():
            state, metadata = _capture_table(t)
            metadata["clock"] = float(clock)
            metadata["app"] = app
            captured.append((name, state, metadata))
        _sync(svc.device)             # the copies are complete
    t1 = time.perf_counter()
    for name, state, metadata in captured:
        ckpt = Checkpointer(_table_dir(root, name), keep=keep)
        ckpt.save(step, state, metadata)
    service = {
        "format": SNAPSHOT_FORMAT,
        "step": step,
        "tables": [name for name, _, _ in captured],
        "merge": svc._merge,
        "max_batch": svc.max_batch,
        "flush_after": svc.flush_after,
        "clock": float(clock),
        "app": app,
    }
    tmp = root / ".tmp-service.json"
    with open(tmp, "w") as f:
        json.dump(service, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, root / "service.json")
    svc._last_snapshot = {"step": step, "drain_capture_s": t1 - t0,
                          "write_s": time.perf_counter() - t1}
    return step


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------

def _template(md: dict) -> dict:
    """Shape-only template (``"meta"``-device tensors) of one table's
    saved state tree."""
    def shape(*s):
        return torch.empty(s, device="meta")

    cap, width = md["capacity"], md["width"]
    tpl: dict[str, Any] = {"codes": shape(cap, width), "meta": shape(cap, 2),
                           "values": shape(md["values_bytes"])}
    if md["ternary"]:
        tpl["care"] = shape(cap, width)
    if md["index_built"]:
        s, c = md["index_shape"]["sets"], md["index_shape"]["set_capacity"]
        tpl["index"] = {"centroids": shape(s, width),
                        "slabs": shape(s, c, width), "row_ids": shape(s, c),
                        "set_sizes": shape(s), "set_radius": shape(s)}
    return tpl


def _restore_table(svc, root: pathlib.Path, name: str, step: int) -> None:
    """Load one table's checkpoint into ``svc`` on its device."""
    from repro_torch.serve import am_service

    ckpt = Checkpointer(_table_dir(root, name))
    md = ckpt.manifest(step)["metadata"]
    if md.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"table {name!r}: snapshot format "
                         f"{md.get('format')!r} != {SNAPSHOT_FORMAT}")
    tpl = _template(md)
    if svc._mesh is not None:
        spec_tree = svc._rules.am_state(ternary=md["ternary"],
                                        indexed=md["index_built"])
        state, _ = elastic.reshard_restore(ckpt, tpl, spec_tree, svc._mesh,
                                           step=step, device=svc.device)
    else:
        state, _ = ckpt.restore(tpl, step=step, device=svc.device)

    values = pickle.loads(state["values"].cpu().numpy().tobytes())
    n = int(md["n"])
    if not 0 <= n <= md["capacity"] or len(values) != n:
        raise ValueError(
            f"table {name!r}: inconsistent manifest — n={n}, "
            f"capacity={md['capacity']}, {len(values)} payloads")
    table = am.AMTable(codes=state["codes"], meta=state["meta"],
                       care=state.get("care"), bits=md["bits"],
                       distance=md["distance"])
    index = None
    if md["index_built"]:
        index = ivf.IVFIndex(**{k: state["index"][k] for k in INDEX_KEYS},
                             bits=md["bits"], distance=md["distance"])
    spec = (None if md["index_spec"] is None
            else IndexSpec(**md["index_spec"]))
    adm = md["admission"]
    svc._tables[name] = am_service._TableState(
        name=name, table=table, n=n, capacity=md["capacity"],
        policy=md["policy"], ttl=md["ttl"], backend=md["backend"],
        values=values, version=md["version"],
        qps_budget=adm["qps_budget"], burst=adm["burst"],
        max_queue=adm["max_queue"], admission=adm["mode"],
        tokens=adm["burst"], tokens_at=svc._now(),
        index_spec=spec, index=index)


def restore_service(directory: str | os.PathLike, *, mesh=None, rules=None,
                    step: int | None = None, time_fn=None,
                    merge: str | None = None, max_batch: int | None = None,
                    flush_after: float | None = None, device=None):
    """Rebuild an :class:`~repro_torch.serve.AMService` from a snapshot.

    ``mesh`` may differ (in bank count, or presence) from the one the
    snapshot was taken on — the elastic warm restart; search results stay
    bitwise the snapshotted service's.  ``merge`` / ``max_batch`` default
    to the snapshotted service config; ``flush_after`` is only restored
    when a real ``time_fn`` is supplied.  The service clock resumes from
    the snapshotted reading, so restored LRU/TTL timestamps stay ordered
    against post-restore traffic.  ``device``: where the tables go
    (``None`` means the GPU, and raises without one).
    """
    from repro_torch.serve.am_service import AMService

    root = pathlib.Path(directory)
    manifest = read_service_manifest(root)
    if step is None:
        step = manifest["step"]
    restored_deadline = manifest["flush_after"] if time_fn is not None \
        else None
    svc = AMService(
        mesh=mesh, rules=rules,
        merge=manifest["merge"] if merge is None else merge,
        max_batch=manifest["max_batch"] if max_batch is None else max_batch,
        flush_after=(restored_deadline if flush_after is None
                     else flush_after),
        time_fn=time_fn, device=device)
    for name in manifest["tables"]:
        _restore_table(svc, root, name, step)
    clock = float(manifest["clock"])
    if time_fn is None:
        svc._clock = clock
    else:
        # rebase the wall epoch so _now() continues from the saved reading
        svc._epoch = float(time_fn()) - clock
    for t in svc._tables.values():
        t.tokens_at = svc._now()
    return svc
