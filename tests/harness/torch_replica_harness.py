"""Multi-replica fault-injection harness for the port's AMService durability.

Port of ``tests/harness/replica_harness.py``: the replicas import
``repro_torch`` alone (never ``jax`` or ``repro``), serve on ``--device``
(the GPU unless told otherwise; ``cpu`` under pytest) with their torch
threads capped at 1, and a replica of ``--banks B`` banks its tables over
a ``LocalMesh((B,), ("model",))``.  Everything else is the reference's.

Simbricks-style orchestration: N *subprocess* service replicas (real
process boundaries — a kill is ``SIGKILL``, not a mock) driven by a
Zipfian / bursty / multi-tenant trace through scripted kill / restore /
reshard events, checked against an uninterrupted reference replica.

Topology::

    orchestrator ──JSONL/stdio──> reference replica   (never killed)
                 ──JSONL/stdio──> target replica(s)   (killed, restored onto
                                                       other bank counts)

Protocol (one JSON object per line, request -> response):

    {"op": "create", "table": t, "width": w, "capacity": c, ...}
    {"op": "append", "table": t, "seq": n, "code": [...], "value": v}
    {"op": "sync"}                  # snapshot; returns the committed step
    {"op": "query", "table": t, "codes": [[...]], "k": k}
    {"op": "burst", "table": t, "codes": [[...]]}   # peak-queue probe
    {"op": "applied"} / {"op": "stats"} / {"op": "quit"}

Durability semantics under test:

* **Acknowledged = covered by a committed snapshot.**  ``append`` acks are
  process-memory only; the orchestrator treats a write as durable once a
  later ``sync`` response arrives (the snapshot drained and committed it).
  After a kill the orchestrator *replays* every unacknowledged append —
  replicas deduplicate via a per-table ``applied_seq`` high-water mark
  carried inside the snapshot (``app=`` manifest field), so replay is
  exactly-once even when the kill landed after the append applied.
* Appends carry ``now=seq`` (the trace's logical position), so LRU meta is
  a pure function of the trace — a restored replica and the never-killed
  reference agree on every timestamp without sharing a clock.
* Assertions: (a) zero lost acknowledged writes (replay closes the gap,
  the final per-table ``applied`` watermark and row count match the
  reference); (b) post-restore ``query`` responses JSON-identical to the
  reference, on every scripted bank count (1/2/4 — ``search_sharded``'s
  bitwise contract); (c) recovery queue depth stays bounded: a burst
  submitted immediately after restore never queues deeper than the
  offered load and fully resolves.

CLI::

    python tests/harness/torch_replica_harness.py --smoke --device cpu
    python tests/harness/torch_replica_harness.py            # on the GPU
    python tests/harness/torch_replica_harness.py --replica --workdir D \
        --banks 2 --device cpu

``tests/test_torch_replica_harness.py`` runs the full scenario under
pytest.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
WIDTH = 16
BITS = 3


# ---------------------------------------------------------------------------
# Replica process (the --replica entry point)
# ---------------------------------------------------------------------------

def run_replica(workdir: str, banks: int, restore: bool,
                device: str | None) -> None:
    """Serve the JSONL protocol on stdio until ``quit`` (or EOF/SIGKILL)."""
    import numpy as np
    import torch

    from repro_torch.dist import LocalMesh
    from repro_torch.serve import AMService, read_service_manifest

    torch.set_num_threads(1)
    mesh = LocalMesh((banks,), ("model",)) if banks else None

    applied: dict[str, int] = {}      # per-table applied-seq high-water mark
    svc = None
    if restore and (pathlib.Path(workdir) / "service.json").exists():
        svc = AMService.restore(workdir, mesh=mesh, device=device)
        applied = dict(read_service_manifest(workdir)["app"]
                       .get("applied_seq", {}))
    if svc is None:
        svc = AMService(mesh=mesh, max_batch=32, device=device)

    out = sys.stdout
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        req = json.loads(line)
        op = req["op"]
        if op == "quit":
            print(json.dumps({"ok": True}), file=out, flush=True)
            break
        try:
            if op == "create":
                if req["table"] not in svc._tables:   # replay-safe
                    svc.create_table(
                        req["table"], width=req.get("width", WIDTH),
                        bits=req.get("bits", BITS),
                        capacity=req["capacity"],
                        policy=req.get("policy", "lru"))
                    applied.setdefault(req["table"], -1)
                resp = {"ok": True}
            elif op == "append":
                t, seq = req["table"], req["seq"]
                if seq > applied.get(t, -1):          # exactly-once replay
                    svc.append(t, np.asarray([req["code"]], np.int32),
                               values=[req["value"]], now=float(seq))
                    applied[t] = seq
                resp = {"ok": True, "applied": applied[t]}
            elif op == "sync":
                step = svc.snapshot(workdir,
                                    app={"applied_seq": dict(applied)})
                resp = {"ok": True, "step": step,
                        "applied": dict(applied)}
            elif op == "query":
                qs = np.asarray(req["codes"], np.int32)
                futs = [svc.submit(req["table"], q, k=req.get("k", 3))
                        for q in qs]
                svc.flush()
                results = []
                for f in futs:
                    r = f.result(timeout=60.0)
                    results.append({
                        "indices": np.asarray(r.indices).tolist(),
                        "distances": [float(x) for x in
                                      np.asarray(r.distances)],
                        "exact": np.asarray(r.exact).tolist(),
                        "value": r.value,
                    })
                resp = {"ok": True, "results": results}
            elif op == "burst":
                qs = np.asarray(req["codes"], np.int32)
                futs, peak = [], 0
                for q in qs:
                    futs.append(svc.submit(req["table"], q, k=1))
                    peak = max(peak, svc.stats()["queue_depth"])
                svc.flush()
                for f in futs:
                    f.result(timeout=60.0)
                resp = {"ok": True, "peak_queue": peak,
                        "resolved": len(futs)}
            elif op == "applied":
                resp = {"ok": True, "applied": dict(applied)}
            elif op == "stats":
                s = svc.stats()
                resp = {"ok": True, "queue_depth": s["queue_depth"],
                        "sharded": s["sharded"],
                        "rows": {n: s["tables"][n]["rows"]
                                 for n in s["tables"]}}
            else:
                resp = {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as e:                        # noqa: BLE001
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(resp), file=out, flush=True)


# ---------------------------------------------------------------------------
# Orchestrator side
# ---------------------------------------------------------------------------

class Replica:
    """One subprocess replica + its JSONL pipe and durability bookkeeping."""

    def __init__(self, name: str, workdir: str, banks: int, log,
                 device: str | None = None):
        self.name = name
        self.workdir = workdir
        self.banks = banks
        self.device = device
        self._log = log
        self.acked: dict[str, int] = {}     # per-table durable watermark
        self.unacked: list[dict] = []       # appends since the last sync
        self.tables: list[dict] = []        # create ops, for replay
        self.proc: subprocess.Popen | None = None
        self.spawn(restore=False)

    def spawn(self, *, restore: bool, banks: int | None = None):
        if banks is not None:
            self.banks = banks
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO_ROOT / "src"))
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
               "--replica", "--workdir", self.workdir,
               "--banks", str(self.banks)]
        if restore:
            cmd.append("--restore")
        if self.device is not None:
            cmd += ["--device", self.device]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True,
                                     env=env)
        self.event("spawn", restore=restore, banks=self.banks)

    def event(self, kind: str, **fields):
        self._log.write(json.dumps(
            {"t": time.time(), "replica": self.name, "event": kind,
             **fields}) + "\n")
        self._log.flush()

    def call(self, req: dict, timeout: float = 120.0) -> dict:
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(
                f"replica {self.name} died mid-call "
                f"(rc={self.proc.poll()}): {req['op']}")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise RuntimeError(f"replica {self.name} {req['op']} failed: "
                               f"{resp.get('error')}")
        return resp

    # -- trace ops, with durability bookkeeping ---------------------------

    def create(self, table: str, capacity: int):
        op = {"op": "create", "table": table, "capacity": capacity}
        self.tables.append(op)
        self.acked.setdefault(table, -1)
        return self.call(op)

    def append(self, table: str, seq: int, code, value):
        op = {"op": "append", "table": table, "seq": seq,
              "code": [int(x) for x in code], "value": value}
        resp = self.call(op)
        self.unacked.append(op)         # durable only after the next sync
        return resp

    def sync(self) -> dict:
        resp = self.call({"op": "sync"})
        self.acked = {t: int(s) for t, s in resp["applied"].items()}
        self.unacked = []
        self.event("sync", step=resp["step"], acked=self.acked)
        return resp

    def query(self, table: str, codes, k: int = 3):
        return self.call({"op": "query", "table": table,
                          "codes": [[int(x) for x in c] for c in codes],
                          "k": k})["results"]

    # -- fault injection ---------------------------------------------------

    def kill(self):
        """SIGKILL — the crash the snapshot layer must survive."""
        self.event("kill")
        self.proc.kill()
        self.proc.wait()

    def restore(self, *, banks: int | None = None) -> None:
        """Respawn from the last committed snapshot and replay the gap.

        Everything acknowledged (covered by a sync) comes back from the
        snapshot; everything after it is re-sent in seq order.  The
        replica's ``applied_seq`` watermark makes the replay exactly-once
        even for appends that applied right before the kill.
        """
        reshard = banks is not None and banks != self.banks
        self.spawn(restore=True, banks=banks)
        for op in self.tables:          # replay-safe (create is idempotent)
            self.call(op)
        replayed = 0
        for op in self.unacked:
            self.call(op)
            replayed += 1
        self.event("recovered", replayed=replayed, reshard=reshard)

    def shutdown(self):
        if self.proc and self.proc.poll() is None:
            try:
                self.call({"op": "quit"}, timeout=10.0)
            except Exception:           # noqa: BLE001
                self.proc.kill()
            self.proc.wait()


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------

def make_trace(n_appends: int, n_tables: int, population: int,
               zipf_s: float = 1.2, seed: int = 0):
    """Zipfian multi-tenant append trace + the query set used to compare.

    Returns (appends, queries): appends are (seq, table, code, value)
    tuples, bursty across tables (tenant switches every few ops); queries
    hit both stored codes (exact) and fresh draws (miss/near).
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    ranks = np.arange(1, population + 1, dtype=np.float64)
    probs = ranks ** -zipf_s
    probs /= probs.sum()
    pool = rng.integers(0, 2 ** BITS, (population, WIDTH)).astype(np.int32)
    tables = [f"tenant{i}" for i in range(n_tables)]

    appends = []
    table = 0
    for seq in range(n_appends):
        if rng.random() < 0.2:          # bursty tenant switches
            table = rng.integers(n_tables)
        pid = rng.choice(population, p=probs)
        code = pool[pid].copy()
        code[rng.integers(WIDTH)] = rng.integers(2 ** BITS)   # unique-ish
        appends.append((seq, tables[int(table)], code, f"s{seq}"))

    queries = {}
    for t in tables:
        own = [c for _, tt, c, _ in appends if tt == t]
        qs = [own[i] for i in
              rng.integers(0, len(own), size=min(4, len(own)))]
        qs += [pool[rng.integers(population)] for _ in range(2)]
        queries[t] = qs
    return appends, tables, queries


# ---------------------------------------------------------------------------
# Scenario
# ---------------------------------------------------------------------------

def compare_queries(reference: Replica, target: Replica, tables, queries,
                    *, context: str) -> int:
    """Every query response must be JSON-identical across replicas."""
    checked = 0
    for t in tables:
        ref = reference.query(t, queries[t])
        got = target.query(t, queries[t])
        if ref != got:
            raise AssertionError(
                f"[{context}] replica {target.name} diverged from the "
                f"reference on table {t!r}:\n  ref={ref}\n  got={got}")
        checked += len(ref)
    reference.event("compare_ok", against=target.name, context=context,
                    queries=checked)
    return checked


def run_scenario(*, smoke: bool, log_path: str,
                 device: str | None = None) -> dict:
    """Scripted kill/restore/reshard run; returns the summary dict.

    ``device`` is every replica's (``None``: the GPU)."""
    if smoke:
        n_targets, n_appends, n_tables = 1, 60, 2
        # 2 replicas, 1 kill/restore, 1 reshard (the CI chaos-smoke shape)
        faults = [("kill_restore", 0, None), ("reshard", 0, 4)]
        sync_every = 17     # co-prime with the fault positions: every kill
        # lands mid-sync-interval, so recovery really replays appends
    else:
        n_targets, n_appends, n_tables = 2, 150, 3
        faults = [("kill_restore", 0, None), ("reshard", 1, 4),
                  ("kill_restore", 1, None), ("reshard", 0, 1)]
        sync_every = 23

    appends, tables, queries = make_trace(n_appends, n_tables,
                                          population=64)
    capacity = n_appends + 8            # eviction-free: results are pure
    fault_at = {(i + 1) * len(appends) // (len(faults) + 1): f
                for i, f in enumerate(faults)}

    summary = {"faults": 0, "replayed": 0, "compared": 0, "resharded": 0}
    with tempfile.TemporaryDirectory() as root, \
            open(log_path, "w") as log:
        reference = Replica("reference", os.path.join(root, "ref"),
                            banks=0, log=log, device=device)
        targets = [Replica(f"target{i}", os.path.join(root, f"t{i}"),
                           banks=2, log=log, device=device)
                   for i in range(n_targets)]
        replicas = [reference] + targets
        try:
            for t in tables:
                for r in replicas:
                    r.create(t, capacity)

            for pos, (seq, table, code, value) in enumerate(appends):
                for r in replicas:
                    r.append(table, seq, code, value)
                if (pos + 1) % sync_every == 0:
                    for r in replicas:
                        r.sync()
                fault = fault_at.get(pos + 1)
                if fault is None:
                    continue
                kind, ti, banks = fault
                target = targets[ti]
                if kind == "kill_restore":
                    target.kill()
                    target.restore()
                else:
                    target.sync()       # reshard from a fresh snapshot
                    target.kill()
                    target.restore(banks=banks)
                    summary["resharded"] += 1
                summary["faults"] += 1
                summary["replayed"] += len(target.unacked)
                # (b) bitwise-equal results immediately after recovery
                summary["compared"] += compare_queries(
                    reference, target, tables, queries,
                    context=f"post-{kind}@{pos + 1}")
                # (c) bounded queue depth during recovery
                burst = [[int(x) for x in queries[tables[0]][0]]] * 24
                b = target.call({"op": "burst", "table": tables[0],
                                 "codes": burst})
                assert b["resolved"] == len(burst)
                assert b["peak_queue"] <= len(burst), (
                    f"recovery queue depth {b['peak_queue']} exceeds the "
                    f"offered load {len(burst)}")
                target.event("burst_ok", peak_queue=b["peak_queue"])

            # (a) end-of-trace: no acknowledged write lost anywhere
            want = {t: max((s for s, tt, _, _ in appends if tt == t),
                           default=-1) for t in tables}
            for r in replicas:
                got = r.call({"op": "applied"})["applied"]
                assert {t: int(s) for t, s in got.items()} == want, (
                    f"replica {r.name} lost writes: {got} != {want}")
            for target in targets:
                summary["compared"] += compare_queries(
                    reference, target, tables, queries, context="final")
        finally:
            for r in replicas:
                r.shutdown()
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replica", action="store_true",
                    help="run as a replica subprocess (internal)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--banks", type=int, default=0,
                    help="mesh bank count (0 = unsharded)")
    ap.add_argument("--restore", action="store_true",
                    help="replica: warm-restart from --workdir first")
    ap.add_argument("--smoke", action="store_true",
                    help="orchestrator: 2 replicas, 1 kill/restore, "
                         "1 reshard (CI chaos-smoke)")
    ap.add_argument("--log", default="replica_harness_events.jsonl",
                    help="orchestrator: JSONL event log path")
    ap.add_argument("--device", default=None,
                    help="torch device of every replica (default: the GPU)")
    args = ap.parse_args(argv)

    if args.replica:
        run_replica(args.workdir, args.banks, args.restore, args.device)
        return 0

    summary = run_scenario(smoke=args.smoke, log_path=args.log,
                           device=args.device)
    print(f"chaos {'smoke' if args.smoke else 'full'} PASS: "
          f"{summary['faults']} faults ({summary['resharded']} reshards), "
          f"{summary['replayed']} appends replayed, "
          f"{summary['compared']} query responses compared equal "
          f"(event log: {args.log})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
