"""Mesh-agnostic checkpointing with async save and atomic commit.

Port of :mod:`repro.checkpoint.checkpointer`, writing the same files: a
checkpoint written by either package restores in the other.

* Checkpoints are **logical**: every leaf is stored as the full array, so
  a restore may target another bank count, or no mesh at all (see
  :mod:`repro_torch.checkpoint.elastic`).
* Layout: ``<dir>/step_<n>/leaf_<i>.npy`` + ``manifest.json`` (each leaf's
  key path, file, shape and logical dtype; the step; caller metadata).
  bfloat16 is stored as a uint16 view with logical dtype ``"bfloat16"``
  (npy has no bf16, and neither numpy nor this package has the type: the
  bits go through int16/uint16 views).
* **Atomic commit**: writes go to ``.tmp-step_<n>``; every leaf file and
  the manifest are fsynced, then the directory is renamed, so readers only
  ever see complete checkpoints.  Keep-last-k GC.
* **Async**: ``save_async`` copies every leaf to host memory before it
  returns (a device tensor's copy completes there, and a host tensor or
  array is copied too, since the serving slabs are written in place), then
  serialises on a daemon thread; ``wait()`` joins it.
* **Concurrency contract**: one I/O lock serialises writes, GC and
  restores, and every save first joins an in-flight async write, so two
  writers never share a tmp dir and ``_gc`` never deletes a step while it
  is being written or read.
* Restore reads via ``np.load(mmap_mode="r")`` and places every leaf on
  ``device`` (default the GPU; ``device="cpu"`` keeps it on the host).

Leaf identity is the key path of the target tree, as the strings JAX's
``tree_flatten_with_path`` gives: a dict's keys in sorted order as
``['key']``, a list's or tuple's positions as ``[i]``, and the array
fields of :class:`~repro_torch.core.am.AMTable` and
:class:`~repro_torch.index.ivf.IVFIndex` as ``.codes`` etc., joined by
``/``.  ``None`` children hold no leaf, so the paths stay stable when an
optional plane is absent.  ``restore`` is strict by default: a checkpoint
leaf with no matching leaf in the restore template raises rather than
silently dropping saved state.

A training state (:class:`~repro_torch.train.train_step.TrainState`, its
:class:`~repro_torch.train.optimizer.OptState`) is a tree node too, and
an LM (:class:`~repro_torch.models.transformer.LM`: the weights, the
master weights, the moments, the EF buffers) is walked as the
reference's parameter tree: ``['embed']``, ``['final_norm']/['scale']``
and, for a scanned uniform stack, ``['blocks']/['attn']/['wq']`` holding
the (L, ...) stack of the layers' tensors
(:meth:`~repro_torch.models.transformer.LM.reference_tree`).  Such a
:class:`~repro_torch.models.layers.LayerStack` is stacked on the host
copies a save makes, and a restore unstacks it on the host before each
layer goes to the device, so no stacked copy of a layer's tensors exists
on the card.

An optimizer state sharded over a mesh axis
(:func:`repro_torch.train.optimizer.shard`) is written whole: each
:class:`~repro_torch.train.optimizer.Shard` leaf is gathered from its
slices (an all-gather on a process-group mesh, so every rank of it saves),
and the files are those of the unsharded state.  A restore into a sharded
template splits each leaf as its template is split.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import am
from repro_torch.device import resolve_device
from repro_torch.index import ivf
from repro_torch.models import layers, transformer
from repro_torch.train import optimizer, train_step

BF16 = "bfloat16"

#: Dataclasses that are tree nodes, with their array fields in the order
#: the reference registers them; their other fields are static.
NODE_FIELDS = {
    am.AMTable: ("codes", "meta", "care"),
    ivf.IVFIndex: ("centroids", "slabs", "row_ids", "set_sizes",
                   "set_radius"),
    train_step.TrainState: ("params", "opt", "step", "ef"),
    optimizer.OptState: ("master", "m", "v", "count"),
}


def _children(tree) -> list[tuple[str, Any]] | None:
    """(key string, child) pairs of a tree node; None for a leaf."""
    if isinstance(tree, transformer.LM):
        return _children(tree.reference_tree())
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    fields = NODE_FIELDS.get(type(tree))
    if fields is not None:
        return [(f".{f}", getattr(tree, f)) for f in fields]
    return None


def tree_map_with_path(fn: Callable[[str, Any], Any], tree,
                       is_leaf: Callable[[Any], bool] | None = None,
                       _prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``.

    ``None`` is an empty node and stays ``None``; ``is_leaf`` stops the
    walk at matching subtrees (a spec tuple, say).
    """
    if tree is None:
        return None
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return fn(_prefix, tree)
    out = [tree_map_with_path(fn, x, is_leaf,
                              f"{_prefix}/{k}" if _prefix else k)
           for k, x in kids]
    return _rebuild(tree, out)


def _rebuild(tree, out: list):
    """The node ``tree`` holding the children ``out`` (in the order
    :func:`_children` gives them)."""
    if isinstance(tree, transformer.LM):
        return tree.with_reference_tree(_rebuild(tree.reference_tree(), out))
    if isinstance(tree, dict):
        return {k: v for k, v in zip(sorted(tree), out)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(out)
    return dataclasses.replace(tree, **dict(zip(NODE_FIELDS[type(tree)],
                                                out)))


def leaves_with_paths(tree, is_leaf=None,
                      _prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in flattening order."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(_prefix, tree)]
    return [pair for k, x in kids for pair in leaves_with_paths(
        x, is_leaf, f"{_prefix}/{k}" if _prefix else k)]


def _to_host(x, copy: bool) -> tuple[np.ndarray, str]:
    """(host array as written to disk, logical dtype) of one leaf.

    ``copy`` makes the array independent of ``x`` even where ``x`` already
    lives on the host.  A :class:`~repro_torch.models.layers.LayerStack`
    is stacked here, from its layers' host copies.
    """
    if isinstance(x, layers.LayerStack):
        parts = [_to_host(p, copy=False) for p in x.parts]
        return np.stack([a for a, _ in parts]), parts[0][1]
    if isinstance(x, optimizer.Shard):          # the whole, gathered
        return _to_host(x.full(), copy)
    if isinstance(x, torch.Tensor):
        t = x.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        t = t.cpu()
        if copy and t.data_ptr() == x.data_ptr():
            t = t.clone()
        a = t.numpy()
        return (a.view(np.uint16), BF16) if bf16 else (a, str(a.dtype))
    a = np.array(x) if copy else np.asarray(x)
    if a.dtype.name == BF16:          # a numpy bfloat16 from another package
        return a.view(np.uint16), BF16
    return a, str(a.dtype)


def _from_disk(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """One loaded leaf as a tensor on ``device``."""
    if dtype == BF16:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t if device.type == "cpu" else t.to(device)


def _place(template, x: torch.Tensor):
    """A restored whole tensor as ``template`` holds it: split as a
    :class:`~repro_torch.train.optimizer.Shard` template is, else whole."""
    return template.like(x) if isinstance(template, optimizer.Shard) else x


def _write_synced(path: pathlib.Path, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class Checkpointer:
    """Versioned checkpoints of one tree under ``directory``; see module."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        # Serialises _write (and its trailing _gc) against restore's reads:
        # a committed step can never be GC'd mid-restore, and two writers
        # can never share a tmp dir.
        self._io_lock = threading.RLock()
        # Guards save_async's wait-then-spawn handoff so two concurrent
        # save_async calls cannot both observe "no thread" and leak one.
        self._spawn_lock = threading.Lock()

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, metadata: dict | None = None):
        """Synchronous checkpoint of ``tree`` at ``step``.

        Joins any in-flight :meth:`save_async` first, so the two can be
        mixed freely.  Host leaves are written as they are when the write
        reaches them: a caller racing its own writes copies first.
        """
        host = [(p, _to_host(x, copy=False))
                for p, x in leaves_with_paths(tree)]
        self.wait()
        self._write(step, host, metadata or {})

    def save_async(self, step: int, tree: Any, metadata: dict | None = None):
        """Copy every leaf to host memory now, serialise on a thread."""
        host = [(p, _to_host(x, copy=True))
                for p, x in leaves_with_paths(tree)]
        with self._spawn_lock:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, metadata or {}),
                daemon=True)
            self._thread.start()

    def wait(self):
        t = self._thread
        if t is not None:
            t.join()
            # only clear if no newer save_async already replaced it
            if self._thread is t:
                self._thread = None

    def _write(self, step: int, host: list, metadata: dict):
        with self._io_lock:
            tmp = self.dir / f".tmp-step_{step:08d}"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "metadata": metadata, "leaves": []}
            for i, (path, (arr, dtype)) in enumerate(host):
                _write_synced(tmp / f"leaf_{i}.npy",
                              lambda f, a=arr: np.save(f, a))
                manifest["leaves"].append(
                    {"path": path, "file": f"leaf_{i}.npy",
                     "shape": list(arr.shape), "dtype": dtype})
            _write_synced(tmp / "manifest.json", lambda f: f.write(
                json.dumps(manifest).encode()))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

    def _gc(self):
        with self._io_lock:
            steps = sorted(self.all_steps())
            for s in steps[:-self.keep] if self.keep else []:
                shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():   # complete checkpoints only
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int | None = None) -> dict:
        """The raw manifest of ``step`` (default: latest committed).

        Restores that build their template from the checkpoint (the
        snapshot layer rebuilding table slabs from recorded shapes) read
        this before :meth:`restore`.
        """
        with self._io_lock:
            # resolve "latest" under the lock: a step observed outside it
            # can be GC'd by a concurrent writer before the read starts
            if step is None:
                step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            return json.loads(
                (self.dir / f"step_{step:08d}" / "manifest.json").read_text())

    def restore(self, target: Any, step: int | None = None, *,
                strict: bool = True, device=None) -> tuple[Any, dict]:
        """Restore into the structure of ``target``; returns (tree, metadata).

        Leaves match by key path; each template leaf gives only its shape
        (a ``"meta"``-device tensor will do).  Every restored leaf is a
        tensor on ``device`` (``None`` means the GPU and raises without
        one).  ``strict`` (default): every checkpoint leaf must be consumed
        by a template leaf; unmatched saved leaves raise
        :class:`ValueError` instead of being silently dropped.
        """
        dev = resolve_device(device)
        with self._io_lock:
            if step is None:
                step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            d = self.dir / f"step_{step:08d}"
            manifest = json.loads((d / "manifest.json").read_text())
            by_path = {e["path"]: e for e in manifest["leaves"]}
            if strict:
                extra = sorted(set(by_path) - {p for p, _ in
                                               leaves_with_paths(target)})
                if extra:
                    raise ValueError(
                        f"checkpoint step {step} has leaves the restore "
                        f"template does not: {extra} — restoring would "
                        "silently drop saved state (pass strict=False to "
                        "restore the template's subset anyway)")

            def load(path, leaf):
                entry = by_path.get(path)
                if entry is None:
                    raise KeyError(f"checkpoint missing leaf {path!r}")
                arr = np.load(d / entry["file"], mmap_mode="r")
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"shape mismatch for {path}: ckpt {arr.shape} vs "
                        f"target {tuple(leaf.shape)}")
                if isinstance(leaf, layers.LayerStack):  # unstacked on host
                    return layers.LayerStack(
                        _place(part, _from_disk(a, entry["dtype"], dev))
                        for part, a in zip(leaf.parts, arr))
                return _place(leaf, _from_disk(arr, entry["dtype"], dev))

            return tree_map_with_path(load, target), manifest["metadata"]
