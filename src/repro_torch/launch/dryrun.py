"""Dry-run on the meta device: one record per (arch, shape, mesh) cell.

Port of :mod:`repro.launch.dryrun`.  The reference lowers and compiles
each cell's step on 512 fake host devices and reads its roofline inputs
from XLA (``cost_analysis``, ``memory_analysis``, the HLO text).  PyTorch
has no such compiled program; its way to run a program without running
it is the meta device, where every op computes its output's shape and
nothing else.  So here each cell's program runs on meta tensors under
:class:`CostCounter`, a dispatch mode that counts as it goes, and the
results are cached as JSON under ``torch_benchmarks/results/dryrun/``
with the reference's keys.  For each cell it proves that the shardings
divide and extracts the roofline inputs:

* **The program** is what the port runs for the shape's ``kind``:
  ``train``, one step of ``make_train_step(cfg, opt_cfg, mesh, rules)``
  (a :class:`~repro_torch.train.train_step.ShardedTrainStep`, since the
  production meshes shard the optimizer state over ``data``), or of
  ``make_train_step_compressed`` under ``grad_compress`` on the multi-pod
  mesh; ``prefill``, ``transformer.forward``; ``decode``,
  ``transformer.decode_step`` against ``init_cache(cfg, B, S)``.
  Attention runs the einsum path (a CUDA kernel cannot run on meta);
  ``flash_model`` drops the bytes of score-shaped tensors, as the
  reference's flash counterfactual does.
* **One rank's share.**  The production meshes are
  :func:`repro_torch.launch.mesh.make_production_mesh`'s shapes, each
  position one rank of a process-group mesh.  The cell runs as rank 0 on
  a :class:`RecordingMesh`: it holds one bank of every axis, as a rank of
  :class:`~repro_torch.dist.ProcessGroupMesh` does, and its collectives
  return meta tensors of the right shapes.  So the counts are one rank's,
  not the sum over a :class:`~repro_torch.dist.LocalMesh`'s banks on one
  device.  The batch splits over ``rules.dp`` (the rank runs its ``B /
  dp`` rows; a train step's other rows are the other ranks'); the
  weights are whole on every rank and the optimizer state is split over
  ``rules.fsdp``, because the port has no tensor-parallel forward: every
  rank of a ``model`` group computes the same forward, which
  ``useful_flop_ratio`` shows.
* **FLOPs** are ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode``'s registry, called without its module tracker):
  matrix products and convolutions only, as ``program_costs`` counts dots.
* **HBM bytes**: each aten op adds its operands' and results' bytes;
  views and bare allocations add none.  That is ``program_costs``' rule
  without XLA's fusion, which is what eager PyTorch really moves.
* **Memory.**  ``argument_bytes``: what the rank holds before the step,
  by the spec trees (:func:`held_numel`: the largest slice any rank
  holds, on the axes the port splits): whole weights, the optimizer
  state's ``fsdp`` slice, its batch rows and, for decode, its cache rows.
  ``temp_bytes``: the peak of the bytes the step allocates and holds at
  once (its outputs included).  ``output_bytes``: the step's outputs.
* **Collectives.**  Each call of the mesh's collectives records its kind,
  its bytes on the wire per device by the ring rule of
  ``repro.roofline.hlo_parse`` and its group.  Ranks are numbered
  row-major over the mesh and an H100 host holds :data:`RANKS_PER_HOST`
  of them (NVLink within a host, one 400 Gb/s NIC a card between hosts):
  a group whose ranks all share ``rank // 8`` counts as NVLink, any other
  as network.  The 16-wide ``model`` axis spans two hosts, and ``data``
  and ``pod`` cross hosts, so every group of the production meshes counts
  as network.
* **Trip counts.**  Where the port loops over time in Python
  (:func:`repro_torch.models.layers.scan`: the sLSTM's steps and the
  mLSTM's chunks), one iteration runs and its FLOPs and bytes count
  ``n`` times, as ``program_costs`` multiplies a while body by its trip
  count; in a training step the backward of the other ``n - 1``
  iterations is counted from one isolated backward of a step.  The other
  iterations' saved activations are not held, so a training cell with
  such a loop reads its temp bytes low by them.  The RG-LRU
  scan's ``ceil(log2 S)`` rounds differ in shape and run in full; no
  cell runs the GPipe forward.
* **MoE.**  Each MoE layer counts the path the port takes.  The dense
  oracle (every token through every expert: a train step, whose
  ``ShardedTrainStep`` slices take no mesh, and any forward without one)
  runs on meta as it is.  Expert parallelism (prefill and decode on a
  mesh) reads the group sizes to the host and cannot run on meta, so it
  counts the routed experts' products at a static capacity: each token's
  ``top_k`` slots, spread evenly over the experts a bank holds, plus the
  shared experts; the bank owns its slice of the sequence and the
  all-to-alls carry the port's send buffers.  The record's ``moe`` says
  which count was taken.

Usage (on the CPU; nothing runs on a device):
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, ModelCfg, ShapeCfg, \
    shape_applicable
from repro_torch.configs.registry import ALIASES, ARCH_IDS, get_config
from repro_torch.dist.mesh import _Mesh, _tile
from repro_torch.dist.specs import make_rules
from repro_torch.models import layers, moe, transformer
from repro_torch.roofline.model import Roofline, model_flops
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / \
    "torch_benchmarks" / "results" / "dryrun"

#: H100 cards a host holds (NVIDIA DGX/HGX H100: 8, all-to-all NVLink).
RANKS_PER_HOST = 8

SKIP_REASON = ("full quadratic attention at 524k tokens "
               "(assignment skip rule; see DESIGN.md §4)")

#: Flags of the reference's command line that select what the port does
#: not have, with the reason each is refused.
REFUSED_FLAGS = {
    "kv_replicate": "--kv-replicate stores K/V replicated for a "
                    "tensor-parallel head split; the port has no "
                    "tensor-parallel layout (only the fsdp axis shards "
                    "state)",
    "no_seq_shard": "--no-seq-shard selects the classic Megatron residual "
                    "layout; the port has no tensor-parallel layout (only "
                    "the fsdp axis shards state)",
    "moe_zero1": "--moe-zero1 moves the expert weights' fsdp split to the "
                 "optimizer state alone; the port splits the optimizer "
                 "state over fsdp either way and never splits weights, so "
                 "it changes nothing",
}

_ALIASING = {torch.ops.aten._unsafe_view.default,
             torch.ops.aten.alias.default,
             torch.ops.aten.lift_fresh.default}
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def is_score_shaped(shape) -> bool:
    """An attention-score-shaped tensor, which a flash kernel keeps on
    chip: ``repro.roofline.hlo_parse._is_score_shaped``'s rule (ndim >= 4,
    the key axis >= 1,024 and query x key >= 2^20 elements)."""
    dims = list(shape)
    return (len(dims) >= 4 and dims[-1] >= 1024
            and dims[-1] * dims[-2] >= 1 << 20)


class CostCounter(TorchDispatchMode):
    """Counts, for every aten op dispatched under it: FLOPs by
    ``flop_registry``, HBM bytes (operands and results; views and bare
    allocations free; with ``flash_model`` score-shaped tensors free), and
    the bytes of storages the ops allocate that are live at once (their
    peak in :attr:`peak`).  Storages that existed before it was entered
    (the arguments) are not counted as live.  Also the scan hook of
    :data:`repro_torch.models.layers.SCAN_COUNTER` (:meth:`scan`)."""

    def __init__(self, flash_model: bool = False):
        super().__init__()
        self.flash_model = flash_model
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.paused = False
        self.trips: collections.Counter = collections.Counter()
        self.moe_ep_layers = 0
        self._sizes: dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not (func.is_view or func in _ALIASING or func in _ALLOCATIONS):
            self.bytes += sum(_nbytes(t) for t in ins + outs
                              if not (self.flash_model
                                      and is_score_shaped(t.shape)))
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def add(self, flops: int = 0, nbytes: int = 0) -> None:
        if not self.paused:
            self.flops += flops
            self.bytes += nbytes

    @contextlib.contextmanager
    def pause(self):
        """Nothing dispatched inside is counted."""
        was, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = was

    def scan(self, step, carry, xs: tuple, n: int):
        """:func:`repro_torch.models.layers.scan` counted by trip count:
        step 0 runs and its FLOPs and bytes count ``n`` times; its output
        stands for every step's.  Where the step will be differentiated
        (grad on, and not the recompute inside a backward pass), the
        backward pass differentiates the one step that ran, and the other
        ``n - 1`` steps' backward is counted from one isolated backward
        (:meth:`_step_backward`)."""
        self.trips[n] += 1
        f0, b0 = self.flops, self.bytes
        carry_out, y = step(carry, tuple(x[:, 0] for x in xs))
        self.add((n - 1) * (self.flops - f0), (n - 1) * (self.bytes - b0))
        ys = _Repeat.apply(y, n)
        if (torch.is_grad_enabled()
                and torch._C._current_graph_task_id() == -1
                and any(t.requires_grad for t in (*carry_out, y))):
            flops, nbytes = self._step_backward(step, carry, carry_out, xs)
            self.add((n - 1) * flops, (n - 1) * nbytes)
        return carry_out, ys

    def _step_backward(self, step, carry, carry_out, xs) -> tuple[int, int]:
        """(FLOPs, bytes) of one step's backward in the loop's steady
        state: the carry needing a gradient where the step's output carry
        does, each input a slice of its whole ``xs`` tensor (the slice's
        backward writes a zero tensor of the whole and the slice, and the
        whole's gradient takes one more addition of it, as the loop sums
        ``n`` of them)."""
        # apart from the graph being built: a checkpointed block's pack
        # hooks must not see this step's saved tensors
        with self.pause(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            c_in = [c.detach().requires_grad_(o.requires_grad)
                    for c, o in zip(carry, carry_out, strict=True)]
            whole = [x.detach().requires_grad_(x.requires_grad) for x in xs]
            c, y = step(tuple(c_in), tuple(x[:, 0] for x in whole))
            outs = [o for o in (*c, y) if o.requires_grad]
            grads = [torch.empty_like(o) for o in outs]
            leaves = [t for t in (*c_in, *whole) if t.requires_grad]
            inner = CostCounter(self.flash_model)
            with inner:
                torch.autograd.grad(outs, leaves, grads, allow_unused=True)
                for x in whole:
                    if x.requires_grad:
                        torch.empty_like(x) + torch.empty_like(x)
        return inner.flops, inner.bytes


class _Repeat(torch.autograd.Function):
    """One step's output standing for ``n`` stacked along dim 1, as the
    loop's ``torch.stack`` writes them (for counting only: the gradient
    passes on step 0's slice, since :meth:`CostCounter.scan` counts the
    other steps' backward apart)."""

    @staticmethod
    def forward(ctx, y, n):
        return torch.stack([y] * n, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.select(1, 0), None


# ---------------------------------------------------------------------------
# The recording mesh
# ---------------------------------------------------------------------------

def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes a device sends under the standard ring algorithms
    (``repro.roofline.hlo_parse._wire_bytes``)."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g * result_bytes
    if kind == "reduce-scatter":
        return float(g - 1) * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(kind)


class RecordingMesh(_Mesh):
    """Rank 0 of a process-group mesh of ``shape``, for counting on the
    meta device: it holds one bank of every axis (coordinate 0), as a rank
    of :class:`~repro_torch.dist.ProcessGroupMesh` does, and each
    collective returns an output of the shape that mesh's would, records
    ``(kind, group, wire bytes per device, NVLink or network)`` in
    :attr:`calls` and adds its operand and result bytes to ``counter``."""

    def __init__(self, shape, axis_names, counter: CostCounter | None = None):
        super().__init__(shape, axis_names)
        self.counter = counter
        self.calls: list[dict] = []

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def members(self, axes) -> list[int]:
        """The ranks of rank 0's group over ``axes`` (row-major ranks)."""
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        ranks = [0]
        for a in self._axes(axes):
            ranks = [r + c * strides[a] for r in ranks
                     for c in range(self.shape[a])]
        return sorted(ranks)

    def _record(self, kind: str, axes, result: int, operand: int) -> None:
        axes = self._axes(axes)
        g = self.width(axes)
        if g <= 1:
            return
        ranks = self.members(axes)
        self.calls.append({
            "kind": kind, "axes": axes, "group": g,
            "bytes": wire_bytes(kind, result, g),
            "nvlink": len({r // RANKS_PER_HOST for r in ranks}) == 1})
        if self.counter is not None:
            self.counter.add(nbytes=result + operand)

    def banks(self, axis: str) -> list[int]:
        return [0]

    def axis_index(self, axis: str, device=None) -> torch.Tensor:
        return torch.zeros((1,), dtype=torch.int64, device=device)

    def all_gather(self, x: torch.Tensor, axis: str, *, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        g = self.width(self._axes(axis))
        part = x[0]
        out = part.new_empty((g, *part.shape))
        self._record("all-gather", axis, _nbytes(out), _nbytes(part))
        return _tile(out, dim, tiled)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        out = torch.empty_like(x[0])
        self._record("collective-permute", axis, _nbytes(out), _nbytes(out))
        return out[None]

    def all_to_all(self, x: torch.Tensor, axis) -> torch.Tensor:
        b = self.width(self._axes(axis))
        if x.shape[:2] != (1, b):
            raise ValueError(f"all_to_all over {b} banks needs a (1, {b}, "
                             f"...) value, got {tuple(x.shape)}")
        out = torch.empty_like(x)
        self._record("all-to-all", axis, _nbytes(out), _nbytes(x))
        return out

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        out = torch.empty_like(x)
        self._record("all-reduce", axis, _nbytes(out), _nbytes(x))
        return out

    def batch_part(self, axes, n: int) -> tuple[int, int]:
        return (0, n) if axes is None else (0, n // self.width(axes))

    def gather_batch(self, x: torch.Tensor, axes) -> torch.Tensor:
        if axes is None or self.width(axes) == 1:
            return x
        g = self.width(self._axes(axes))
        out = x.new_empty((g * x.shape[0], *x.shape[1:]))
        self._record("all-gather", axes, _nbytes(out), _nbytes(x))
        return out

    def collectives(self) -> dict:
        """The reference's ``collectives`` entry, with ``nvlink_bytes`` and
        ``net_bytes`` in place of ``ici_bytes`` and ``dcn_bytes``."""
        by_kind: dict = collections.defaultdict(float)
        counts: dict = collections.defaultdict(int)
        nvlink = net = 0.0
        for c in self.calls:
            by_kind[c["kind"]] += c["bytes"]
            counts[c["kind"]] += 1
            if c["nvlink"]:
                nvlink += c["bytes"]
            else:
                net += c["bytes"]
        return {"by_kind_bytes": dict(by_kind), "counts": dict(counts),
                "nvlink_bytes": nvlink, "net_bytes": net}


# ---------------------------------------------------------------------------
# MoE at a static capacity
# ---------------------------------------------------------------------------

def _moe_plan(cfg: ModelCfg, mesh, b: int, s: int) -> tuple[int, bool, int]:
    """(EP width, whether the sequence splits over it, the tokens a bank
    owns) of an MoE layer over (b, s) tokens: EP on the mesh's ``model``
    axis for an ``ep`` config with a mesh whose axis divides the experts
    (else one bank, as the port's dense path), a bank owning its slice of
    the sequence where S > 1 divides over it, as ``moe.moe_ep`` splits."""
    ep = mesh.shape.get(moe.EP_AXIS, 1) if (cfg.parallel.ep
                                            and mesh is not None) else 1
    if cfg.moe.n_experts % ep:
        ep = 1
    seq_sharded = ep > 1 and s % ep == 0 and s > 1
    return ep, seq_sharded, b * s // ep if seq_sharded else b * s


def moe_static(params: moe.MoE, x: torch.Tensor, cfg: ModelCfg, mesh=None):
    """One MoE layer of the EP path as :func:`moe_ep_counted` counts it
    (with no mesh, at one bank): the router, then each of the bank's tokens' ``top_k``
    slots through the bank's experts at an even static capacity (one
    batched product pair over ``ceil(slots / experts)`` slots an expert),
    gate-weighted back, plus the shared experts on every token.  Under EP
    (``cfg.parallel.ep`` and a mesh whose ``model`` axis divides the
    experts) the bank owns its slice of the sequence (all tokens when S is
    1), the port's send buffers go out and back through
    :meth:`all_to_all` and the outputs are gathered.  Shapes are right,
    values are not: for counting on meta tensors only."""
    m = cfg.moe
    b, s, d = x.shape
    ep, seq_sharded, t_own = _moe_plan(cfg, mesh, b, s)
    xf = x.reshape(-1, d)
    gates, experts, probs = moe._route(params.router, xf, m.top_k)
    aux = moe.load_balance_loss(probs, experts, m.n_experts)
    slots = t_own * m.top_k
    e_local = m.n_experts // ep
    cap = -(-slots // e_local)
    src = torch.arange(t_own, device=x.device).repeat_interleave(m.top_k)
    src_pad = torch.cat([src, src.new_zeros(e_local * cap - slots)])
    xs = xf[:t_own].index_select(0, src_pad).reshape(e_local, cap, d)
    if ep > 1:
        # the port's send buffers: x, local expert ids and valid flags
        c = moe.capacity(t_own, cfg, ep)
        for buf in (x.new_empty((1, ep, c, d)),
                    x.new_empty((1, ep, c), dtype=torch.int64),
                    x.new_empty((1, ep, c), dtype=torch.bool)):
            mesh.all_to_all(buf, moe.EP_AXIS)
    h = torch.bmm(xs, params.w1[:e_local])
    gate_h, up_h = h.chunk(2, dim=-1)
    y = torch.bmm(layers.silu(gate_h) * up_h, params.w2[:e_local])
    y = y.reshape(-1, d)[:slots]
    if ep > 1:
        mesh.all_to_all(x.new_empty((1, ep, c, d)), moe.EP_AXIS)
    contrib = (y * gates[:t_own].reshape(-1, 1).to(y.dtype)).to(x.dtype)
    out = xf.new_zeros((t_own, d)).index_add(0, src, contrib)
    if seq_sharded:
        out = mesh.all_gather(out[None], moe.EP_AXIS)[0]
    out = out.reshape(b, s, d)
    if ep > 1:
        aux = mesh.psum(aux.reshape(1), moe.EP_AXIS)[0] / ep
    if m.n_shared:
        out = out + layers.mlp(params.shared, x)
    return out, aux


def moe_ep_counted(counter: CostCounter, params: moe.MoE, x: torch.Tensor,
                   cfg: ModelCfg, mesh):
    """``moe.moe_ep`` as counted: :func:`moe_static`, or the dense oracle
    where the ``model`` axis does not divide the experts, as ``moe_ep``
    falls back to it."""
    if cfg.moe.n_experts % mesh.shape.get(moe.EP_AXIS, 1):
        return moe.moe_dense(params, x, cfg)
    counter.moe_ep_layers += 1
    return moe_static(params, x, cfg, mesh)


def moe_count(cfg: ModelCfg, shape: ShapeCfg, mesh, b_rank: int,
              ep_layers: int) -> dict:
    """The record's ``moe`` entry: which path the port took and so which
    count (``ep_layers``: the MoE layers counted at the static capacity;
    a train step's slices take no mesh and run the dense oracle)."""
    m = cfg.moe
    s = 1 if shape.kind == "decode" else shape.seq_len
    entry = {"top_k": m.top_k, "n_shared": m.n_shared,
             "n_experts": m.n_experts}
    if not ep_layers:
        return {**entry, "count": "dense oracle: every token through "
                "every expert, as the port runs it", "port_path":
                "dense oracle" + (" (ShardedTrainStep's slices take no "
                                  "mesh)" if shape.kind == "train" else ""),
                "experts_per_bank": m.n_experts, "ep": 1,
                "tokens_per_bank": b_rank * s}
    ep, _, tokens = _moe_plan(cfg, mesh, b_rank, s)
    return {**entry, "count": "static capacity: top_k routed slots a "
            "token, even over the bank's experts, plus the shared experts",
            "port_path": f"expert parallel over model ({ep} banks)",
            "experts_per_bank": m.n_experts // ep, "ep": ep,
            "tokens_per_bank": tokens}


# ---------------------------------------------------------------------------
# Spec arithmetic: what a rank holds, and whether the shardings divide
# ---------------------------------------------------------------------------

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def held_numel(shape, spec, mesh, axes) -> int:
    """Elements of the largest slice of a ``shape`` tensor that one rank
    holds when ``spec`` lays it out and only ``axes`` of it are split:
    each dimension whose entry names some of them is cut into their width
    by ``torch.tensor_split``, whose first slice is the largest."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    n = 1
    for size, entry in zip(shape, spec):
        w = math.prod(mesh.shape.get(a, 1) for a in _names(entry)
                      if a in axes)
        n *= -(-size // w)
    return n


def held_params(lm: transformer.LM, spec_tree, mesh, axes) -> int:
    """Parameters of ``lm`` one rank holds of a state laid out by
    ``spec_tree`` (the reference's tree of ``lm``, as
    :func:`repro_torch.train.train_step.state_specs` gives it) when only
    ``axes`` are split."""
    return sum(held_numel(p.shape, spec, mesh, axes) for p, spec in
               zip(lm.parameters(), opt.leaf_specs(lm, spec_tree)))


class ShardingError(ValueError):
    """A leaf whose dimension does not divide over the axes that split it."""


def _spec_pairs(tree, specs, prefix=""):
    """(name, tensor, spec) over a cache tree and its spec tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _spec_pairs(tree[k], specs[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, (t, s) in enumerate(zip(tree, specs, strict=True)):
            yield from _spec_pairs(t, s, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree, specs


def check_divides(leaves, mesh, split_axes) -> list[str]:
    """Every named axis of every ``(name, shape, spec)`` leaf: raise
    :class:`ShardingError`, naming the leaf, where one the port splits
    (``split_axes``) does not divide its dimension; return the leaves
    whose other named axes (``tp``, which the port does not split) do
    not, as ``"name: dim i (size) over axes (width)"``."""
    unsplit = []
    for name, shape, spec in leaves:
        if len(spec) > len(shape):
            raise ShardingError(f"{name}: spec {spec} for shape "
                                f"{tuple(shape)}")
        for i, (size, entry) in enumerate(zip(shape, spec)):
            names = _names(entry)
            w = mesh.width(names)
            if not names or size % w == 0:
                continue
            msg = (f"{name}: dim {i} ({size}) over {names} (width {w})")
            if any(a in split_axes for a in names):
                raise ShardingError(f"{msg} does not divide")
            unsplit.append(msg)
    return unsplit


def _param_leaves(lm: transformer.LM, spec_tree, prefix: str):
    names = [f"{prefix}{n}" for n, _ in lm.named_parameters()]
    return [(n, p.shape, s) for n, p, s in
            zip(names, lm.parameters(), opt.leaf_specs(lm, spec_tree))]


def _bytes_held(leaves, tensors, mesh, axes) -> int:
    return sum(held_numel(shape, spec, mesh, axes) * t.element_size()
               for (_, shape, spec), t in zip(leaves, tensors))


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _batch(cfg: ModelCfg, rows: int, seq: int, kind: str) -> dict:
    """The step's batch on meta: tokens (and labels and mask to train),
    with a stub frontend's (rows, P, 1024) embeddings."""
    meta = {"device": "meta"}
    s_tok = seq - (cfg.n_prefix_embeds if cfg.frontend else 0)
    batch = {"tokens": torch.empty((rows, s_tok), dtype=torch.int32,
                                   **meta)}
    if kind == "train":
        batch["labels"] = torch.empty((rows, s_tok), dtype=torch.int32,
                                      **meta)
        batch["mask"] = torch.empty((rows, s_tok), dtype=torch.float32,
                                    **meta)
    if cfg.frontend:
        batch["embeds"] = torch.empty(
            (rows, cfg.n_prefix_embeds, transformer.STUB_FRONTEND_DIM),
            dtype=torch.float32, **meta)
    return batch


def _train_state(cfg: ModelCfg, compressed: bool) -> ts.TrainState:
    """``init_state``'s state on meta (nothing drawn)."""
    params = transformer.LM(cfg, device="meta")
    params.requires_grad_(True)
    ef = (opt.tree_map(lambda p: torch.empty_like(p, dtype=torch.float32),
                       params) if compressed else None)
    return ts.TrainState(params=params, opt=opt.init(params),
                         step=torch.zeros((), dtype=torch.int32,
                                          device="meta"), ef=ef)


@contextlib.contextmanager
def counting(counter: CostCounter):
    """``counter`` entered, with the port's loops over time and its EP
    MoE layers handed to it (:func:`repro_torch.models.layers.scan`,
    :func:`moe_ep_counted`)."""
    scan_tok = layers.SCAN_COUNTER.set(counter.scan)
    moe_tok = moe.MOE_COUNTER.set(functools.partial(moe_ep_counted, counter))
    try:
        with counter:
            yield counter
    finally:
        moe.MOE_COUNTER.reset(moe_tok)
        layers.SCAN_COUNTER.reset(scan_tok)


def count_cell(cfg: ModelCfg, shape: ShapeCfg, mesh_shape, axis_names, *,
               flash_model: bool = False, grad_compress: bool = False
               ) -> dict:
    """The counts of one cell as rank 0 of a mesh of ``mesh_shape`` over
    ``axis_names``: ``memory``, ``collectives``, ``roofline`` and what
    was counted (module docstring).  Raises :class:`ShardingError` where
    a split the port makes does not divide."""
    counter = CostCounter(flash_model)
    mesh = RecordingMesh(mesh_shape, axis_names, counter)
    rules = make_rules(mesh, cfg.parallel.layout,
                       batch_size=shape.global_batch,
                       resid_seq_shard=cfg.parallel.resid_seq_shard)
    dp = tuple(a for a in mesh.axis_names if a in (rules.dp or ()))
    dpw = mesh.width(dp)
    b_rank = shape.global_batch // dpw
    kind = shape.kind
    entry: dict = {"batch_rows": b_rank, "dp": list(dp),
                   "fsdp": rules.fsdp, "tp": rules.tp}

    if kind == "train":
        compressed = grad_compress and ts.POD_AXIS in mesh.axis_names
        state = _train_state(cfg, compressed)
        lm = state.params
        specs = ts.state_specs(cfg, rules, compressed)
        w_leaves = _param_leaves(lm, specs.params, "params.")
        o_leaves = _param_leaves(lm, specs.opt.master, "opt.")
        unsplit = check_divides(w_leaves, mesh, ())
        if compressed:
            step = ts.make_train_step_compressed(cfg, mesh)
            unsplit += check_divides(o_leaves, mesh, ())
            state_axes = ()
            rows = shape.global_batch // mesh.shape[ts.POD_AXIS]
            entry["program"] = "make_train_step_compressed"
        else:
            step = ts.make_train_step(cfg, opt.OptCfg(), mesh, rules)
            state_axes = (rules.fsdp,) if isinstance(
                step, ts.ShardedTrainStep) else ()
            unsplit += check_divides(o_leaves, mesh, state_axes)
            if state_axes:
                step.shard_state(state)
            rows = b_rank
            entry["program"] = type(step).__name__
        batch = _batch(cfg, shape.global_batch, shape.seq_len, kind)
        weights = sum(_nbytes(p) for p in lm.parameters())
        # master, m and v are float32 whatever the weights' dtype
        state_bytes = 12 * sum(held_numel(s, sp, mesh, state_axes)
                               for _, s, sp in o_leaves)
        ef = 4 * sum(p.numel() for p in lm.parameters()) if compressed else 0
        batch_bytes = sum(_nbytes(t) * rows // shape.global_batch
                          for t in batch.values())
        args = weights + state_bytes + ef + batch_bytes
        entry["argument_parts"] = {"weights": weights,
                                   "optimizer_state": state_bytes,
                                   "error_feedback": ef,
                                   "batch": batch_bytes}
        entry["batch_rows"] = rows

        def program():
            _, metrics = step(state, batch)
            return metrics
    else:
        lm = transformer.LM(cfg, device="meta")
        w_leaves = _param_leaves(lm, transformer.param_specs(cfg, rules),
                                 "params.")
        unsplit = check_divides(w_leaves, mesh, ())
        weights = sum(_nbytes(p) for p in lm.parameters())
        if kind == "prefill":
            entry["program"] = "transformer.forward"
            batch = _batch(cfg, b_rank, shape.seq_len, kind)
            cache_bytes = 0

            def program():
                with torch.no_grad():
                    return transformer.forward(lm, cfg, batch["tokens"],
                                               batch.get("embeds"), mesh)
        else:
            entry["program"] = "transformer.decode_step"
            whole = transformer.init_cache(cfg, shape.global_batch,
                                           shape.seq_len, device="meta")
            pairs = list(_spec_pairs(whole, transformer.cache_specs(cfg,
                                                                    rules)))
            c_leaves = [(f"cache.{n}", t.shape, s) for n, t, s in pairs]
            unsplit += check_divides(c_leaves, mesh, dp)
            cache_bytes = _bytes_held(c_leaves, [t for _, t, _ in pairs],
                                      mesh, dp)
            cache = transformer.init_cache(cfg, b_rank, shape.seq_len,
                                           device="meta")
            batch = {"tokens": torch.empty((b_rank, 1), dtype=torch.int32,
                                           device="meta")}

            def program():
                return transformer.decode_step(lm, cfg, cache,
                                               batch["tokens"],
                                               shape.seq_len - 1, mesh=mesh)
        batch_bytes = sum(_nbytes(t) for t in batch.values())
        args = weights + cache_bytes + batch_bytes
        entry["argument_parts"] = {"weights": weights, "cache": cache_bytes,
                                   "batch": batch_bytes}
    entry["tp_not_dividing"] = unsplit

    with counting(counter):
        out = program()
        outputs = sum(_nbytes(t) for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor))
    coll = mesh.collectives()
    rf = Roofline(flops=counter.flops, hbm_bytes=counter.bytes,
                  coll_bytes_nvlink=coll["nvlink_bytes"],
                  coll_bytes_net=coll["net_bytes"],
                  model_flops_global=model_flops(cfg, shape, kind),
                  n_chips=mesh.size)
    entry["trips"] = {str(n): calls for n, calls in
                      sorted(counter.trips.items())}
    return {
        "memory": {"argument_bytes": args, "output_bytes": outputs,
                   "temp_bytes": counter.peak,
                   "total_bytes": args + counter.peak},
        "collectives": coll,
        "roofline": rf.to_dict(),
        "per_rank": entry,
        "moe": None if cfg.moe is None else moe_count(
            cfg, shape, mesh, b_rank, counter.moe_ep_layers),
    }


def run_cell(arch: str, shape_name, multi_pod: bool,
             force: bool = False, overrides: dict | None = None,
             tag: str = "", flash_model: bool = False,
             grad_compress: bool = False, *, cfg: ModelCfg | None = None,
             mesh=None) -> dict:
    """One cell's record, read from ``RESULTS_DIR`` where it was written
    before (unless ``force``), else counted and written there.

    ``shape_name`` names a :data:`SHAPES` entry or is a
    :class:`ShapeCfg`; ``overrides`` replace fields of the config's
    :class:`ParallelCfg`; ``cfg`` (default ``get_config(arch)``) and
    ``mesh``, a ``(shape, axis_names)`` pair (default the production mesh,
    (data 16, model 16) or, ``multi_pod``, (pod 2, data 16, model 16)),
    size a cell that is not a production one.  A failure is recorded as
    ``error`` with its traceback: it is a fault of the port.
    """
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(
            cfg, parallel=dataclasses.replace(cfg.parallel, **overrides))
    shape = (shape_name if isinstance(shape_name, ShapeCfg)
             else SHAPES[shape_name])
    if mesh is None:
        mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
        mesh = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                else ((16, 16), ("data", "model")))
    else:
        mesh_tag = "mesh" + "x".join(str(n) for n in mesh[0])
    suffix = f"_{tag}" if tag else ""
    out_path = RESULTS_DIR / f"{cfg.name}_{shape.name}_{mesh_tag}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    record = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_tag,
              "status": "skipped", "reason": None}
    if not shape_applicable(cfg, shape):
        record["reason"] = SKIP_REASON
        _write(out_path, record)
        return record
    t0 = time.perf_counter()
    try:
        record.update(count_cell(cfg, shape, *mesh, flash_model=flash_model,
                                 grad_compress=grad_compress))
        record.update({"status": "ok",
                       "count_s": round(time.perf_counter() - t0, 1)})
    except Exception as e:  # a failure here is a fault of the port
        record.update({"status": "error",
                       "reason": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
    _write(out_path, record)
    return record


def _write(path: pathlib.Path, record: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="result-file suffix for variants")
    ap.add_argument("--kv-replicate", type=int, default=None)
    ap.add_argument("--bf16-scores", action="store_true")
    ap.add_argument("--moe-zero1", action="store_true")
    ap.add_argument("--flash-model", action="store_true",
                    help="model the flash-attention kernel: drop "
                         "score-tensor HBM traffic")
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="classic Megatron residual (replicated over model)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8+EF cross-pod gradient all-reduce (multi-pod)")
    args = ap.parse_args(argv)
    for flag, reason in REFUSED_FLAGS.items():
        if getattr(args, flag):
            ap.error(reason)

    overrides = {"attn_bf16_scores": True} if args.bf16_scores else None
    archs = ARCH_IDS if (args.all or not args.arch) else \
        [ALIASES.get(args.arch, args.arch)]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.all else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, mp, force=args.force,
                       overrides=overrides, tag=args.tag,
                       flash_model=args.flash_model,
                       grad_compress=args.grad_compress)
        rl = rec.get("roofline", {})
        print(f"{rec['arch']:24s} {shape:12s} {rec['mesh']:10s} "
              f"{rec['status']:8s} "
              f"bottleneck={rl.get('bottleneck', '-'):10s} "
              f"t_bound={rl.get('t_bound_s', 0):.4f}s "
              f"mfu_bound={rl.get('mfu_bound', 0):.3f} "
              f"({rec.get('count_s', 0)}s count)"
              + (f" reason={rec['reason']}" if rec["reason"] else ""),
              flush=True)


if __name__ == "__main__":
    main()
