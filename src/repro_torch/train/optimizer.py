"""AdamW with float32 master weights, and int8 gradient quantization.

Port of :mod:`repro.train.optimizer`.  The optimizer state mirrors the
parameter tree: ``master``, ``m`` and ``v`` hold a float32 tensor for every
parameter, in a tree of the parameters' structure.  A tree is an
``nn.Module`` (its ``named_parameters()``, in that order; the state's
copies are structural copies of the module, see
:func:`repro_torch.models.layers.module_like`), a dict (its keys in sorted
order, as JAX flattens one), a list or tuple, or a tensor.

The update acts on the leaves of the *reference's* tree: an LM's layers
are stacked there, so one leaf (a
:class:`~repro_torch.models.layers.LayerStack`) holds every layer's
tensor of one name and has one more dimension.  Weight decay goes to the
leaves with ``ndim >= 2`` as the reference counts them, which takes in
each layer's norm scales ((L, d) stacked) but not ``final_norm``'s (d,).

:func:`apply` updates the master weights, the moments and the parameters
in place and returns them: a model whose state fills most of the card
cannot be held twice.  It keeps the reference's order of operations, and
``count``, ``lr`` and ``grad_norm`` stay 0-d tensors on the parameters'
device, so an update never waits for the host.

**ZeRO: the state sharded over the ``fsdp`` axis.**  The reference gets
it from GSPMD: the state leaves take the parameters' specs
(:func:`state_specs`), so each device holds and updates its part of
master, m and v.  Here :func:`shard` splits each state leaf whose spec
names the axis into contiguous slices along that dimension, as
``torch.tensor_split`` makes them (where the width does not divide the
dimension, the trailing slices are one element shorter), held as
:class:`Shard` leaves; a leaf with no entry on the axis (a norm scale, the
router) stays whole, as GSPMD replicates it.  :func:`apply` on such a
state updates the held slices, then writes the weights back from them
(:func:`write_weights`, an all-gather over the axis on a
:class:`~repro_torch.dist.ProcessGroupMesh`).  The global norm is taken
once, over the whole gradient, in the unsharded order, and every other
operation of AdamW is elementwise: given the same gradients the sharded
update is bitwise the unsharded one.  On a
:class:`~repro_torch.dist.LocalMesh` the banks are slices of one device,
so a :class:`Shard` holds the whole tensor and the banks update their
views of it; on a ``ProcessGroupMesh`` a rank holds its own slices only.
The bf16 weights and the gradients stay whole on every rank.

``quantize_grad`` / ``dequantize_grad`` are the int8 error-feedback
compression of the compressed cross-pod step
(:func:`repro_torch.train.train_step.make_train_step_compressed`).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


@dataclasses.dataclass
class OptState:
    master: Any     # fp32 master params
    m: Any          # first moment
    v: Any          # second moment
    count: torch.Tensor


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree in flattening order (``None`` holds none)."""
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def groups(tree, leaves=None) -> list[tuple[list[torch.Tensor], int]]:
    """The leaves of ``tree`` as the reference's tree holds them, in its
    order: (the tensors of the leaf, the leaf's ndim).  A tensor is a leaf
    of one part; a :class:`~repro_torch.models.layers.LayerStack` (an LM's
    :meth:`~repro_torch.models.transformer.LM.reference_tree`) one of a
    part per layer.  ``leaves``, aligned with :func:`tree_leaves`'s order
    of ``tree`` (gradients, say), are grouped in their place.
    """
    if leaves is not None:
        by_id = dict(zip(map(id, tree_leaves(tree)), leaves, strict=True))
        return [([by_id[id(x)] for x in parts], ndim)
                for parts, ndim in groups(tree)]
    if tree is None:
        return []
    if hasattr(tree, "reference_tree"):
        return groups(tree.reference_tree())
    if isinstance(tree, layers.LayerStack):
        return [(tree.parts, tree.ndim)]
    if isinstance(tree, nn.Module):
        return [([p], p.ndim) for p in tree.parameters()]
    if isinstance(tree, dict):
        return [g for k in sorted(tree) for g in groups(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [g for sub in tree for g in groups(sub)]
    return [([tree], tree.ndim)]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """A tree of ``tree``'s structure holding ``fn(leaf)`` for each leaf
    (a module's copy takes no gradients)."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        return layers.module_like(tree, {n: fn(p.detach()) for n, p
                                         in tree.named_parameters()}
                                  ).requires_grad_(False)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def _spec_leaves(spec_tree) -> list[tuple]:
    """The specs of a spec tree in :func:`groups`' order (dicts by sorted
    key, lists in order; a tuple is a spec)."""
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree)
                for s in _spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, list):
        return [s for sub in spec_tree for s in _spec_leaves(sub)]
    return [spec_tree]


def leaf_specs(params, spec_tree) -> list[tuple]:
    """The spec of each tensor of ``params``, in :func:`tree_leaves` order.

    ``spec_tree`` is shaped as the reference's tree of ``params``
    (:func:`repro_torch.models.transformer.param_specs` for an LM).  Where
    the reference stacks a layer stack, its spec leads with the layer
    axis; each layer's tensor takes the spec without it.
    """
    by_id = {}
    for (parts, ndim), spec in zip(groups(params), _spec_leaves(spec_tree),
                                   strict=True):
        if len(spec) > ndim:
            raise ValueError(f"spec {spec} for a {ndim}-d leaf")
        for x in parts:
            by_id[id(x)] = tuple(spec[ndim - x.ndim:])
    return [by_id[id(x)] for x in tree_leaves(params)]


def axis_dim(spec, axis: str) -> int | None:
    """The dimension ``spec`` splits over ``axis`` (None: none)."""
    for i, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i
    return None


class Shard:
    """One leaf of a sharded optimizer state: a tensor of ``shape`` split
    into contiguous slices along ``dim``, one per position of ``axis`` of
    ``mesh``, as ``torch.tensor_split`` makes them.  ``local`` holds what
    this process holds: on a mesh holding every bank of the axis (a
    :class:`~repro_torch.dist.LocalMesh`) the whole tensor, the banks being
    its slices; else this rank's slice alone."""

    def __init__(self, local: torch.Tensor, shape, dim: int, mesh, axis):
        self.local, self.shape, self.dim = local, torch.Size(shape), dim
        self.mesh, self.axis = mesh, axis

    @classmethod
    def split(cls, x: torch.Tensor, dim: int, mesh, axis: str) -> "Shard":
        """``x`` (the whole tensor) as this process holds it: itself
        where every bank is here, else a copy of this rank's slice."""
        held = mesh.banks(axis)
        local = x
        if len(held) < mesh.shape[axis]:
            local = torch.tensor_split(x, mesh.shape[axis],
                                       dim)[held[0]].clone()
        return cls(local, x.shape, dim, mesh, axis)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def whole(self) -> bool:
        """Whether this process holds every slice."""
        return len(self.mesh.banks(self.axis)) == self.mesh.shape[self.axis]

    def like(self, x: torch.Tensor) -> "Shard":
        """The whole tensor ``x`` split as this leaf is."""
        return Shard.split(x, self.dim, self.mesh, self.axis)

    def parts(self, x: torch.Tensor | None = None) -> list[torch.Tensor]:
        """The held slices (views) of ``x``, a whole tensor of this leaf's
        shape, or of this leaf's own tensor when ``x`` is None."""
        w = self.mesh.shape[self.axis]
        if self.whole:
            return list(torch.tensor_split(self.local if x is None else x,
                                           w, self.dim))
        if x is None:
            return [self.local]
        return [torch.tensor_split(x, w, self.dim)[
            self.mesh.banks(self.axis)[0]]]

    def full(self, dtype=None) -> torch.Tensor:
        """The whole tensor (in ``dtype``): on a rank holding one slice, an
        all-gather over the axis, which every rank of it must call."""
        x = self.local if dtype is None else self.local.to(dtype)
        if self.whole:
            return x
        w, n = self.mesh.shape[self.axis], self.shape[self.dim]
        sizes = [len(r) for r in torch.tensor_split(torch.arange(n), w)]
        if x.shape[self.dim] < sizes[0]:            # pad a short slice
            pad = list(x.shape)
            pad[self.dim] = sizes[0] - x.shape[self.dim]
            x = torch.cat([x, x.new_zeros(pad)], self.dim)
        g = self.mesh.all_gather(x[None], self.axis)[0]
        return torch.cat([g[i].narrow(self.dim, 0, sizes[i])
                          for i in range(w)], self.dim)


def init(params: Any) -> OptState:
    """float32 copies of the parameters, zero moments, count 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return OptState(
        master=tree_map(lambda p: p.to(torch.float32, copy=True), params),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        count=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(cfg: OptCfg, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * torch.where(
        step < cfg.warmup_steps, 1.0, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf."""
    return _norm(groups(tree))


def _norm(grouped) -> torch.Tensor:
    total = sum(sum(torch.sum(torch.square(x.float())) for x in parts)
                for parts, _ in grouped)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded as the reference's.  CUDA's is;
    PyTorch's vectorised CPU sqrt is one ulp off for about 0.6 % of
    float32 inputs, so the CPU takes it in float64 (exact after rounding
    back, since float64 carries more than twice float32's digits)."""
    return x.double().sqrt_().float() if x.device.type == "cpu" \
        else x.sqrt_()


def state_specs(param_specs) -> OptState:
    """The spec tree of an :class:`OptState` given the parameters' spec
    tree (their ``for_opt=True`` specs where the two differ): master, m
    and v each take the parameters' specs, ``count`` is replicated."""
    return OptState(master=copy.deepcopy(param_specs),
                    m=copy.deepcopy(param_specs),
                    v=copy.deepcopy(param_specs), count=())


def is_sharded(state: OptState) -> bool:
    """Whether any leaf of ``state`` is a :class:`Shard`."""
    return any(isinstance(x, Shard) for parts, _ in groups(state.master)
               for x in parts)


def _rebuild(params, new_groups: list) -> Any:
    """The reference's tree of ``params`` holding ``new_groups`` (one list
    of parts per :func:`groups` entry, in its order) at its leaves."""
    it = iter(new_groups)

    def walk(tree):
        if hasattr(tree, "reference_tree"):
            return walk(tree.reference_tree())
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(x) for x in tree)
        parts = next(it)
        return (layers.LayerStack(parts)
                if isinstance(tree, layers.LayerStack) else parts[0])

    out = walk(params)
    if next(it, None) is not None:
        raise ValueError("more groups than the tree has leaves")
    return out


def shard(state: OptState, params, spec_tree, mesh, axis) -> OptState:
    """``state`` with master, m and v split over ``axis`` of ``mesh``.

    ``spec_tree`` is the parameters' spec tree
    (``transformer.param_specs(cfg, rules, for_opt=True)`` for an LM).
    Each leaf whose spec names ``axis`` becomes a :class:`Shard` split
    along that dimension; the others stay whole.  master, m and v become
    reference trees (``params``' :meth:`reference_tree` structure, layer
    stacks as :class:`~repro_torch.models.layers.LayerStack` leaves).
    With no axis, an axis of width 1, or a state already sharded,
    ``state`` is returned as it is.
    """
    if axis is None or mesh.shape.get(axis, 1) == 1 or is_sharded(state):
        return state
    specs = dict(zip(map(id, tree_leaves(params)),
                     leaf_specs(params, spec_tree)))
    dims = [[axis_dim(specs[id(p)], axis) for p in ps]
            for ps, _ in groups(params)]

    def split(tree):
        return _rebuild(params, [
            [x if d is None else Shard.split(x.detach(), d, mesh, axis)
             for x, d in zip(parts, ds, strict=True)]
            for (parts, _), ds in zip(groups(tree), dims, strict=True)])

    return OptState(split(state.master), split(state.m), split(state.v),
                    state.count)


def _scalars(cfg: OptCfg, state: OptState, g_groups):
    """(grad norm, clip scale, count, lr, the two bias corrections)."""
    gnorm = _norm(g_groups)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    b1c = 1 - torch.pow(cfg.b1, count.float())
    b2c = 1 - torch.pow(cfg.b2, count.float())
    return gnorm, scale, count, lr, b1c, b2c


def _adamw(cfg: OptCfg, g, master, m, v, decay: bool, scale, lr, b1c, b2c):
    """One leaf's (or slice's) AdamW update of master, m and v, in place."""
    g = g.float() * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    step_ = (m / b1c).div_(_sqrt(v / b2c).add_(cfg.eps))
    # decoupled weight decay on matrices only (ndim >= 2)
    if decay:
        step_.add_(cfg.weight_decay * master)
    master.sub_(lr * step_)


def _flat(grads) -> list:
    return grads if isinstance(grads, list) else tree_leaves(grads)


@torch.no_grad()
def apply(cfg: OptCfg, state: OptState, grads: Any, params: Any):
    """One AdamW step.  Returns (params, state, stats).

    ``grads`` is a tree of ``params``' structure, or the list of its
    leaves in :func:`tree_leaves` order.  The master weights, the moments
    and the parameters are updated in place (the returned ``state`` holds
    the same tensors and a new ``count``); the new parameters are the
    master weights cast to the parameters' dtype.  ``stats`` are 0-d
    tensors: ``grad_norm`` before clipping and the step's ``lr``.  It is
    :func:`update_slices` and then :func:`write_weights`, which take whole
    leaves and the :class:`Shard` leaves of a sharded state (:func:`shard`)
    alike.
    """
    state, stats = update_slices(cfg, state, grads, params)
    write_weights(state, params)
    return params, state, stats


@torch.no_grad()
def update_slices(cfg: OptCfg, state: OptState, grads: Any, params: Any):
    """The first half of :func:`apply`: each held slice of master, m and
    v (each whole leaf) updated in place from the matching slice of the
    whole gradient.  Returns (state with the new count, stats)."""
    g_groups = groups(params, _flat(grads))
    gnorm, scale, count, lr, b1c, b2c = _scalars(cfg, state, g_groups)
    for (gs, ndim), (masters, _), (ms, _), (vs, _) in zip(
            g_groups, groups(state.master), groups(state.m),
            groups(state.v), strict=True):
        for g, master, m, v in zip(gs, masters, ms, vs, strict=True):
            if isinstance(master, Shard):
                for part in zip(master.parts(g), master.parts(), m.parts(),
                                v.parts(), strict=True):
                    _adamw(cfg, *part, ndim >= 2, scale, lr, b1c, b2c)
            else:
                _adamw(cfg, g, master, m, v, ndim >= 2, scale, lr, b1c, b2c)
    return OptState(state.master, state.m, state.v, count), {
        "grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def write_weights(state: OptState, params: Any) -> None:
    """The second half: the weights set to the master weights in their
    dtype, each :class:`Shard` gathered over its axis (every rank of it
    takes part) or, where every bank is here, cast whole."""
    for (ps, _), (masters, _) in zip(groups(params), groups(state.master),
                                     strict=True):
        for p, master in zip(ps, masters, strict=True):
            if isinstance(master, Shard) and not master.whole:
                p.copy_(master.full(p.dtype))
            else:
                p.copy_(master.local if isinstance(master, Shard)
                        else master)


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------

def quantize_grad(g: torch.Tensor, ef: torch.Tensor):
    """g + error-feedback -> (int8 codes, scale, new error feedback)."""
    gc = g.float() + ef
    scale = torch.max(torch.abs(gc)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gc / scale), -127, 127).to(torch.int8)
    new_ef = gc - q.float() * scale
    return q, scale, new_ef


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
