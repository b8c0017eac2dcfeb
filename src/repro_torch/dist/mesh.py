"""Named device meshes and their collectives: the four the multi-bank
search uses, and the all-to-all of the expert-parallel MoE.

The reference runs its bank body inside ``jax.shard_map`` and reduces the
per-bank candidates with ``axis_index``, ``all_gather``, ``ppermute`` and
``psum``; its expert-parallel MoE dispatches tokens with
``all_to_all``.  Here the same collectives are methods of a mesh object,
and the merges of :mod:`repro_torch.core.am` and the MoE of
:mod:`repro_torch.models.moe` are written once against them.  A mesh
has named axes with a shape (``("model",)``, ``("data", "model")``,
``("pod", "data", "model")``), as ``jax.make_mesh`` builds them.

Values are **bank-stacked**: a tensor whose leading dimension runs over
the banks this process holds (:meth:`banks`), one slice per bank.  A
leading dimension of 1 on a mesh that holds several banks is a value
*replicated* over them (every bank holds the same slice), which is what
:meth:`all_gather` and :meth:`psum` return.

Two implementations:

* :class:`LocalMesh` — every bank is a slice of one device, so one process
  holds all of them.  This is how the banks run on one GPU and in most CPU
  tests.  ``ppermute`` is an index along the bank dimension by the inverse
  permutation, ``all_gather`` a reshape, ``psum`` a sum.  Axes other than
  the bank axis are replicas: they hold the same banks, so one copy
  stands for all of them and a query batch sharded over them is, on one
  device, the whole batch.
* :class:`ProcessGroupMesh` — one rank per mesh position over
  ``torch.distributed`` (gloo on the CPU, NCCL with one GPU per rank):
  ``all_gather``, ``batch_isend_irecv`` for ``ppermute`` and
  ``all_reduce``.  Each rank holds one bank.
"""

from __future__ import annotations

import itertools
import math

import torch


def _expand(x: torch.Tensor, b: int) -> torch.Tensor:
    """A bank-stacked value with exactly ``b`` leading slices."""
    return x if x.shape[0] == b else x.expand(b, *x.shape[1:])


def _tile(g: torch.Tensor, dim: int, tiled: bool) -> torch.Tensor:
    """(B, *s) per-bank slices in bank order -> one replicated value.

    Stacked: (1, B, *s).  Tiled: the banks' slices concatenated along the
    per-bank dimension ``dim``, bank 0's first, as (1, ..., B * s[dim], ...).
    """
    if not tiled:
        return g[None]
    s = g.shape[1:]
    out = g.movedim(0, dim).reshape(*s[:dim], g.shape[0] * s[dim],
                                    *s[dim + 1:])
    return out[None]


class _Mesh:
    """Named axes and a shape; the collectives are the subclasses'."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        if any(n < 1 for n in shape):
            raise ValueError(f"mesh axes must be >= 1 wide, got {shape}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        """Positions in the mesh (the product of its shape)."""
        return math.prod(self.shape.values())

    def width(self, axes) -> int:
        """The product of the widths of ``axes`` (a name or names)."""
        if axes is None:
            return 1
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"{type(self).__name__}({dims})"


class LocalMesh(_Mesh):
    """A mesh whose banks are slices of one device, all in this process.

    ``LocalMesh((8,), ("model",))`` is 8 banks; ``LocalMesh((2, 4),
    ("data", "model"))`` is 4 banks with a query batch that may be split
    two ways.  The mesh holds no device: each collective runs where its
    tensors are.
    """

    def banks(self, axis: str) -> list[int]:
        """The bank coordinates along ``axis`` this process holds: all."""
        return list(range(self.shape[axis]))

    def axis_index(self, axis: str, device=None) -> torch.Tensor:
        """(B,) int64 bank coordinates, one per held bank."""
        return torch.arange(self.shape[axis], device=device)

    def all_gather(self, x: torch.Tensor, axis: str, *, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Every bank's slice, on every bank (see :func:`_tile`)."""
        return _tile(_expand(x, self.shape[axis]), dim, tiled)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """Bank ``dst`` receives bank ``src``'s slice for each (src, dst)
        of ``perm``, a permutation of the banks (every bank receives)."""
        b = self.shape[axis]
        src_of = dict((dst, src) for src, dst in perm)
        if sorted(src_of) != list(range(b)):
            raise ValueError(f"ppermute needs a permutation of the {b} "
                             f"banks, got {perm}")
        index = torch.tensor([src_of[d] for d in range(b)], device=x.device)
        return _expand(x, b)[index]

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(B_src, B_dst, ...) per-destination slices of each bank ->
        (B_dst, B_src, ...): bank ``j`` receives slice ``j`` of every
        bank, in bank order (the reference's tiled ``all_to_all`` on
        dimension 0).  Here a transpose of the two bank dimensions."""
        b = self.shape[axis]
        if x.shape[:2] != (b, b):
            raise ValueError(f"all_to_all over {b} banks needs a ({b}, {b}, "
                             f"...) value, got {tuple(x.shape)}")
        return x.transpose(0, 1)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over the banks, replicated, in ``x``'s dtype (as an
        all-reduce keeps it: an int8 sum wraps as int8)."""
        return _expand(x, self.shape[axis]).sum(dim=0, keepdim=True,
                                               dtype=x.dtype)

    def batch_part(self, axes, n: int) -> tuple[int, int]:
        """The rows of an ``n``-row batch split over ``axes`` that this
        process holds: all of them (every replica is here)."""
        return 0, n

    def gather_batch(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Rows split over ``axes`` put back together: already whole."""
        return x


class ProcessGroupMesh(_Mesh):
    """A mesh of ``torch.distributed`` ranks, one mesh position per rank.

    Positions map to ``ranks`` (default: every rank of the default group)
    in row-major order, as ``jax.make_mesh`` maps devices.  The process
    group must be initialised first.  Every rank of the default group must
    construct the mesh, the same way and in the same order, because the
    subgroups of its axes are created here (``torch.distributed.new_group``
    is collective); a rank outside ``ranks`` holds no bank and must not
    search.  Its collectives run where their tensors are: on the CPU for
    gloo, on the rank's GPU for NCCL.
    """

    def __init__(self, shape, axis_names, *, ranks=None):
        import torch.distributed as dist
        super().__init__(shape, axis_names)
        ranks = (list(range(dist.get_world_size())) if ranks is None
                 else [int(r) for r in ranks])
        if len(ranks) != self.size:
            raise ValueError(f"{len(ranks)} ranks for a mesh of "
                             f"{self.size} positions")
        self.ranks = ranks
        me = dist.get_rank()
        dims = tuple(self.shape.values())
        coords = list(itertools.product(*(range(n) for n in dims)))
        self.coords = (dict(zip(self.axis_names, coords[ranks.index(me)]))
                       if me in ranks else None)
        # one subgroup per (set of axes, position along the other axes),
        # created by every rank in the same order; members keep theirs
        self._groups: dict[tuple, tuple] = {}
        n_ax = len(self.axis_names)
        for size in range(1, n_ax + 1):
            for sub in itertools.combinations(range(n_ax), size):
                rest = [i for i in range(n_ax) if i not in sub]
                for other in itertools.product(*(range(dims[i])
                                                 for i in rest)):
                    members = []
                    for inner in itertools.product(*(range(dims[i])
                                                     for i in sub)):
                        c = [0] * n_ax
                        for i, v in zip(rest, other):
                            c[i] = v
                        for i, v in zip(sub, inner):
                            c[i] = v
                        members.append(ranks[coords.index(tuple(c))])
                    group = dist.new_group(sorted(members))
                    if me in members:
                        key = tuple(self.axis_names[i] for i in sub)
                        self._groups[key] = (group, members)

    def _group(self, axes) -> tuple:
        """(process group, member ranks in row-major order of ``axes``)."""
        if self.coords is None:
            raise RuntimeError("this rank holds no position of the mesh")
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]

    def _gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """(B, *x.shape): ``x`` from every member, in coordinate order."""
        import torch.distributed as dist
        group, members = self._group(axes)
        parts = [torch.empty_like(x) for _ in members]
        dist.all_gather(parts, x.contiguous(), group=group)
        by_rank = dict(zip(sorted(members), parts))
        return torch.stack([by_rank[r] for r in members])

    def banks(self, axis: str) -> list[int]:
        """The one bank coordinate along ``axis`` this rank holds."""
        return [self._coord(axis)]

    def _coord(self, axis: str) -> int:
        if self.coords is None:
            raise RuntimeError("this rank holds no position of the mesh")
        return self.coords[axis]

    def axis_index(self, axis: str, device=None) -> torch.Tensor:
        """(1,) int64: this rank's bank coordinate."""
        return torch.tensor([self._coord(axis)], device=device)

    def all_gather(self, x: torch.Tensor, axis: str, *, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Every bank's slice, on every bank (see :func:`_tile`)."""
        return _tile(self._gather(x[0], axis), dim, tiled)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """Send this bank's slice to its ``dst`` and take its ``src``'s
        (``perm`` a permutation of the banks, as on :class:`LocalMesh`)."""
        import torch.distributed as dist
        _, members = self._group(axis)
        me = self._coord(axis)
        send = [dst for src, dst in perm if src == me]
        recv = [src for src, dst in perm if dst == me]
        out = torch.zeros_like(x[0])
        ops = []
        for dst in send:
            if dst == me:
                out.copy_(x[0])
            else:
                ops.append(dist.P2POp(dist.isend, x[0].contiguous(),
                                      members[dst]))
        for src in recv:
            if src != me:
                ops.append(dist.P2POp(dist.irecv, out, members[src]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out[None]

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(1, B_dst, ...) this bank's slice for each bank -> (1, B_src,
        ...) the slice each bank sent it, in bank order
        (``torch.distributed.all_to_all_single``).  A bool value travels
        as uint8."""
        import torch.distributed as dist
        group, members = self._group(axis)
        b = len(members)
        if x.shape[:2] != (1, b):
            raise ValueError(f"all_to_all over {b} banks needs a (1, {b}, "
                             f"...) value, got {tuple(x.shape)}")
        # the group's ranks in ascending order, as the collective orders
        # its chunks; a bank's coordinate is its place in ``members``
        by_rank = sorted(range(b), key=lambda j: members[j])
        send = x[0]
        wire = send.to(torch.uint8) if send.dtype == torch.bool else send
        wire = wire[by_rank].contiguous()
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=group)
        recv = torch.empty_like(out)
        recv[by_rank] = out
        return (recv.bool() if send.dtype == torch.bool else recv)[None]

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over the banks, replicated."""
        import torch.distributed as dist
        group, _ = self._group(axis)
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    def batch_part(self, axes, n: int) -> tuple[int, int]:
        """This rank's rows of an ``n``-row batch split evenly over
        ``axes`` (row-major over their coordinates)."""
        if axes is None:
            return 0, n
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = 0
        for a in self.axis_names:
            if a in axes:
                pos = pos * self.shape[a] + self._coord(a)
        part = n // self.width(axes)
        return pos * part, (pos + 1) * part

    def gather_batch(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Every rank's rows of a batch split over ``axes``, in order."""
        if axes is None or self.width(axes) == 1:
            return x
        g = self._gather(x, axes)
        return g.reshape(g.shape[0] * g.shape[1], *g.shape[2:])
