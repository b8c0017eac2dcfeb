"""Longest-prefix-match routing over a masked AMTable (the TCAM workload).

Port of :mod:`repro.tcam.routing`.  A routing table is a list of
``(value, prefix_bits) -> next_hop`` rules; a lookup must return the next
hop of the *longest* prefix covering the query address.  Hardware TCAMs
resolve this with priority encoding: rules are stored longest-prefix-first,
every rule whose cared bits agree raises its match line, and the lowest
matching address wins.  This module reproduces that resolution exactly on
the masked multi-match tier:

* each route expands to ternary ``(code, care)`` entries via
  :func:`repro_torch.tcam.masks.prefix_entries` (sub-symbol prefix lengths
  included),
* entries are stable-sorted by descending prefix length, so the lowest
  global row index among exact masked matches *is* the longest prefix
  (first-inserted wins among equal lengths, matching real route-add order),
* a batch lookup is one ``am.search(table, addrs, matches=M)`` call with
  ``threshold=None`` (exact masked matches only); slot 0 of the
  multi-match window — the priority entry — selects the next hop.  On a
  GPU table with ``backend="cuda"`` that search is one ``cam_pack`` and one
  ``cam_search_topk`` launch, with the care plane and the in-kernel
  threshold count.

Table construction is host-side numpy, as in the reference; the compiled
table and its per-row hop metadata live on one device (the GPU unless
``device="cpu"``).  :func:`lpm_oracle` is the pure-python reference the
tests and the smoke run compare against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import am
from repro_torch.tcam import masks


@dataclasses.dataclass(frozen=True)
class Route:
    """One routing rule: prefix ``value/prefix_bits`` forwards to ``next_hop``.

    ``prefix_bits=0`` is the default route (matches every address).
    """

    value: int
    prefix_bits: int
    next_hop: int


@dataclasses.dataclass(frozen=True)
class RoutingTable:
    """A compiled LPM table: a masked AMTable plus per-row hop metadata.

    Attributes:
      table: masked :class:`~repro_torch.core.am.AMTable`, rows sorted
        longest-prefix-first so CAM priority = longest prefix.
      next_hops: (N,) int32 next hop per table row, on the table's device.
      prefix_lens: (N,) int32 originating prefix length per row (an expanded
        sub-symbol prefix keeps its route's length on every entry), on the
        table's device.
      default_hop: hop returned when no rule matches.
      width: symbols per address word.
      bits: bits per symbol.
    """

    table: am.AMTable
    next_hops: torch.Tensor
    prefix_lens: torch.Tensor
    default_hop: int
    width: int
    bits: int


def build_routing_table(routes, *, width: int, bits: int,
                        default_hop: int = -1, device=None) -> RoutingTable:
    """Compile routes into a longest-prefix-first masked AMTable.

    Args:
      routes: iterable of :class:`Route` (or ``(value, prefix_bits,
        next_hop)`` triples).
      width: symbols per address word.
      bits: bits per symbol (address space is ``[0, 2**(width*bits))``).
      default_hop: hop for addresses no rule covers.
      device: where the table lives; ``None`` means the GPU.

    Returns:
      A :class:`RoutingTable` ready for :func:`lookup`.
    """
    rows = []
    for r in routes:
        r = r if isinstance(r, Route) else Route(*r)
        for code, care in masks.prefix_entries(r.value, r.prefix_bits,
                                               width=width, bits=bits):
            rows.append((r.prefix_bits, code, care, r.next_hop))
    if not rows:
        raise ValueError("routes must contain at least one rule")
    # Stable sort, descending prefix length: the lowest global row index
    # among matches is then the longest prefix, first-inserted among equals.
    rows.sort(key=lambda row: -row[0])
    codes = np.stack([row[1] for row in rows])
    cares = np.stack([row[2] for row in rows])
    table = am.make_table(codes, bits=bits, care_mask=cares, device=device)
    dev = table.device
    return RoutingTable(
        table=table,
        next_hops=torch.tensor([row[3] for row in rows], dtype=torch.int32,
                               device=dev),
        prefix_lens=torch.tensor([row[0] for row in rows], dtype=torch.int32,
                                 device=dev),
        default_hop=int(default_hop), width=width, bits=bits)


def encode_addresses(rt: RoutingTable, addrs) -> torch.Tensor:
    """Encode integer addresses as a (Q, width) int32 query-code batch on
    the table's device."""
    codes = np.stack([masks.int_to_code(a, width=rt.width, bits=rt.bits)
                      for a in np.asarray(addrs).reshape(-1).tolist()])
    return torch.from_numpy(codes).to(rt.table.device)


def lookup(rt: RoutingTable, addrs, *, matches: int = 8, backend=None):
    """Resolve a batch of addresses to next hops by CAM priority.

    One masked multi-match search (``threshold=None`` — exact matches only)
    over the longest-prefix-first table; the priority entry (slot 0, lowest
    (distance, row-index)) is the longest matching prefix.

    Args:
      rt: a compiled :class:`RoutingTable`.
      addrs: (Q,) integer addresses.
      matches: multi-match window width ``M``.  ``result.overflow`` flags
        addresses covered by more than ``M`` rules — the hop is still
        correct (priority survives truncation), wider ``M`` only recovers
        the full match list.
      backend: ``am`` backend name/callable (None = the ``am`` default,
        ``"ref"``; ``"cuda"`` runs the CAM kernels on a GPU table).

    Returns:
      ``(next_hops, result)`` — (Q,) int32 hops (``rt.default_hop`` where
      nothing matched) and the underlying
      :class:`~repro_torch.core.am.AMMultiMatchResult`.
    """
    qcodes = encode_addresses(rt, addrs)
    result = am.search(rt.table, qcodes, matches=matches, backend=backend)
    hit = result.priority_index >= 0
    hops = torch.where(hit,
                       rt.next_hops[result.priority_index.clamp(min=0).long()],
                       torch.full_like(rt.next_hops[:1], rt.default_hop))
    return hops, result


def lpm_oracle(routes, addr: int, *, width: int, bits: int,
               default_hop: int = -1) -> int:
    """Pure-python longest-prefix-match reference.

    Scans the raw rules (no ternary expansion): among routes whose prefix
    covers ``addr``, the longest wins; first-listed wins equal lengths —
    the same resolution order :func:`build_routing_table`'s stable sort
    encodes in row priority.
    """
    total = width * bits
    addr = int(addr)
    best_len, best_hop = -1, int(default_hop)
    for r in routes:
        r = r if isinstance(r, Route) else Route(*r)
        shift = total - r.prefix_bits
        if (addr >> shift) == (int(r.value) >> shift) \
                and r.prefix_bits > best_len:
            best_len, best_hop = r.prefix_bits, int(r.next_hop)
    return best_hop
