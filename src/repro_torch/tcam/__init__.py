"""Ternary-CAM workloads over the masked associative-search tier.

Port of :mod:`repro.tcam`: the semantics layer above
:mod:`repro_torch.core.am`'s care-mask plane.  Build don't-care patterns
from *meanings* (prefixes, value ranges) instead of raw 0/1 planes, and run
the classic TCAM workload — longest-prefix-match routing — through the
ordinary ``am.search(..., matches=M)`` contract.

* :mod:`repro_torch.tcam.masks` — encode integers as multi-bit symbol words
  and expand prefixes / value ranges into ``(code, care)`` ternary entries
  (host-side numpy, bitwise the reference's).
* :mod:`repro_torch.tcam.routing` — an LPM routing table stored as a masked
  :class:`~repro_torch.core.am.AMTable`, resolved by CAM priority (lowest
  row index among exact masked matches, rows sorted longest-prefix-first).

``torch_examples/lpm_routing.py`` is a runnable end-to-end workload.
"""

from repro_torch.tcam.masks import (  # noqa: F401
    code_to_int,
    int_to_code,
    prefix_entries,
    prefix_entry,
    range_to_entries,
)
from repro_torch.tcam.routing import (  # noqa: F401
    Route,
    RoutingTable,
    build_routing_table,
    encode_addresses,
    lookup,
    lpm_oracle,
)
