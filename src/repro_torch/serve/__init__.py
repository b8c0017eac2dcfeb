"""Serving layer of the port: the associative-search service.

* :mod:`repro_torch.serve.am_service` — :class:`AMService`, named
  capacity-bounded tables with LRU/TTL/reject eviction, a micro-batching
  lookup scheduler with dedup, per-table admission control, ternary tables
  and multi-match lookups, and :class:`AMDriver`, the pipelined dispatch
  driver.  Single device; sharding, the index tier and snapshots come with
  later port slices.
"""

from repro_torch.serve.am_service import (AdmissionError, AMDriver, AMService,
                                          PendingSearch, SearchRequest,
                                          SearchResponse, TableFullError)

__all__ = ["AdmissionError", "AMDriver", "AMService", "PendingSearch",
           "SearchRequest", "SearchResponse", "TableFullError"]
