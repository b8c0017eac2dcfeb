"""Serving layer of the port: the associative-search service.

* :mod:`repro_torch.serve.am_service` — :class:`AMService`, named
  capacity-bounded tables with LRU/TTL/reject eviction, a micro-batching
  lookup scheduler with dedup, per-table admission control, ternary tables
  and multi-match lookups, the IVF index tier (:class:`IndexSpec`), and
  :class:`AMDriver`, the pipelined dispatch driver; on a mesh, rows banked
  over its ``model`` axis.
* :mod:`repro_torch.serve.snapshot` — durability: ``AMService.snapshot(dir)``
  commits every table atomically through :mod:`repro_torch.checkpoint`;
  ``AMService.restore(dir, mesh=...)`` warm-restarts onto any bank count
  with bitwise-identical search results.
"""

from repro_torch.index.ivf import IndexSpec
from repro_torch.serve.am_service import (AdmissionError, AMDriver, AMService,
                                          PendingSearch, SearchRequest,
                                          SearchResponse, TableFullError)
from repro_torch.serve.snapshot import (MANIFEST_FIELDS, SNAPSHOT_FORMAT,
                                        read_service_manifest,
                                        restore_service, snapshot_service,
                                        table_manifest)

__all__ = ["AdmissionError", "AMDriver", "AMService", "IndexSpec",
           "MANIFEST_FIELDS", "PendingSearch", "SNAPSHOT_FORMAT",
           "SearchRequest", "SearchResponse", "TableFullError",
           "read_service_manifest", "restore_service", "snapshot_service",
           "table_manifest"]
