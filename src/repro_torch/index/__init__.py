"""repro_torch.index — set-associative IVF tier for sub-linear associative search.

Port of :mod:`repro.index`: partitions a table's rows into
S sets around quantized centroid codes, coarse-ranks the centroids with
exact digital distances, and fine-searches only the top ``probes`` sets'
row slabs with the real backends — on the GPU the fused
``cam_search_topk`` kernel, once per probed set.  ``probes == sets`` is
bitwise the flat ``am.search``; fewer probes trade certified recall
(``recall_proxy``) for O(S + probes * N/S) work per query.
``search_sharded`` banks the sets over a mesh's bank axis and merges the
per-bank candidates as ``am.search_sharded`` does.
"""

from repro_torch.index.ivf import (
    IndexSpec,
    IVFIndex,
    IVFSearchResult,
    append,
    build,
    search,
    search_sharded,
)
from repro_torch.index.partition import (
    METHODS,
    assign,
    hyperplane_centroids,
    kmeans_centroids,
    train_centroids,
)

__all__ = [
    "METHODS",
    "IVFIndex",
    "IndexSpec",
    "IVFSearchResult",
    "append",
    "assign",
    "build",
    "hyperplane_centroids",
    "kmeans_centroids",
    "search",
    "search_sharded",
    "train_centroids",
]
