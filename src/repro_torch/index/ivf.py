"""IVF-style set-associative index over ``AMTable`` — sub-linear search.

Port of :mod:`repro.index.ivf`.  Every ``am.search``
backend scans all N rows per query.  This module makes the scan
*set-associative*, the way a multi-bank MCAM goes sub-linear: rows are
partitioned into S sets around quantized centroid codes
(:mod:`repro_torch.index.partition`), a **coarse** pass ranks the S
centroids with exact digital distances (one dense search over an (S, D)
table), and the **fine** pass runs the real backend — including the fused
``cam_search_topk`` kernel — only over the ``probes`` top-ranked sets'
row slabs.  Work per query drops from O(N) to O(S + probes * N/S); with
balanced sets and ``S ~ sqrt(N)`` that is O(sqrt(N)).

Exactness anatomy (why ``probes = S`` is *bitwise* the flat search):

* every row lives in exactly one set, and within a set's slab rows are
  stored in ascending global-row-id order — so the fused kernel's
  slab-position tie-break IS the global-id tie-break within a set;
* per-row distances are pure functions of (query, row) for every supported
  backend, so placing a row in a slab cannot change its distance;
* cross-set candidates merge by the two-key order (distance, global row
  id) — exactly the flat search's ordering over the dense matrix.

With ``probes < S`` the search is approximate; :class:`IVFSearchResult`
carries a per-query ``recall_proxy`` — the fraction of returned candidates
whose distance is *certified* correct by the triangle inequality
(``d(q, x) >= d(q, c_s) - r_s`` for any row x of an unprobed set s, with
``r_s`` the set's build-time covering radius in exact digital units).
``probes = S`` certifies everything (proxy 1.0).

How the port differs from the reference, in how and never in what:

* **The fine pass runs set by set.**  The reference gathers a (Q, P, C, D)
  slab per query and vmaps the kernel over (query, probed set).  At 1,024
  queries, 8 probes and 1,100-row slabs of 256 symbols that gather is
  about 9 GB.  Here the (query, probe) pairs are grouped by set instead,
  and each set some query probes takes one search of its contiguous slab
  with exactly the queries that probe it (``valid_rows`` = the set's
  size).  A query's top-k within a set depends only on that query and that
  slab, so this is bitwise the reference.  The cost: one ``cam_pack`` and
  one search launch per distinct probed set, and one host read of the
  probe ranking per search to group the pairs.
* **The coarse pass runs where the queries are.**  On the GPU the dense
  ``cam_search`` kernel scores the centroids (bitwise the plain rule on
  in-range codes); on the CPU the plain ``"ref"`` backend does.  A GPU
  tensor never reaches a plain version.
* **The build takes each row's set and its distance from one k = 1 search**
  (:func:`repro_torch.index.partition.nearest`) and the covering radius as
  the maximum of those distances per set — the reference's ``(N, S)``
  distance matrix would be 4 GiB at 2^20 rows and 1,024 sets.

Backends whose output depends on the table's shape or global row position
(an analog backend with variation) are not supported, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import am
from repro_torch.index import partition


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Recipe for a table's index tier — how the serving layer builds one.

    ``AMService.create_table(..., index=IndexSpec(sets=32, probes=4))``
    routes that table's dispatches through an :class:`IVFIndex`
    transparently: the service builds the index lazily once the table holds
    ``build_threshold`` live rows (k-means over a handful of rows is
    noise), extends it incrementally on appends, and rebuilds it after any
    compaction (eviction / delete renumbers global row ids).

    Attributes:
      sets: number of sets S.
      probes: coarse sets fine-searched per query (1 <= probes <= sets;
        ``probes == sets`` makes the indexed path bitwise the exact one).
      method: centroid trainer, one of
        :data:`repro_torch.index.partition.METHODS`.
      seed: deterministic trainer seed.
      iters: k-means iterations.
      min_rows: live-row count that triggers the lazy build; ``None``
        means ``4 * sets``.  A bulk fill sets it to the fill's size, so the
        build runs once, after the fill, instead of every later chunk
        going through :func:`append`.
    """

    sets: int
    probes: int
    method: str = "kmeans"
    seed: int = 0
    iters: int = 10
    min_rows: int | None = None

    @property
    def build_threshold(self) -> int:
        """Live rows needed before the index is (re)built."""
        base = 4 * self.sets if self.min_rows is None else self.min_rows
        return max(self.sets, base)

    def validate(self) -> None:
        """Raise :class:`ValueError` on an unusable spec."""
        if self.sets < 1:
            raise ValueError(f"index sets must be >= 1, got {self.sets}")
        if not 1 <= self.probes <= self.sets:
            raise ValueError(
                f"index probes must be in [1, sets={self.sets}], "
                f"got {self.probes}")
        if self.method not in partition.METHODS:
            raise ValueError(
                f"unknown partition method {self.method!r}; "
                f"expected one of {partition.METHODS}")


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    """Immutable set-associative index over one table; all on one device.

    * ``centroids``  (S, D) int32 quantized centroid codes — the coarse table.
    * ``slabs``      (S, C, D) int32 per-set row slabs; within a set, rows
      sit in ascending global-row-id order (the fused-tier exactness
      invariant); dead slots hold zeros.
    * ``row_ids``    (S, C) int32 global row ids; dead slots hold
      ``am._IDX_SENTINEL`` so they can never outrank a real candidate.
    * ``set_sizes``  (S,) int32 live rows per set.
    * ``set_radius`` (S,) float32 covering radius — max member->centroid
      distance in exact digital units (the triangle-bound certificate).

    ``bits`` / ``distance`` carry over from the indexed table.
    """

    centroids: torch.Tensor
    slabs: torch.Tensor
    row_ids: torch.Tensor
    set_sizes: torch.Tensor
    set_radius: torch.Tensor
    bits: int = 3
    distance: str = "hamming"

    @property
    def sets(self) -> int:
        """Number of sets S."""
        return self.slabs.shape[0]

    @property
    def set_capacity(self) -> int:
        """Slab width C — max rows one set can hold before a rebuild."""
        return self.slabs.shape[1]

    @property
    def width(self) -> int:
        """Word width D in multi-bit symbols."""
        return self.slabs.shape[2]

    @property
    def device(self) -> torch.device:
        """The device every tensor of the index lives on."""
        return self.slabs.device

    @property
    def n_rows(self) -> int:
        """Total live rows (reads ``set_sizes`` back to the host)."""
        return int(self.set_sizes.sum())

    def centroid_table(self) -> am.AMTable:
        """The (S, D) coarse table the probe ranking searches."""
        return am.make_table(self.centroids, bits=self.bits,
                             distance=self.distance, device=self.device)


@dataclasses.dataclass(frozen=True)
class IVFSearchResult:
    """An :class:`am.AMSearchResult` plus the index tier's per-query metadata.

    ``result`` follows the flat-search contract exactly (best-first,
    (distance, row) tie-break); the extra fields quantify what the probe
    budget bought:

    * ``recall_proxy`` (Q,) float32 — fraction of the returned finite
      candidates certified exact by the triangle bound (1.0 at probes=S).
    * ``probed_sets`` (Q, P) int32 — which sets each query probed,
      best-first.
    * ``candidate_fraction`` (Q,) float32 — probed live candidates / total
      live rows, the work actually done relative to a flat scan.
    """

    result: am.AMSearchResult
    recall_proxy: torch.Tensor
    probed_sets: torch.Tensor
    candidate_fraction: torch.Tensor

    # -- delegation: an IVFSearchResult reads like an AMSearchResult --------

    @property
    def indices(self):
        """(Q, k) int32 global row indices, best-first."""
        return self.result.indices

    @property
    def distances(self):
        """(Q, k) float32 distances in contract units."""
        return self.result.distances

    @property
    def exact(self):
        """(Q, k) bool exact-match flags."""
        return self.result.exact

    @property
    def matched(self):
        """(Q, k) bool threshold-match flags."""
        return self.result.matched

    @property
    def best_row(self):
        """(Q,) index of the single nearest row."""
        return self.result.best_row


# ---------------------------------------------------------------------------
# build / append (shape-changing, like am.delete)
# ---------------------------------------------------------------------------

def _place(slabs, row_ids, base, codes, ids, owner, dist, radius):
    """Write rows into their sets' slabs after ``base`` live rows each.

    Rows keep their order within a set (a stable sort by set), so ids
    ascending in ``ids`` stay ascending in every slab.  ``radius`` grows to
    each set's largest member distance.  Updates the tensors in place and
    returns the per-set counts of the placed rows.
    """
    s_n = slabs.shape[0]
    owner = owner.long()
    added = torch.bincount(owner, minlength=s_n)
    order = torch.argsort(owner, stable=True)
    own = owner[order]
    first = torch.cumsum(added, 0) - added            # rank 0 of each set
    pos = base[own] + torch.arange(order.numel(), device=slabs.device) \
        - first[own]
    slabs[own, pos] = codes[order]
    row_ids[own, pos] = ids[order]
    radius.scatter_reduce_(0, owner, dist, "amax")
    return added


def build(table: am.AMTable, *, sets: int, method: str = "kmeans",
          seed: int = 0, iters: int = 10,
          set_capacity: int | None = None) -> IVFIndex:
    """Build an :class:`IVFIndex` over every row of ``table``, on its device.

    Global row id == row position in ``table`` (the returned indices are
    directly comparable to ``am.search`` over the same table).  Training
    runs on the host (numpy, as the reference); the assignment and the
    slabs run on the table's device.

    Args:
      table: the code store to index (its ``bits``/``distance`` carry over).
      sets: number of sets S (1 <= S <= rows).
      method: centroid trainer — ``"kmeans"`` or ``"hyperplane"``
        (:data:`repro_torch.index.partition.METHODS`).
      seed: deterministic training seed.
      iters: k-means iterations (ignored for ``"hyperplane"``).
      set_capacity: slab width C; defaults to the largest set's size.  A
        later :func:`append` that overflows C reallocates the slabs.

    Returns:
      A new immutable :class:`IVFIndex`.
    """
    n, d = table.codes.shape
    if n == 0:
        raise ValueError("cannot index an empty table (0 rows)")
    dev = table.device
    centroids = partition.train_centroids(table.codes, sets, bits=table.bits,
                                          method=method, seed=seed,
                                          iters=iters)
    # one k = 1 search gives each row's set and its distance to that set's
    # centroid: the reference's (N, S) matrix is never built
    owner, dist = partition.nearest(centroids, table.codes, bits=table.bits,
                                    distance=table.distance, device=dev)
    largest = int(torch.bincount(owner.long(), minlength=sets).max())
    cap = max(1, largest) if set_capacity is None else set_capacity
    if cap < largest:
        raise ValueError(f"set_capacity {cap} < largest set "
                         f"({largest} rows)")
    cap = max(1, cap)
    slabs = torch.zeros((sets, cap, d), dtype=torch.int32, device=dev)
    row_ids = torch.full((sets, cap), am._IDX_SENTINEL, dtype=torch.int32,
                         device=dev)
    radius = torch.zeros((sets,), dtype=torch.float32, device=dev)
    sizes = _place(slabs, row_ids, torch.zeros(sets, dtype=torch.long,
                                               device=dev),
                   table.codes, torch.arange(n, dtype=torch.int32,
                                             device=dev),
                   owner, dist, radius)
    return IVFIndex(centroids=torch.from_numpy(centroids).to(dev),
                    slabs=slabs, row_ids=row_ids,
                    set_sizes=sizes.to(torch.int32), set_radius=radius,
                    bits=table.bits, distance=table.distance)


def append(index: IVFIndex, codes, *, start_row: int | None = None
           ) -> IVFIndex:
    """Place (M, D) new rows into their nearest sets; returns a new index.

    New rows get global ids ``start_row .. start_row + M - 1`` (defaulting
    to the current live count, matching ``am.append`` on the flat table) and
    land at their sets' slab ends — ids are monotonically increasing, so the
    in-set ascending-id invariant is preserved without re-sorting.  Covering
    radii only grow, so the triangle certificate stays sound.  Overflowing a
    set's slab reallocates every slab ~25% wider.

    Args:
      index: the index to extend (never mutated).
      codes: (M, D) — or a single (D,) — integer level codes.
      start_row: global id of the first appended row.

    Returns:
      A new :class:`IVFIndex` holding the old and new rows.
    """
    dev = index.device
    codes = am._tensor(codes, dev, torch.int32)
    if codes.dim() == 1:
        codes = codes[None]
    if codes.dim() != 2 or codes.shape[1] != index.width:
        raise ValueError(f"append codes shape {tuple(codes.shape)} != "
                         f"(m, {index.width})")
    m = codes.shape[0]
    if m == 0:
        return index
    sizes = index.set_sizes.long()
    start = int(sizes.sum()) if start_row is None else int(start_row)
    owner, dist = partition.nearest(index.centroids, codes, bits=index.bits,
                                    distance=index.distance, device=dev)
    grown = int((sizes + torch.bincount(owner.long(),
                                        minlength=index.sets)).max())
    old_cap = cap = index.set_capacity
    if grown > cap:
        cap = max(grown, cap + max(1, cap // 4))
    s_n, d = index.sets, index.width
    slabs = torch.zeros((s_n, cap, d), dtype=torch.int32, device=dev)
    row_ids = torch.full((s_n, cap), am._IDX_SENTINEL, dtype=torch.int32,
                         device=dev)
    slabs[:, :old_cap] = index.slabs
    row_ids[:, :old_cap] = index.row_ids
    radius = index.set_radius.clone()
    added = _place(slabs, row_ids, sizes, codes,
                   torch.arange(start, start + m, dtype=torch.int32,
                                device=dev), owner, dist, radius)
    return dataclasses.replace(index, slabs=slabs, row_ids=row_ids,
                               set_sizes=(sizes + added).to(torch.int32),
                               set_radius=radius)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _validate(index: IVFIndex, k: int, probes: int) -> None:
    """Reject unusable (k, probes) combinations with offender-naming errors."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if probes < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    if probes > index.sets:
        raise ValueError(
            f"probes={probes} exceeds the index's set count ({index.sets}); "
            f"pass probes <= sets (probes == sets is the exact search)")


def _coarse(index: IVFIndex, queries: torch.Tensor, probes: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank centroids with exact digital distances; derive the triangle bound.

    Exact distances regardless of the fine backend: the probe ranking must
    equal the partition's assignment rule, and the bound is only a
    certificate in exact metric units.  On the GPU the dense kernel scores
    the centroids; on the CPU its plain version does.  A stable ascending
    sort ranks them, the lowest set id first among equals (the order of the
    reference's ``lax.top_k``).

    Returns ``(probed (Q, P) int32 best-first set ids, bound (Q,) float32)``
    where ``bound`` lower-bounds the distance of every row in any
    *unprobed non-empty* set.
    """
    score = (am._cuda_backend if queries.device.type == "cuda"
             else am._ref_backend)
    cd = score(queries, index.centroids, index.bits,
               index.distance).to(torch.float32)              # (Q, S)
    probed = torch.sort(cd, dim=1, stable=True).indices[:, :probes]
    skip = torch.zeros_like(cd, dtype=torch.bool).scatter_(1, probed, True)
    skip |= index.set_sizes[None, :] == 0
    bound = torch.where(skip, torch.inf,
                        cd - index.set_radius[None, :]).min(dim=1).values
    return probed.to(torch.int32), bound


def _fine_candidates(be, queries: torch.Tensor, index: IVFIndex,
                     probed: torch.Tensor, kc: int, sets=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score the probed sets' slabs; return unsorted (dist, gid) candidates.

    The (query, probe) pairs are grouped by set — one host read of
    ``probed`` — and each set that some query probes is searched once, as
    its contiguous slab ``slabs[s]`` against exactly the queries that
    probe it: one :func:`am._candidates` of ``kc <= C`` rows with
    ``valid_rows`` = the set's size, on the tier :func:`am._fused_tier`
    picks.  The slab-position tie-break equals the global-id tie-break
    because in-set slabs are ascending-id (the build/append invariant),
    so a set's first ``kc`` hold every row of it that can reach the
    global top-k.  Empty sets give (+inf, ``_IDX_SENTINEL``) without a
    launch, as the kernel would, and so do the sets outside ``sets`` =
    (first, stop) when it is given: a bank of :func:`search_sharded`
    scores only the sets it owns.

    Returns (Q, P * kc) float32 distances and int32 global row ids in
    (query, probe) order.
    """
    q_n, p_n = probed.shape
    cap = index.set_capacity
    dev = queries.device
    pairs = probed.cpu().numpy().reshape(-1)                 # pair = q*P + p
    sizes = index.set_sizes.cpu().numpy()
    order = np.argsort(pairs, kind="stable")                 # grouped by set
    sets_in_order = pairs[order]
    cuts = np.flatnonzero(np.diff(sets_in_order)) + 1
    starts = np.concatenate([[0], cuts]).tolist()
    ends = np.concatenate([cuts, [pairs.size]]).tolist()
    order_t = torch.from_numpy(order).to(dev)
    q_pairs = queries[order_t // p_n]                        # (Q*P, D)
    dist = torch.full((pairs.size, kc), torch.inf, dtype=torch.float32,
                      device=dev)
    gid = torch.full((pairs.size, kc), am._IDX_SENTINEL, dtype=torch.int32,
                     device=dev)
    for a, b in zip(starts, ends):
        s = int(sets_in_order[a])
        size = int(sizes[s])
        if size == 0 or (sets is not None and not sets[0] <= s < sets[1]):
            continue
        il, dl, _ = am._candidates(be, q_pairs[a:b], index.slabs[s],
                                   index.bits, index.distance, k=kc,
                                   valid_rows=size)
        g = index.row_ids[s][il.long().clamp_(0, cap - 1)]
        dist[a:b] = dl
        gid[a:b] = torch.where(torch.isinf(dl), am._IDX_SENTINEL, g)
    out_d, out_g = torch.empty_like(dist), torch.empty_like(gid)
    out_d[order_t], out_g[order_t] = dist, gid           # back to pair order
    return out_d.reshape(q_n, p_n * kc), out_g.reshape(q_n, p_n * kc)


def _merge(dist: torch.Tensor, gid: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first k candidates per query by (distance, global id), padded.

    The reference's two-key ``lax.sort((dist, gid), num_keys=2)`` order
    (:func:`am._lex_sort`), then the cut to k and the (+inf, sentinel)
    padding.
    """
    dist, gid = am._lex_sort(dist, gid)
    return am._pad_candidates(dist[:, :k], gid[:, :k], k)


def _proxy(dist: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """(Q,) certified fraction of the finite returned candidates."""
    finite = torch.isfinite(dist)
    cert = finite & (dist <= bound[:, None])
    return (cert.sum(dim=1) / finite.sum(dim=1).clamp(min=1)).to(
        torch.float32)


def search(index: IVFIndex, queries, *, k: int = 1, probes: int = 1,
           threshold=None, backend=None) -> IVFSearchResult:
    """Probe the top-``probes`` sets per query; fine-search their slabs.

    Args:
      index: the set-associative index.
      queries: (Q, D) — or a single (D,) — integer symbol words.
      k: how many nearest rows to return (clamped to the index's total slab
        capacity — entries beyond the live candidates come back with +inf
        distance and index ``am._IDX_SENTINEL``).
      probes: how many coarse-ranked sets to fine-search
        (``probes == index.sets`` reproduces the flat ``am.search``
        bitwise).
      threshold: optional match radius, :func:`am.search` semantics.
      backend: registered backend name or ``None`` for the ``am`` default;
        fused-tier backends run their streaming kernel once per probed set.

    Returns:
      :class:`IVFSearchResult` — the :class:`am.AMSearchResult` plus
      ``recall_proxy`` / ``probed_sets`` / ``candidate_fraction`` metadata.

    While a profiler records, the three stages run in the spans
    ``ivf.coarse``, ``ivf.fine`` and ``ivf.merge`` (:mod:`repro_torch.obs`).
    """
    _validate(index, k, probes)
    be = am._resolve_backend(backend)
    queries, squeeze = am._prep_queries(index.centroid_table(), queries)
    k_eff = min(k, index.sets * index.set_capacity)
    with obs.span("ivf.coarse"):
        probed, bound = _coarse(index, queries, probes)
    kc = min(k_eff, index.set_capacity)          # no set holds more
    am._note_fallback(be, kc, False)
    with obs.span("ivf.fine"):
        dist, gid = _fine_candidates(be, queries, index, probed, kc)
    with obs.span("ivf.merge"):
        dist, gid = _merge(dist, gid, k_eff)
    res = am._finalize(gid, dist, threshold, squeeze)
    proxy = _proxy(dist, bound)
    frac = (index.set_sizes[probed.long()].sum(dim=1)
            / index.set_sizes.sum().clamp(min=1)).to(torch.float32)
    if squeeze:
        proxy, probed, frac = proxy[0], probed[0], frac[0]
    return IVFSearchResult(result=res, recall_proxy=proxy,
                           probed_sets=probed, candidate_fraction=frac)


def search_sharded(index: IVFIndex, queries, *, mesh, rules=None, k: int = 1,
                   probes: int = 1, threshold=None, backend=None,
                   merge: str = "auto") -> IVFSearchResult:
    """Set-banked probe search over a mesh's bank axis.

    The sets split over the banks (:meth:`Rules.am_index`): each bank owns
    a contiguous run of ``ceil(S / banks)`` whole sets.  The coarse pass
    runs once, replicated (an (S, D) table ~rows/sets smaller than the
    data); each bank fine-scores only the probed sets it owns, by the same
    per-set grouping as :func:`search` (other probes give (+inf,
    sentinel) candidates), sorts its candidates by (distance, global row
    id) and keeps the first ``k``; the per-bank lists then reduce through
    the same merges as the flat ``am.search_sharded``
    (:func:`am._merge_bank_candidates`).  Bitwise :func:`search` for every
    merge and bank count; each probed set is still searched once, by its
    owner.

    Args:
      index, queries, k, probes, threshold, backend: :func:`search`
        semantics.
      mesh: a :mod:`repro_torch.dist` mesh; its ``rules.tp`` axis is the
        set-bank axis.
      rules: optional :class:`repro_torch.dist.Rules`; defaults to
        ``make_rules(mesh, "tp")``.
      merge: ``am.search_sharded`` semantics.

    Returns:
      :class:`IVFSearchResult`, bitwise :func:`search`.
    """
    from repro_torch.dist import specs as dist_specs

    _validate(index, k, probes)
    rules = rules or dist_specs.make_rules(mesh, "tp")
    axis = rules.tp
    n_banks = mesh.shape[axis]
    be = am._resolve_backend(backend)
    queries, squeeze = am._prep_queries(index.centroid_table(), queries)
    k_eff = min(k, index.sets * index.set_capacity)
    strategy = am.resolve_merge(merge, n_banks, k_eff)
    probed, bound = _coarse(index, queries, probes)
    s_local = -(-index.sets // n_banks)
    kc = min(k_eff, index.set_capacity)
    am._note_fallback(be, kc, False)
    dists, gids = [], []
    for b in mesh.banks(axis):
        dist, gid = _fine_candidates(be, queries, index, probed, kc,
                                     sets=(b * s_local, (b + 1) * s_local))
        dist, gid = am._lex_sort(dist, gid)
        k_local = min(k_eff, dist.shape[1])
        dists.append(dist[:, :k_local])
        gids.append(gid[:, :k_local])
    gid, dist = am._merge_bank_candidates(
        torch.stack(dists), torch.stack(gids), mesh=mesh, axis=axis,
        n_banks=n_banks, k=k_eff, strategy=strategy)
    dist, gid = am._pad_candidates(dist[0], gid[0], k_eff)
    res = am._finalize(gid, dist, threshold, squeeze)
    proxy = _proxy(dist, bound)
    frac = (index.set_sizes[probed.long()].sum(dim=1)
            / index.set_sizes.sum().clamp(min=1)).to(torch.float32)
    if squeeze:
        proxy, probed, frac = proxy[0], probed[0], frac[0]
    return IVFSearchResult(result=res, recall_proxy=proxy,
                           probed_sets=probed, candidate_fraction=frac)
