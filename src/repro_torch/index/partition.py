"""Row clustering for the set-associative index tier (centroid training).

Port of :mod:`repro.index.partition`.  Splits an
:class:`repro_torch.core.am.AMTable`'s rows into S sets by training S
centroid *codes* — multi-bit symbol words quantized through the paper's
CDF-equalized quantizer (:mod:`repro_torch.core.quantize`), so the coarse
pass of :mod:`repro_torch.index.ivf` searches centroids with exactly the
same multi-bit machinery as the data itself.

Two trainers, both host-side numpy as in the reference, so the seeded
``np.random.default_rng`` draws and the float arithmetic replay it bitwise:

* :func:`kmeans_centroids` — Lloyd's iterations in the dequantized
  (z-score) space, empty clusters re-seeded to the worst-served row, final
  centroids re-quantized to level codes.  O(N·S·D) host work a step: at
  2^20 rows and 1,024 sets that is tens of seconds, so large tables use
  the hyperplane trainer.
* :func:`hyperplane_centroids` — random-hyperplane (sign-LSH) bucketing of
  the dequantized rows; bucket means become the centroids.  Cheaper, no
  iteration, the classic HDC-friendly baseline.

Either way the *partition itself* is defined by :func:`assign`, NOT by the
trainer's own bucketing: a row belongs to the set whose **quantized
centroid code** is nearest under the table's digital distance, ties to the
lowest set id.  This is the same rule the coarse search applies to queries,
which guarantees that a query equal to a stored row always probes that
row's set first.  :func:`assign` runs one k = 1 search of the rows against
the (S, D) centroid table on the rows' device: on the GPU the fused
``cam_search_topk`` kernel, on the CPU its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import am, quantize
from repro_torch.device import device_of

METHODS = ("kmeans", "hyperplane")


def _dequantize_rows(codes: np.ndarray, bits: int) -> np.ndarray:
    """(N, D) level codes -> (N, D) float32 bin-representative z-values."""
    reps = quantize.level_representatives(bits, device="cpu").numpy()
    return reps[codes].astype(np.float32)


def _quantize_centroids(cent: np.ndarray, bits: int) -> np.ndarray:
    """Float centroids (already in z-space) -> (S, D) int32 level codes.

    ``mu=0, sigma=1`` because the centroids are means of level
    representatives of a standard normal — re-standardising over the S
    centroid values would warp them off the data's quantization grid.
    """
    return quantize.quantize(torch.from_numpy(cent), bits, mu=0.0,
                             sigma=1.0).numpy()


def _host_codes(codes) -> np.ndarray:
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    return np.asarray(codes, np.int32)


def kmeans_centroids(codes, sets: int, *, bits: int, iters: int = 10,
                     seed: int = 0) -> np.ndarray:
    """Train S centroid codes by k-means over the dequantized rows.

    Args:
      codes: (N, D) integer level codes (the table's rows; a tensor is
        copied to the host).
      sets: number of centroids S (1 <= S <= N).
      bits: bits per symbol of ``codes``.
      iters: Lloyd's iterations (assignment in float L2, empty clusters
        re-seeded to the row farthest from its current centroid).
      seed: deterministic init (distinct random rows as initial centroids).

    Returns:
      (S, D) int32 quantized centroid codes.
    """
    codes = _host_codes(codes)
    n = codes.shape[0]
    if not 1 <= sets <= n:
        raise ValueError(f"sets must be in [1, rows={n}], got {sets}")
    x = _dequantize_rows(codes, bits)
    rng = np.random.default_rng(seed)
    cent = x[rng.choice(n, size=sets, replace=False)].copy()
    for _ in range(iters):
        # (N, S) squared distances without the (N, S, D) broadcast
        d2 = ((x ** 2).sum(1)[:, None] - 2.0 * x @ cent.T
              + (cent ** 2).sum(1)[None, :])
        owner = d2.argmin(axis=1)
        for s in range(sets):
            mine = owner == s
            if mine.any():
                cent[s] = x[mine].mean(axis=0)
            else:
                cent[s] = x[d2[np.arange(n), owner].argmax()]
    return _quantize_centroids(cent, bits)


def hyperplane_centroids(codes, sets: int, *, bits: int,
                         seed: int = 0) -> np.ndarray:
    """Train S centroid codes by random-hyperplane (sign-LSH) bucketing.

    ``ceil(log2(S))`` random gaussian hyperplanes hash each dequantized row
    to a bucket; bucket means (mod S, so every row lands in a valid set even
    when S is not a power of two) become the centroids.  Buckets that caught
    no rows fall back to random rows, so all S centroids are always
    populated.

    Args:
      codes: (N, D) integer level codes (a tensor is copied to the host).
      sets: number of centroids S (1 <= S <= N).
      bits: bits per symbol of ``codes``.
      seed: seeds both the hyperplanes and the empty-bucket fallback.

    Returns:
      (S, D) int32 quantized centroid codes.
    """
    codes = _host_codes(codes)
    n, d = codes.shape
    if not 1 <= sets <= n:
        raise ValueError(f"sets must be in [1, rows={n}], got {sets}")
    x = _dequantize_rows(codes, bits)
    rng = np.random.default_rng(seed)
    n_planes = max(1, int(np.ceil(np.log2(sets))))
    planes = rng.standard_normal((n_planes, d)).astype(np.float32)
    bucket = ((x @ planes.T > 0.0)
              @ (1 << np.arange(n_planes))).astype(np.int64) % sets
    cent = np.empty((sets, d), np.float32)
    for s in range(sets):
        mine = bucket == s
        cent[s] = x[mine].mean(axis=0) if mine.any() else x[rng.integers(n)]
    return _quantize_centroids(cent, bits)


def train_centroids(codes, sets: int, *, bits: int, method: str = "kmeans",
                    seed: int = 0, iters: int = 10) -> np.ndarray:
    """Dispatch to a centroid trainer by name (one of :data:`METHODS`)."""
    if method == "kmeans":
        return kmeans_centroids(codes, sets, bits=bits, iters=iters,
                                seed=seed)
    if method == "hyperplane":
        return hyperplane_centroids(codes, sets, bits=bits, seed=seed)
    raise ValueError(f"unknown partition method {method!r}; "
                     f"expected one of {METHODS}")


def nearest(centroids, codes, *, bits: int, distance: str, device=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's nearest centroid and its distance: ((M,) int32 set ids,
    (M,) float32 exact digital distances), on the rows' device.

    One k = 1 search of the M rows against the (S, D) centroid table with
    the ``"cuda"`` backend: the fused kernel on a GPU, its plain version on
    the CPU.  Both rank by ascending (distance, set id), the order of the
    reference's ``lax.top_k``, so the set is :func:`assign`'s and the
    distance is the row's exact distance to it.
    """
    dev = device_of(codes, device=device)
    ct = am.make_table(centroids, bits=bits, distance=distance, device=dev)
    res = am.search(ct, codes, k=1, backend="cuda")
    return res.indices[:, 0], res.distances[:, 0]


def assign(centroids, codes, *, bits: int, distance: str,
           device=None) -> np.ndarray:
    """Set id of each row: nearest quantized centroid, lowest-id tie-break.

    THE partition rule — identical to the coarse search's probe ranking
    (exact digital distances + a stable ascending order), so a stored row
    and a duplicate query always agree on the top-1 set.

    Args:
      centroids: (S, D) int32 quantized centroid codes.
      codes: (M, D) integer level codes to place (numpy or a tensor).
      bits: bits per symbol.
      distance: ``"hamming"`` or ``"l1"`` — the owning table's metric.
      device: where the search runs; ``None`` means the device of
        ``codes`` when it is a tensor, else the GPU.

    Returns:
      (M,) int64 set ids in [0, S), on the host.
    """
    owner, _ = nearest(centroids, codes, bits=bits, distance=distance,
                       device=device)
    return owner.cpu().numpy().astype(np.int64)
