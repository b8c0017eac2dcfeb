"""The hyperplane partition of the index tier, for the plain reference.

Copied from ``src/repro_torch/index/partition.py`` (``_dequantize_rows``,
``hyperplane_centroids``, ``_quantize_centroids``) and
``src/repro_torch/core/quantize.py`` (``_ndtri``, ``gaussian_thresholds_np``,
``_erf_np``, ``_level_representatives_np``), all host numpy.  The centroid
quantizer is written in numpy here: with ``mu=0`` and ``sigma=1`` the
program's ``(x - mu) / sigma`` is ``x`` exactly, so a level is the number of
thresholds below the value, as there.  What the program does on the device
(each row's nearest centroid, the probe ranking) the reference works out
itself from these centroids.
"""

from __future__ import annotations

import math

import numpy as np


def _ndtri(p: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam rational approximation)."""
    p = np.asarray(p, np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    out = np.empty_like(p)
    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)
    q = np.sqrt(-2 * np.log(p[lo]))
    out[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
              ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p[mid] - 0.5
    r = q * q
    out[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    q = np.sqrt(-2 * np.log(1 - p[hi]))
    out[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    return out


def gaussian_thresholds_np(bits: int) -> np.ndarray:
    """(2**bits - 1,) float32 equal-probability quantile thresholds."""
    m = 1 << bits
    qs = np.arange(1, m) / m
    return _ndtri(qs).astype(np.float32)


def _erf_np(x):
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
              - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def level_representatives(bits: int) -> np.ndarray:
    """(2**bits,) float32 conditional means E[Z | bin] of a standard normal."""
    edges = np.concatenate([[-np.inf], gaussian_thresholds_np(bits), [np.inf]])
    phi = lambda x: np.where(np.isinf(x), 0.0,
                             np.exp(-0.5 * x ** 2) / math.sqrt(2 * math.pi))
    cdf = lambda x: np.where(x == -np.inf, 0.0, np.where(
        x == np.inf, 1.0, 0.5 * (1 + _erf_np(x / math.sqrt(2)))))
    reps = (phi(edges[:-1]) - phi(edges[1:])) / (cdf(edges[1:])
                                                 - cdf(edges[:-1]))
    return reps.astype(np.float32)


def hyperplane_centroids(codes: np.ndarray, sets: int, *, bits: int,
                         seed: int = 0) -> np.ndarray:
    """(S, D) int32 centroid codes by random-hyperplane (sign-LSH) bucketing
    of the dequantized rows; buckets that caught no row take a random row."""
    codes = np.asarray(codes, np.int32)
    n, d = codes.shape
    if not 1 <= sets <= n:
        raise ValueError(f"sets must be in [1, rows={n}], got {sets}")
    x = level_representatives(bits)[codes].astype(np.float32)
    rng = np.random.default_rng(seed)
    n_planes = max(1, int(np.ceil(np.log2(sets))))
    planes = rng.standard_normal((n_planes, d)).astype(np.float32)
    bucket = ((x @ planes.T > 0.0)
              @ (1 << np.arange(n_planes))).astype(np.int64) % sets
    cent = np.empty((sets, d), np.float32)
    for s in range(sets):
        mine = bucket == s
        cent[s] = x[mine].mean(axis=0) if mine.any() else x[rng.integers(n)]
    thr = gaussian_thresholds_np(bits)
    return (cent[..., None] > thr).sum(axis=-1, dtype=np.int32)
