"""Z-score (CDF-equalized) non-linear quantization (paper Sec. IV-B).

Port of :mod:`repro.core.quantize`.  Hypervector elements after
random-projection encoding are ~Gaussian; each element is quantized to
b bits by its Z-score over that Gaussian, with thresholds at
equal-probability quantiles so every level is used equally often.

The thresholds and representatives are computed in numpy by the same code
as the reference, so they are bit-identical to it.

``quantize``    value -> level index in [0, 2**bits)
``dequantize``  level index -> representative value (conditional mean of bin)
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _ndtri(p: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam rational approximation, |err|<1e-9)."""
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
    """(2**bits - 1,) float32 equal-probability quantile thresholds (numpy)."""
    m = 1 << bits
    qs = np.arange(1, m) / m
    return _ndtri(qs).astype(np.float32)


def _erf_np(x):
    # Abramowitz-Stegun 7.1.26, vectorised; adequate for representative values.
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
              - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def _level_representatives_np(bits: int) -> np.ndarray:
    edges = np.concatenate([[-np.inf], gaussian_thresholds_np(bits), [np.inf]])
    # E[Z | a<Z<b] = (phi(a)-phi(b)) / (Phi(b)-Phi(a));  phi = standard pdf
    phi = lambda x: np.where(np.isinf(x), 0.0, np.exp(-0.5 * x ** 2) / math.sqrt(2 * math.pi))
    cdf = lambda x: np.where(x == -np.inf, 0.0, np.where(x == np.inf, 1.0,
                             0.5 * (1 + _erf_np(x / math.sqrt(2)))))
    reps = (phi(edges[:-1]) - phi(edges[1:])) / (cdf(edges[1:]) - cdf(edges[:-1]))
    return reps.astype(np.float32)


def gaussian_thresholds(bits: int, device=None) -> torch.Tensor:
    """(2**bits - 1,) float32 thresholds in sigma units, on ``device``."""
    return torch.as_tensor(gaussian_thresholds_np(bits), device=device)


def level_representatives(bits: int, device=None) -> torch.Tensor:
    """(2**bits,) float32 conditional means E[Z | bin] of a standard normal."""
    return torch.as_tensor(_level_representatives_np(bits), device=device)


def quantize(x: torch.Tensor, bits: int, *, mu=None, sigma=None,
             axis=None) -> torch.Tensor:
    """Quantize ``x`` to 2**bits CDF-equalized levels via its Z-score.

    mu/sigma default to the mean and population standard deviation of
    ``x`` over ``axis`` (None = global).  Runs on ``x``'s device.
    Returns int32 level indices.
    """
    x = torch.as_tensor(x)
    if mu is None:
        mu = (x.mean() if axis is None else x.mean(dim=axis, keepdim=True))
    if sigma is None:
        sigma = (x.std(correction=0) if axis is None
                 else x.std(dim=axis, correction=0, keepdim=True)) + 1e-12
    mu = torch.as_tensor(mu, dtype=x.dtype, device=x.device)
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    z = (x - mu) / sigma
    thr = gaussian_thresholds(bits, device=x.device)
    # level = number of thresholds below z
    return (z[..., None] > thr).sum(dim=-1, dtype=torch.int32)


def dequantize(levels: torch.Tensor, bits: int, mu: float = 0.0,
               sigma: float = 1.0) -> torch.Tensor:
    """Map level indices back to representative values (bin conditional means).

    ``rep * sigma + mu`` is rounded once, as the reference's compiled
    multiply-add rounds it: the product of float32 operands is exact in
    float64.
    """
    levels = torch.as_tensor(levels)
    reps = level_representatives(bits, device=levels.device)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                    device=levels.device).double()
    return (reps[levels.long()].double() * f32(sigma) + f32(mu)).float()
