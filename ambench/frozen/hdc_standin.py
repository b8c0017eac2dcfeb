"""The ISOLET stand-in of the HDC application, and its quantizer.

Copied from ``src/repro_torch/data/hdc_data.py`` (``make_dataset`` at
``TABLE_III["isolet"]``): a Gaussian mixture with ISOLET's published shape,
617 features and 26 classes, 6,238 training and 1,559 test rows, its class
centres N(0, 1) and a low-rank within-class mixing, noise 4.6, all drawn
from PCG64 seed 101 in that order.  The thresholds are the 3-bit Z-score
quantizer's (``src/repro_torch/core/quantize.py``'s
``gaussian_thresholds_np(3)``, float32).
"""

from __future__ import annotations

import numpy as np

FEATURES, CLASSES = 617, 26
TRAIN_ROWS, TEST_ROWS = 6238, 1559
NOISE = 4.6
SEED = 101

#: Equal-probability quantiles of N(0, 1) at 3 bits, float32.
THRESHOLDS_3BIT = (-1.1503493785858154, -0.6744897365570068,
                   -0.3186393678188324, 0.0, 0.3186393678188324,
                   0.6744897365570068, 1.1503493785858154)


def dataset() -> dict:
    """The stand-in: ``centers`` (K, n) and ``mix`` (n, n) float64, and
    ``x_train``, ``y_train``, ``x_test``, ``y_test`` (float32, int32)."""
    rng = np.random.Generator(np.random.PCG64(SEED))
    centers = rng.normal(0, 1, (CLASSES, FEATURES))
    mix = rng.normal(0, 1, (FEATURES, FEATURES)) / np.sqrt(FEATURES)

    def sample(n):
        y = rng.integers(0, CLASSES, n)
        eps = rng.normal(0, 1, (n, FEATURES)) @ mix
        x = centers[y] + NOISE * eps
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(TRAIN_ROWS)
    x_te, y_te = sample(TEST_ROWS)
    return {"centers": centers, "mix": mix, "x_train": x_tr,
            "y_train": y_tr, "x_test": x_te, "y_test": y_te}


def zscore_codes(values: np.ndarray) -> np.ndarray:
    """Level codes of ``values`` by their Z-score over the whole array
    (mean and population deviation), at 3 bits: int32 in [0, 8)."""
    v = np.asarray(values, np.float64)
    z = (v - v.mean()) / (v.std() + 1e-12)
    thr = np.asarray(THRESHOLDS_3BIT, np.float64)
    return (z[..., None] > thr).sum(axis=-1).astype(np.int32)
