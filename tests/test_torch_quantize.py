"""Port parity: repro_torch.core.quantize against repro.core.quantize.

Thresholds and representatives are computed by the same numpy code, so
they must be bit-identical; quantize/dequantize must agree bitwise on the
same numpy inputs (explicit statistics, and the default global ones).
"""

import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro_torch.core import quantize as tq

torch.set_num_threads(2)

BITS = [1, 2, 3, 4]


@pytest.mark.parametrize("bits", BITS)
def test_thresholds_and_representatives_bit_identical(bits):
    np.testing.assert_array_equal(tq.gaussian_thresholds_np(bits),
                                  jq.gaussian_thresholds_np(bits))
    t = tq.gaussian_thresholds(bits, device="cpu")
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(jq.gaussian_thresholds(bits)))
    r = tq.level_representatives(bits, device="cpu")
    assert r.dtype == torch.float32
    np.testing.assert_array_equal(r.numpy(),
                                  np.asarray(jq.level_representatives(bits)))


@pytest.mark.parametrize("bits", BITS)
def test_quantize_explicit_stats_bitwise(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(33, 65)).astype(np.float32) * 2.5 + 0.75
    mu, sigma = np.float32(0.75), np.float32(2.5)
    want = np.asarray(jq.quantize(x, bits, mu=mu, sigma=sigma))
    got = tq.quantize(torch.from_numpy(x), bits, mu=mu, sigma=sigma)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_default_stats_bitwise(axis):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(40, 24)).astype(np.float32)
    want = np.asarray(jq.quantize(x, 3, axis=axis))
    got = tq.quantize(torch.from_numpy(x), 3, axis=axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [1, 3])
def test_dequantize_bitwise(bits):
    rng = np.random.default_rng(5)
    levels = rng.integers(0, 1 << bits, (17, 9)).astype(np.int32)
    want = np.asarray(jq.dequantize(levels, bits, 0.1, 2.7))
    got = tq.dequantize(torch.from_numpy(levels), bits, 0.1, 2.7)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # round trip: representatives quantize back to their own level
    reps = tq.level_representatives(bits, device="cpu")
    np.testing.assert_array_equal(
        tq.quantize(reps, bits, mu=0.0, sigma=1.0).numpy(),
        np.arange(1 << bits))
