"""The arithmetic of the CUDA ``hdc_encode`` kernel's 3xTF32 product, on the
CPU.

The kernel splits each float32 operand into two TF32 parts and
accumulates three tensor-core products (``csrc/hdc_encode.cu``).
:mod:`repro_torch.kernels.hdc_encode.ref` emulates that split and the
3xTF32 and single-TF32 products with float32 matrix products; these tests
hold the emulation to:

* the split: ``hi + lo`` is x to within 2^-21 of ``|x|`` (the dropped
  rest is below 2^-22), and both parts have TF32's 13 low bits clear;
* the reference tolerance (under 0.5 % of codes differ, none by more than
  one level) against the JAX package's Pallas kernel in interpret mode, at
  the reference test's shapes;
* the sharper gate of ``chip_smoke.py``: at a 512-row slice of each
  Table III shape, the 3xTF32 codes differ from the plain float32 codes in
  at most ``ENCODE_FP32_FRACTION`` of places and the single TF32 product's
  in more, so the gate can fail a plain TF32 kernel.
"""

import numpy as np
import pytest
import torch

from repro.kernels.hdc_encode import ops as j_enc_ops
from repro_torch.core import quantize as q
from repro_torch.kernels.hdc_encode import kernel as enc_kernel
from repro_torch.kernels.hdc_encode import ref as enc_ref

torch.set_num_threads(2)


def _codes(x, proj, bits, terms):
    thr = q.gaussian_thresholds(bits, device="cpu")
    h = enc_ref.tf32_product(x, proj, terms)
    return enc_ref.codes_from_product(h, x, thr)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5, 1e30])
def test_split_reconstructs_x(scale):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((scale * rng.normal(size=4096)).astype(np.float32))
    hi, lo = enc_ref.tf32_split(x)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    # hi alone is x to TF32's precision, rounded to nearest
    assert bool(((hi.double() - x.double()).abs()
                 <= 2.0 ** -11 * x.double().abs()).all())


def test_split_rounds_to_nearest_ties_away():
    # 1 + 2^-11 is half a TF32 ulp above 1: a tie, rounded away from zero
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      1 + 3 * 2.0 ** -12], dtype=torch.float32)
    hi, lo = enc_ref.tf32_split(x)
    want = torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                         1 + 2.0 ** -10], dtype=torch.float32)
    assert torch.equal(hi, want)
    assert torch.equal(hi + lo, x)


@pytest.mark.parametrize("bits", [1, 2, 3])
@pytest.mark.parametrize("b,n,d", [
    (1, 4, 16), (5, 30, 100), (8, 128, 512), (130, 617, 1024), (64, 75, 333),
])
def test_3xtf32_codes_meet_reference_tolerance(bits, b, n, d):
    rng = np.random.default_rng(b + n + d + bits)
    x = rng.normal(size=(b, n)).astype(np.float32)
    proj = rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(j_enc_ops.encode_quantize(x, proj, bits,
                                                interpret=True))
    got = _codes(torch.from_numpy(x), torch.from_numpy(proj), bits, 3)
    assert got.dtype == torch.int32 and got.shape == (b, d)
    got = got.numpy()
    assert (got != want).mean() < 5e-3
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("n", [617, 561, 75])
def test_fp32_gate_separates_3xtf32_from_tf32(n):
    """512 rows of a Table III shape (n features, D = 1,024), 3 bits."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(512, n)).astype(np.float32))
    proj = torch.from_numpy(rng.normal(size=(n, 1024)).astype(np.float32))
    thr = q.gaussian_thresholds(3, device="cpu")
    plain = enc_ref.encode_quantize(x, proj, thr)
    limit = enc_kernel.ENCODE_FP32_FRACTION
    fracs = {}
    for terms in (3, 1):
        got = _codes(x, proj, 3, terms)
        diff = (got.long() - plain.long()).abs()
        assert int(diff.max()) <= 1
        fracs[terms] = (diff != 0).double().mean().item()
    assert fracs[3] <= limit < fracs[1], fracs
    # the single TF32 product misses by a wide margin, not by a hair
    assert fracs[1] > 10 * limit, fracs


def test_tf32_product_rejects_other_term_counts():
    x = torch.ones((2, 3))
    with pytest.raises(ValueError, match="terms"):
        enc_ref.tf32_product(x, x.T, 2)
