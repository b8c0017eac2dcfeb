"""The port's flash attention against the JAX package, on the CPU.

The same numpy inputs go through ``repro.kernels.flash_attention`` (its
Pallas kernel in interpret mode, and its oracle) and through
``repro_torch.kernels.flash_attention`` (whose CPU path is the plain
version).  Tolerances are the reference's own
(``tests/test_flash_attention.py``): 2e-5 for float32, 3e-2 for bfloat16.
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as fl_k
from repro.kernels.flash_attention import ops as fl_ops
from repro.kernels.flash_attention import ref as fl_ref
from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention import ref as t_ref

torch.set_num_threads(2)


def _qkv(seed, b, s, t, h, hk, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, t, hk, dh)).astype(np.float32),
            rng.standard_normal((b, t, hk, dh)).astype(np.float32))


def _heads_first(x):
    """(B, S, H, dh) numpy -> (B*H, S, dh)."""
    b, s, h, dh = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, dh)


# the reference test's shapes; causal only where S == T, as there
_SHAPES = [(1, 128, 128, 2, 1, 64), (2, 256, 256, 4, 2, 64),
           (1, 128, 256, 4, 4, 128), (2, 384, 128, 6, 2, 32)]
_CASES = ([(shape, False) for shape in _SHAPES]
          + [(shape, True) for shape in _SHAPES if shape[1] == shape[2]])


@pytest.mark.parametrize("shape,causal", _CASES)
def test_flash_bshd_matches_reference(shape, causal):
    b, s, t, h, hk, dh = shape
    q, k, v = _qkv(s + t + h, *shape)
    want = np.asarray(fl_ops.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = t_ops.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    assert got.shape == (b, s, h, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape,causal", _CASES)
def test_plain_version_matches_reference_oracle(shape, causal):
    b, s, t, h, hk, dh = shape
    q, k, v = (_heads_first(x) for x in _qkv(s * t + dh, *shape))
    want = np.asarray(fl_ref.attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), group=h // hk,
                                       causal=causal))
    got = t_ref.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), group=h // hk, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_bf16_matches_reference():
    q, k, v = _qkv(0, 1, 128, 128, 2, 1, 64)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(fl_ops.flash_attention_bshd(jq, jk, jv), np.float32)
    # the same bf16 values on the torch side
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                  for x in (jq, jk, jv))
    got = t_ops.flash_attention_bshd(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("nq,nk,group,seed", [
    (1, 1, 1, 0), (2, 3, 2, 1), (3, 1, 3, 2), (1, 2, 2, 3)])
def test_flash_property_blocks(nq, nk, group, seed):
    """Block-count grids of the reference's property test (non-causal):
    the port equals the Pallas kernel run in interpret mode."""
    rng = np.random.default_rng(seed)
    dh = 32
    q = rng.standard_normal((group, nq * 128, dh)).astype(np.float32)
    k = rng.standard_normal((1, nk * 128, dh)).astype(np.float32)
    v = rng.standard_normal((1, nk * 128, dh)).astype(np.float32)
    want = np.asarray(fl_k.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), group=group,
        causal=False, interpret=True))
    got = t_ref.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), group=group, causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_row_stochasticity():
    """Softmax rows sum the value vectors: with v = const, out = const."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 128, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 128, 64)).astype(np.float32))
    out = t_ref.attention(q, k, torch.ones((2, 128, 64)), group=1,
                          causal=True)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)


def test_smoke_head_dim_matches_reference():
    """dh = 8, the smoke config's head width, at its GQA grouping."""
    q, k, v = _qkv(8, 2, 128, 128, 8, 2, 8)
    want = np.asarray(fl_ops.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = t_ops.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,t", [(200, 200), (128, 130)])
def test_lengths_off_the_block_raise(s, t):
    """The reference asserts S % min(128, S) == 0 (and for T); the port
    raises ValueError."""
    q = torch.zeros((1, s, 2, 8))
    kv = torch.zeros((1, t, 1, 8))
    with pytest.raises(ValueError, match="multiples"):
        t_ops.flash_attention_bshd(q, kv, kv, causal=False)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.flash_attention(q, q[:1], q[:1], group=2)
