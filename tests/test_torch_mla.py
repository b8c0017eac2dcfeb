"""The port's Multi-head Latent Attention against the JAX package's, on
the CPU.

deepseek-v2-lite's smoke geometry (rank 32, rope 8, nope 16, v 16, 4
heads).  Weights are the reference's ``mla.init`` draws, carried as numpy
arrays; inputs come from a seeded numpy generator.  The prefill form
(per-head K/V materialised) and the absorbed decode (W_uk folded into the
query, W_uv into the output, a latent cache) are each held against the
reference's, and the absorbed decode against the port's own prefill form.

Tolerances: float32 at atol 1e-5, rtol 1e-5 on outputs of order 1
(summation order; the absorbed form reassociates the products, 1e-6 seen);
bf16 at atol 3e-2, rtol 3e-2 (a few bf16 ulps); a float32 model's bf16
latent cache bitwise the reference's, as the GQA cache is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.dist.specs import make_rules
from repro.launch.mesh import make_test_mesh
from repro.models import mla as ref_mla
from repro_torch.configs.registry import get_config
from repro_torch.models import mla

torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
ARCH = "deepseek_v2_lite_16b"


def _cfgs(dtype):
    return [dataclasses.replace(get(ARCH, smoke=True), dtype=dtype)
            for get in (ref_config, get_config)]


def _params(rcfg, cfg, seed=0):
    p = jax.tree.map(np.asarray, ref_mla.init(jax.random.PRNGKey(seed), rcfg,
                                              jnp.dtype(rcfg.dtype)))
    m = mla.MLA(cfg, getattr(torch, cfg.dtype), "cpu")
    for name, t in m.named_parameters():
        t.copy_(torch.from_numpy(np.array(p[name], np.float32)))
    return jax.tree.map(jnp.asarray, p), m


def _f32(x):
    return np.array(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                    np.float32)


@pytest.fixture(scope="module")
def rules():
    return make_rules(make_test_mesh(), "tp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention_matches_reference(dtype, rules):
    rcfg, cfg = _cfgs(dtype)
    rp, m = _params(rcfg, cfg)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 24, cfg.d_model)),
                    jnp.dtype(dtype))
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    want = jax.jit(lambda p, xx: ref_mla.full_attention(
        p, xx, rcfg, rules, 1, jnp.asarray(pos)))(rp, x)
    got = mla.full_attention(m, torch.from_numpy(_f32(x)).to(
        getattr(torch, dtype)), cfg, torch.from_numpy(pos).long())
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "float32" else BF16))


def test_cache_shape_matches_reference():
    rcfg, cfg = _cfgs("bfloat16")
    assert mla.cache_shape(cfg, 3, 40) == ref_mla.cache_shape(rcfg, 3, 40) \
        == ((3, 40, 32), (3, 40, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_matches_reference(dtype, rules):
    """Six absorbed decode steps of 3 slots, per-slot positions, slot 1
    asleep every other step: outputs and the latent cache."""
    rcfg, cfg = _cfgs(dtype)
    rp, m = _params(rcfg, cfg)
    c_shp, r_shp = mla.cache_shape(cfg, 3, 12)
    r_cache = (jnp.zeros(c_shp, jnp.bfloat16), jnp.zeros(r_shp, jnp.bfloat16))
    t_cache = (torch.zeros(c_shp, dtype=torch.bfloat16),
               torch.zeros(r_shp, dtype=torch.bfloat16))
    dec = jax.jit(lambda p, xx, c, pos, act: ref_mla.decode_attention(
        p, xx, c, pos, rcfg, rules, 1, active=act))
    rng = np.random.default_rng(2)
    pos = np.array([0, 0, 3], np.int32)
    tol = F32 if dtype == "float32" else BF16
    for step in range(6):
        x = jnp.asarray(rng.standard_normal((3, 1, cfg.d_model)),
                        jnp.dtype(dtype))
        active = np.array([True, step % 2 == 0, True])
        want, r_cache = dec(rp, x, r_cache, jnp.asarray(pos),
                            jnp.asarray(active))
        got, t_cache = mla.decode_attention(
            m, torch.from_numpy(_f32(x)).to(getattr(torch, dtype)), t_cache,
            torch.from_numpy(pos), cfg, active=torch.from_numpy(active))
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   err_msg=f"step {step}", **tol)
        pos = pos + active
    for g, w in zip(t_cache, r_cache):
        if dtype == "float32":
            np.testing.assert_array_equal(_f32(g), _f32(w))
        else:
            np.testing.assert_allclose(_f32(g), _f32(w), **BF16)
    # the sleeping slot's rows past its position were never written
    assert not t_cache[0][1, int(pos[1]):].any()


def test_absorbed_decode_equals_the_materialised_form():
    """Token by token through the latent cache gives the prefill form's
    output at every position (float32 model and cache)."""
    _, cfg = _cfgs("float32")
    m = mla.init(torch.Generator().manual_seed(0), cfg, torch.float32,
                 "cpu")
    x = torch.randn((2, 10, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want = mla.full_attention(m, x, cfg, torch.arange(10).expand(2, 10))
    c_shp, r_shp = mla.cache_shape(cfg, 2, 16)
    cache = (torch.zeros(c_shp), torch.zeros(r_shp))
    for i in range(10):
        got, cache = mla.decode_attention(m, x[:, i:i + 1], cache, i, cfg)
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, i].numpy(),
                                   err_msg=f"position {i}", **F32)
