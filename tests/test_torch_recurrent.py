"""The port's recurrent and local-attention layers against the JAX
package's, on the CPU.

RG-LRU (recurrentgemma), mLSTM and sLSTM (xlstm) and local attention, at
the smoke geometries.  Weights are the reference's draws, carried as numpy
arrays; inputs come from a seeded numpy generator.

Tolerances (float32 unless named):

* ``rglru_scan``: the reference runs ``jax.lax.associative_scan``, the port
  a Hillis-Steele log-depth scan, so the two sum the recurrence in
  different trees; against the reference and against the port's own
  step-by-step recurrence at atol 2e-6, rtol 1e-5 (states of order 1; a
  few float32 ulps seen), the same as the layer tests' float32 bound
  would give on one layer.  The RG-LRU block at atol 1e-5, rtol 1e-5.
* ``_mlstm_chunkwise``, the mLSTM and sLSTM blocks and their decode:
  atol 1e-5, rtol 1e-5 (summation order).  ``_mlstm_chunkwise`` under
  log input gates of std 4 at rtol 1e-4: the exponentials of cumulative
  log-gate sums amplify the cumsum's rounding, and outputs reach the
  hundreds where the denominator sits at its floor (2.3e-5 relative
  seen on 15 of 6,144 values).
* local attention, both branches: atol 1e-5, rtol 1e-5; bf16 at atol
  3e-2, rtol 3e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.dist.specs import make_rules
from repro.launch.mesh import make_test_mesh
from repro.models import attention as ref_attn
from repro.models import rglru as ref_rglru
from repro.models import xlstm as ref_xlstm
from repro_torch.configs.registry import get_config
from repro_torch.models import attention, rglru, xlstm

torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)
SCAN = dict(atol=2e-6, rtol=1e-5)
STRESS = dict(atol=1e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)


def _cfgs(arch, dtype="float32", **kw):
    return [dataclasses.replace(get(arch, smoke=True), dtype=dtype, **kw)
            for get in (ref_config, get_config)]


def _module(module, tree):
    """``module`` holding the reference leaves of ``tree`` (numpy)."""
    for name, t in module.named_parameters():
        t.copy_(torch.from_numpy(np.array(tree[name], np.float32)))
    return module


def _f32(x):
    return np.array(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                    np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(_f32(x)).to(dtype)


@pytest.fixture(scope="module")
def rules():
    return make_rules(make_test_mesh(), "cp")


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@functools.lru_cache
def _rglru(seed=0):
    rcfg, cfg = _cfgs("recurrentgemma_2b")
    p = jax.tree.map(np.asarray, ref_rglru.init(jax.random.PRNGKey(seed),
                                                rcfg, jnp.float32))
    return rcfg, cfg, jax.tree.map(jnp.asarray, p), _module(
        rglru.RGLRU(cfg, torch.float32, "cpu"), p)


@pytest.mark.parametrize("s", [1, 7, 64, 100])
def test_rglru_scan_matches_reference_and_the_step_loop(s):
    rcfg, cfg, rp, m = _rglru()
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want = ref_rglru.rglru_scan(rp, jnp.asarray(x))
    got = rglru.rglru_scan(m, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _f32(want), **SCAN)
    h = torch.zeros((2, cfg.d_model))
    steps = []
    for t in range(s):
        out, h = rglru.rglru_step(m, torch.from_numpy(x[:, t:t + 1]), h)
        steps.append(out)
    np.testing.assert_allclose(got.numpy(), torch.cat(steps, 1).numpy(),
                               **SCAN)


def test_linear_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    a = torch.rand((3, 37, 5), generator=g, dtype=torch.float64)
    b = torch.randn((3, 37, 5), generator=g, dtype=torch.float64)
    h = torch.zeros((3, 5), dtype=torch.float64)
    want = []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(rglru.linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-12)


def test_rglru_init_draws_the_griffin_lambda():
    _, cfg = _cfgs("recurrentgemma_2b")
    m = rglru.init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    for name in ("b_r", "b_i", "lam"):
        assert getattr(m, name).dtype == torch.float32
    # a = exp(-c softplus(lam)) at r = 1 is the uniform draw
    a = torch.exp(-rglru.C_RGLRU * torch.nn.functional.softplus(m.lam))
    assert bool(((a >= 0.9 - 1e-6) & (a <= 0.999 + 1e-6)).all())
    assert not m.b_r.any() and not m.b_i.any()


def test_rglru_block_and_decode_match_reference(rules):
    rcfg, cfg, rp, m = _rglru()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want = ref_rglru.block(rp, jnp.asarray(x), rcfg, rules)
    np.testing.assert_allclose(rglru.block(m, torch.from_numpy(x), cfg)
                               .numpy(), _f32(want), **F32)
    shp = rglru.state_shape(cfg, 2)
    r_state = {"h": jnp.zeros(shp["h"]), "conv": jnp.zeros(shp["conv"])}
    t_state = {"h": torch.zeros(shp["h"]), "conv": torch.zeros(shp["conv"])}
    for t in range(12):
        xt = x[:, t:t + 1]
        want, r_state = ref_rglru.block_decode(rp, jnp.asarray(xt), r_state,
                                               rcfg, rules)
        got, t_state = rglru.block_decode(m, torch.from_numpy(xt), t_state,
                                          cfg)
        np.testing.assert_allclose(got.numpy(), _f32(want), **F32)
    for k in ("h", "conv"):
        np.testing.assert_allclose(t_state[k].numpy(), _f32(r_state[k]),
                                   **F32)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

@functools.lru_cache
def _mlstm(seed=0):
    rcfg, cfg = _cfgs("xlstm_125m")
    p = jax.tree.map(np.asarray, ref_xlstm.mlstm_init(
        jax.random.PRNGKey(seed), rcfg, jnp.float32))
    return rcfg, cfg, jax.tree.map(jnp.asarray, p), _module(
        xlstm.MLSTM(cfg, torch.float32, "cpu"), p)


@pytest.mark.parametrize("gate_std,tol", [(1.0, F32), (4.0, STRESS)])
@pytest.mark.parametrize("s", [24, 128])
def test_mlstm_chunkwise_matches_reference(s, gate_std, tol):
    """S below one chunk (W = S) and S a multiple of the 64-chunk, with log
    input gates of std 1 and of std 4 (which drives the stabiliser hard:
    weights up to e^12 against the running max)."""
    rng = np.random.default_rng(s)
    b, h, dh = 2, 3, 8
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    log_i = (gate_std * rng.standard_normal((b, s, h))).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-rng.standard_normal((b, s, h)) - 2))
                   ).astype(np.float32)
    want = ref_xlstm._mlstm_chunkwise(*map(jnp.asarray,
                                           (q, k, v, log_i, log_f)))
    got = xlstm._mlstm_chunkwise(*map(torch.from_numpy,
                                      (q, k, v, log_i, log_f)))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), _f32(want), **tol)


def test_mlstm_chunkwise_rejects_a_ragged_length():
    x = torch.zeros((1, 70, 1, 4))
    with pytest.raises(ValueError, match="multiple"):
        xlstm._mlstm_chunkwise(x, x, x, x[..., 0], x[..., 0])


def test_mlstm_block_and_decode_match_reference(rules):
    rcfg, cfg, rp, m = _mlstm()
    x = np.random.default_rng(3).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    want = ref_xlstm.mlstm_block(rp, jnp.asarray(x), rcfg, rules)
    np.testing.assert_allclose(
        xlstm.mlstm_block(m, torch.from_numpy(x), cfg).numpy(), _f32(want),
        **F32)
    shp = xlstm.mlstm_state_shape(cfg, 2)
    r_state = {k: jnp.zeros(v) for k, v in shp.items()}
    r_state["m"] = jnp.full(shp["m"], -1e30)
    t_state = {k: torch.from_numpy(_f32(v)) for k, v in r_state.items()}
    for t in range(9):
        xt = x[:, t:t + 1]
        want, r_state = ref_xlstm.mlstm_block_decode(
            rp, jnp.asarray(xt), r_state, rcfg, rules)
        got, t_state = xlstm.mlstm_block_decode(m, torch.from_numpy(xt),
                                                t_state, cfg)
        np.testing.assert_allclose(got.numpy(), _f32(want), **F32)
    for k in shp:
        np.testing.assert_allclose(t_state[k].numpy(), _f32(r_state[k]),
                                   err_msg=k, **F32)


def test_slstm_block_and_decode_match_reference(rules):
    rcfg, cfg = _cfgs("xlstm_125m")
    p = jax.tree.map(np.asarray, ref_xlstm.slstm_init(
        jax.random.PRNGKey(1), rcfg, jnp.float32))
    p["b_zifo"] = np.random.default_rng(0).standard_normal(
        p["b_zifo"].shape).astype(np.float32)     # non-zero gate biases
    rp = jax.tree.map(jnp.asarray, p)
    m = _module(xlstm.SLSTM(cfg, torch.float32, "cpu"), p)
    x = np.random.default_rng(4).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    want = ref_xlstm.slstm_block(rp, jnp.asarray(x), rcfg, rules)
    np.testing.assert_allclose(
        xlstm.slstm_block(m, torch.from_numpy(x), cfg).numpy(), _f32(want),
        **F32)
    shp = xlstm.slstm_state_shape(cfg, 2)
    r_state = {"c": jnp.zeros(shp["c"]), "n": jnp.zeros(shp["n"]),
               "m": jnp.full(shp["m"], -1e30)}
    t_state = {k: torch.from_numpy(_f32(v)) for k, v in r_state.items()}
    for t in range(11):
        xt = x[:, t:t + 1]
        want, r_state = ref_xlstm.slstm_block_decode(
            rp, jnp.asarray(xt), r_state, rcfg, rules)
        got, t_state = xlstm.slstm_block_decode(m, torch.from_numpy(xt),
                                                t_state, cfg)
        np.testing.assert_allclose(got.numpy(), _f32(want), **F32)
    for k in shp:
        np.testing.assert_allclose(t_state[k].numpy(), _f32(r_state[k]),
                                   err_msg=k, **F32)


# ---------------------------------------------------------------------------
# local attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 9, 48])
def test_local_attention_matches_reference(s, dtype, rules):
    """S <= W (the banded fallback, at S = W and below) and S = 3W (the
    chunked path), window 16."""
    rcfg, cfg = _cfgs("recurrentgemma_2b", dtype)
    assert cfg.local_window == 16
    jdt = jnp.dtype(dtype)
    p = jax.tree.map(np.asarray, ref_attn.init(jax.random.PRNGKey(0), rcfg,
                                               jdt))
    m = _module(attention.Attention(cfg, getattr(torch, dtype), "cpu"), p)
    x = jnp.asarray(np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)), jdt)
    pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
    want = ref_attn.local_attention(jax.tree.map(jnp.asarray, p), x, rcfg,
                                    rules, 1, jnp.asarray(pos))
    got = attention.local_attention(m, _t(x, getattr(torch, dtype)), cfg,
                                    torch.from_numpy(pos).long())
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "float32" else BF16))


def test_local_attention_is_full_attention_within_the_window():
    """A window at least S wide gives causal full attention."""
    _, cfg = _cfgs("recurrentgemma_2b", local_window=64)
    m = attention.init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((1, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    pos = torch.arange(32).expand(1, 32)
    np.testing.assert_allclose(
        attention.local_attention(m, x, cfg, pos).numpy(),
        attention.full_attention(m, x, cfg, pos).numpy(), **F32)


def test_local_attention_rejects_a_ragged_length():
    _, cfg = _cfgs("recurrentgemma_2b")
    m = attention.init(torch.Generator().manual_seed(0), cfg, torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        attention.local_attention(m, torch.zeros((1, 20, cfg.d_model)), cfg,
                                  torch.arange(20).expand(1, 20))
