"""The port's dense LM against the JAX package, on the CPU.

Weights come from the reference's ``init_params`` and reach the port bit
for bit through ``convert.lm_params_from_numpy``; inputs are numpy arrays
from a seeded generator.  The JAX flash path runs its Pallas kernel in
interpret mode, as the reference's own tests run it.

Tolerances: a float32 config (``dataclasses.replace(cfg,
dtype="float32")``) is held at atol 1e-4, rtol 1e-5 on logits of magnitude
up to about 60 (summation order only; about 2e-5 seen) and at 1e-5 on
layer outputs of order 1; bfloat16 at the reference's own tolerances
(``tests/test_perf_variants.py``: atol 0.25, rtol 0.05 on logits; one bf16
ulp at 32-64 is 0.25).  A float32 model decodes against the bf16 cache that
``init_cache`` makes whatever the model's dtype, in both packages: its
cache comes out bitwise equal and its logits within the float32 tolerance
(about 1e-5 seen); a bf16 model's cache within one bf16 ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as ref_config
from repro.dist.specs import make_rules
from repro.launch.mesh import make_test_mesh
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import attention, layers, transformer

torch.set_num_threads(2)

F32 = dict(atol=1e-4, rtol=1e-5)
BF16 = dict(atol=0.25, rtol=0.05)


def _cfgs(dtype="bfloat16", **parallel):
    """(reference cfg, port cfg) of the yi-6b smoke config."""
    out = []
    for get in (ref_config, get_config):
        cfg = get("yi_6b", smoke=True)
        cfg = dataclasses.replace(
            cfg, dtype=dtype,
            parallel=dataclasses.replace(cfg.parallel, **parallel))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh()


def _params(rcfg, cfg, seed=0):
    p = ref_tf.init_params(jax.random.PRNGKey(seed), rcfg)
    return p, convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, p), device="cpu")


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _ref_forward(rcfg, params, tokens, mesh):
    rules = make_rules(mesh, rcfg.parallel.layout)
    with jax.set_mesh(mesh):
        logits, aux = jax.jit(lambda p, t: ref_tf.forward(
            p, rcfg, t, rules, 1, None, mesh))(params, tokens)
    return logits, aux


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_configs_equal_reference(smoke):
    for arch in ARCH_IDS:
        a, b = ref_config(arch, smoke), get_config(arch.replace("_", "-"),
                                                   smoke)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
        assert (a.vocab_padded, a.uniform_pattern, a.attends_globally) == \
            (b.vocab_padded, b.uniform_pattern, b.attends_globally)


def test_parameter_names_mirror_the_reference_tree():
    rcfg, cfg = _cfgs()
    p, model = _params(rcfg, cfg)
    want = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(p):
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        if name.startswith("blocks."):
            want |= {f"blocks.{i}.{name[7:]}" for i in range(cfg.n_layers)}
        else:
            want.add(name)
    assert set(dict(model.named_parameters())) == want
    assert model.embed.shape == (cfg.vocab_padded, cfg.d_model) == (256, 64)


def _bits(x) -> np.ndarray:
    """The raw bits of a tensor or numpy array, as int16 or int32."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_weight_round_trip_is_bitwise(dtype):
    rcfg, cfg = _cfgs(dtype)
    p, model = _params(rcfg, cfg)
    own = dict(model.named_parameters())
    tree = jax.tree.map(np.asarray, p)
    for sub, leaves in tree["blocks"].items():
        for name, leaf in leaves.items():
            for i in range(cfg.n_layers):
                got = own[f"blocks.{i}.{sub}.{name}"]
                assert str(got.dtype) == f"torch.{leaf.dtype.name}"
                np.testing.assert_array_equal(_bits(got), _bits(leaf[i]))
    np.testing.assert_array_equal(_bits(model.embed), _bits(tree["embed"]))
    np.testing.assert_array_equal(_bits(model.final_norm.scale),
                                  _bits(tree["final_norm"]["scale"]))


def test_init_params_draws_truncated_normals():
    cfg = get_config("yi_6b", smoke=True)
    gen = torch.Generator().manual_seed(3)
    model = transformer.init_params(cfg, gen)
    again = transformer.init_params(cfg, torch.Generator().manual_seed(3))
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(a, b), name
    w = model.blocks[0].mlp.w_gate.float()
    assert w.dtype == torch.float32 and w.abs().max() <= 2 * 64 ** -0.5
    assert 0.6 * 64 ** -0.5 < w.std() < 1.0 * 64 ** -0.5
    assert model.embed.abs().max() <= 2.0
    assert torch.equal(model.final_norm.scale, torch.ones(cfg.d_model))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=2e-2, rtol=2e-2)
    x = jnp.asarray(rng.standard_normal((2, 5, 3, 8)), jdt)
    tx = torch.tensor(np.asarray(x, np.float32)).to(dtype)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _f32(layers.apply_rope(tx, torch.from_numpy(pos), 10_000.0)),
        _f32(ref_layers.apply_rope(x, jnp.asarray(pos), 10_000.0)), **tol)

    h = jnp.asarray(rng.standard_normal((2, 5, 16)), jdt)
    th = torch.tensor(np.asarray(h, np.float32)).to(dtype)
    scale = rng.standard_normal(16).astype(np.float32)
    norm = layers.RMSNorm(16)
    norm.scale.copy_(torch.from_numpy(scale))
    np.testing.assert_allclose(
        _f32(layers.rmsnorm(norm, th, 1e-6)),
        _f32(ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, h, 1e-6)),
        **tol)

    ws = {n: jnp.asarray(rng.standard_normal(s) * 0.3, jdt) for n, s in
          (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    m = layers.MLP(16, 24, dtype)
    for n, w in ws.items():
        getattr(m, n).copy_(torch.tensor(np.asarray(w, np.float32)))
    np.testing.assert_allclose(_f32(layers.mlp(m, th)),
                               _f32(ref_layers.mlp(ws, h)),
                               **(tol if dtype == torch.float32 else
                                  dict(atol=6e-2, rtol=3e-2)))


def test_rope_frequencies_match_reference():
    for dh in (8, 128):
        np.testing.assert_allclose(
            layers.rope_frequencies(dh, 10_000.0).numpy(),
            np.asarray(ref_layers.rope_frequencies(dh, 10_000.0)),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# attention and the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,impl", [("float32", "einsum"),
                                        ("float32", "flash"),
                                        ("bfloat16", "einsum"),
                                        ("bfloat16", "flash")])
def test_full_attention_matches_reference(dtype, impl, mesh):
    rcfg, cfg = _cfgs(dtype, attn_impl=impl)
    p, model = _params(rcfg, cfg)
    rng = np.random.default_rng(7)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.standard_normal((2, 128, cfg.d_model)), jdt)
    pos = jnp.broadcast_to(jnp.arange(128, dtype=jnp.int32), (2, 128))
    blk0 = jax.tree.map(lambda a: a[0], p["blocks"])["attn"]
    rules = make_rules(mesh, rcfg.parallel.layout)
    with jax.set_mesh(mesh):
        want = jax.jit(lambda pp, xx: ref_attn.full_attention(
            pp, xx, rcfg, rules, 1, pos))(blk0, x)
    tx = torch.tensor(np.asarray(x, np.float32)).to(
        transformer.model_dtype(cfg))
    got = attention.full_attention(model.blocks[0].attn, tx, cfg,
                                   torch.arange(128).expand(2, 128))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else \
        dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("dtype,impl", [("float32", "einsum"),
                                        ("float32", "flash"),
                                        ("bfloat16", "einsum"),
                                        ("bfloat16", "flash")])
def test_forward_matches_reference(dtype, impl, mesh):
    rcfg, cfg = _cfgs(dtype, attn_impl=impl)
    p, model = _params(rcfg, cfg)
    tokens = _tokens(cfg, 2, 128)
    want, want_aux = _ref_forward(rcfg, p, jnp.asarray(tokens), mesh)
    with torch.no_grad():
        got, aux = transformer.forward(model, cfg, torch.from_numpy(tokens))
    assert got.shape == (2, 128, cfg.vocab_padded)
    assert got.dtype == transformer.model_dtype(cfg)
    assert float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "float32" else BF16))
    np.testing.assert_array_equal(_f32(got).argmax(-1), _f32(want).argmax(-1))


def test_bf16_scores_forward_matches_reference(mesh):
    """``attn_bf16_scores``: the low-precision softmax of the einsum path."""
    rcfg, cfg = _cfgs(attn_bf16_scores=True)
    p, model = _params(rcfg, cfg)
    tokens = _tokens(cfg, 2, 32)
    want, _ = _ref_forward(rcfg, p, jnp.asarray(tokens), mesh)
    with torch.no_grad():
        got, _ = transformer.forward(model, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
    np.testing.assert_array_equal(_f32(got).argmax(-1), _f32(want).argmax(-1))


def test_flash_impl_matches_einsum_forward():
    """Mirror of test_perf_variants.py::test_flash_impl_matches_einsum_forward
    on the port."""
    _, cfg = _cfgs()
    _, flash_cfg = _cfgs(attn_impl="flash")
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(cfg, 1, 128))
    with torch.no_grad():
        want = _f32(transformer.forward(model, cfg, tokens)[0])
        got = _f32(transformer.forward(model, flash_cfg, tokens)[0])
    np.testing.assert_allclose(got, want, **BF16)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_kv_weight_replication_exact_equivalence():
    """Mirror of the reference's test of the same name: kv_replicate=2
    stores each KV head twice and leaves the logits unchanged."""
    _, cfg = _cfgs("float32")
    _, cfg2 = _cfgs("float32", kv_replicate=2)
    m1 = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    m2 = transformer.init_params(cfg2, torch.Generator().manual_seed(0))
    assert m2.blocks[0].attn.wk.shape[1] == 2 * m1.blocks[0].attn.wk.shape[1]
    tokens = torch.from_numpy(_tokens(cfg, 2, 16))
    with torch.no_grad():
        np.testing.assert_allclose(
            _f32(transformer.forward(m2, cfg2, tokens)[0]),
            _f32(transformer.forward(m1, cfg, tokens)[0]), atol=1e-5,
            rtol=1e-5)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def test_init_cache_matches_reference():
    rcfg, cfg = _cfgs()
    want = ref_tf.init_cache(rcfg, 3, 16, 1)
    got = transformer.init_cache(cfg, 3, 16, device="cpu")
    assert set(got) == set(want) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape == (2, 3, 16, 2, 8)
        assert got[name].dtype == torch.bfloat16
        assert want[name].dtype == jnp.bfloat16
        assert not got[name].any()
    assert attention.cache_shape(cfg, 3, 16) == ref_attn.cache_shape(
        rcfg, 3, 16, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype, mesh):
    """Five decode steps with per-slot positions and an inactive slot:
    logits and the cache against the reference's."""
    rcfg, cfg = _cfgs(dtype)
    p, model = _params(rcfg, cfg)
    rules = make_rules(mesh, rcfg.parallel.layout)
    dec = jax.jit(lambda pp, c, t, pos, act: ref_tf.decode_step(
        pp, rcfg, c, t, pos, rules, 1, mesh, active=act))
    r_cache = ref_tf.init_cache(rcfg, 3, 16, 1)
    t_cache = transformer.init_cache(cfg, 3, 16, device="cpu")
    rng = np.random.default_rng(11)
    pos = np.zeros(3, np.int32)
    tol = F32 if dtype == "float32" else BF16
    for step in range(5):
        toks = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        active = np.array([True, step % 2 == 0, True])
        with jax.set_mesh(mesh):
            want, r_cache = dec(p, r_cache, jnp.asarray(toks),
                                jnp.asarray(pos), jnp.asarray(active))
        got, t_cache = transformer.decode_step(
            model, cfg, t_cache, torch.from_numpy(toks),
            torch.from_numpy(pos), torch.from_numpy(active))
        assert got.shape == (3, 1, cfg.vocab_padded)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
        pos = pos + active.astype(np.int32)
    for name in ("k", "v"):
        got, want = _f32(t_cache[name]), _f32(r_cache[name])
        if dtype == "float32":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
        # the inactive slot's rows past its position were never written
        assert not t_cache[name][:, 1, int(pos[1]):].any()


def test_decode_matches_forward_slice():
    """Mirror of test_arch_smoke.py::test_decode_matches_forward_slice[yi_6b]
    on the port: feeding 7 tokens one by one through decode reproduces the
    forward's logits at the last position (same tolerance) and its greedy
    token."""
    cfg = get_config("yi_6b", smoke=True)
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 2, 7))
    with torch.no_grad():
        want, _ = transformer.forward(model, cfg, toks)
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    got = None
    for i in range(7):
        got, cache = transformer.decode_step(model, cfg, cache,
                                             toks[:, i:i + 1], i)
    np.testing.assert_allclose(_f32(got[:, 0]), _f32(want[:, -1]),
                               atol=0.55, rtol=0.05)
    np.testing.assert_array_equal(_f32(got[:, 0]).argmax(-1),
                                  _f32(want[:, -1]).argmax(-1))
