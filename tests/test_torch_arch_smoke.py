"""The port's ten architectures against the JAX package, on the CPU.

Mirror of ``tests/test_arch_smoke.py``: every arch of ``ARCH_IDS`` at its
``SMOKE`` config, the forward (logits and the MoE aux loss) and decode
steps (logits and cache) held against the reference's on the reference's
weights, carried bit for bit by ``convert.lm_params_from_numpy``; inputs
are numpy arrays from a seeded generator.  Both packages run an ``ep``
config's MoE expert-parallel on their one-bank test mesh, as the
reference's tests and serving do.  One train step per arch is in
``test_torch_arch_train.py``.

Tolerances:

* float32 (``dataclasses.replace(cfg, dtype="float32")``): logits at
  ``F32`` = atol 1e-4, rtol 1e-5, as ``test_torch_lm.py`` (summation
  order); the aux loss at rtol 1e-5.  The recurrentgemma forward runs
  the RG-LRU recurrence as a log-depth scan whose combine tree is not
  ``jax.lax.associative_scan``'s; its rounding stays inside ``F32``.
* bfloat16 (the smoke configs as they are): logits at ``BF16`` = atol
  0.25, rtol 0.05 (one bf16 ulp at 32-64 is 0.25), argmax equal at every
  position; aux at atol 1e-3.  The two MoE archs route by a top-k, which
  is discontinuous: a one-ulp difference in a bf16 activation (XLA's and
  PyTorch's bf16 products round apart) flips a near-tie route for a few
  tokens, whose logits then differ by O(1) (2-16 of 64 positions seen
  over three seeds, up to 9.3 apart).  Their bf16 logits are held by
  argmax at every position and a relative L2 difference of at most
  ``MOE_BF16_REL_L2`` = 0.1 (0.0077-0.058 seen); their float32 forward
  holds every logit at ``F32``.
* decode: a float32 model decodes against the bf16 cache that
  ``init_cache`` makes, in both packages: logits at ``F32``, bf16 caches
  within one bf16 ulp of values of order 1 (atol 1e-2, rtol 1e-2) and
  float32 recurrent states at atol 1e-5, rtol 1e-5.
* decode against the port's own forward: the reference test's atol 0.55,
  rtol 0.05 on bf16 logits, argmax equal.
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
from repro.models import transformer as ref_tf
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_test_mesh as port_mesh
from repro_torch.models import transformer

torch.set_num_threads(2)

F32 = dict(atol=1e-4, rtol=1e-5)
BF16 = dict(atol=0.25, rtol=0.05)
AUX_F32 = dict(atol=0, rtol=1e-5)
AUX_BF16 = dict(atol=1e-3, rtol=0)
MOE_BF16_REL_L2 = 0.1
CACHE_BF16 = dict(atol=1e-2, rtol=1e-2)
STATE_F32 = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 32


def _cfgs(arch, dtype=None):
    """(reference cfg, port cfg) of ``arch``'s smoke config."""
    out = []
    for get in (ref_config, get_config):
        cfg = get(arch, smoke=True)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh()


def _params(rcfg, cfg, seed=0):
    p = ref_tf.init_params(jax.random.PRNGKey(seed), rcfg)
    return p, convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, p), device="cpu")


def _inputs(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    embeds = None
    if cfg.frontend is not None:
        embeds = rng.standard_normal(
            (b, cfg.n_prefix_embeds, transformer.STUB_FRONTEND_DIM)
        ).astype(np.float32)
    return tokens, embeds


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _ref_forward(rcfg, params, tokens, embeds, mesh):
    rules = make_rules(mesh, rcfg.parallel.layout)
    with jax.set_mesh(mesh):
        return jax.jit(lambda p, t, e: ref_tf.forward(
            p, rcfg, t, rules, 1, e, mesh))(
                params, jnp.asarray(tokens),
                None if embeds is None else jnp.asarray(embeds))


def test_every_arch_is_supported():
    for arch in ARCH_IDS:
        transformer.check_supported(get_config(arch, smoke=True))
        transformer.check_supported(get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_tree_mirrors_the_reference(arch):
    """Names, shapes and dtypes of every leaf, scanned stacks as (L, ...)
    and heterogeneous stacks as lists, in ``reference_tree()``."""
    rcfg, cfg = _cfgs(arch)
    p, model = _params(rcfg, cfg)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(p):
        want[".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)] = (leaf.shape, leaf.dtype.name)
    got = {}
    tree = model.reference_tree()

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            dt = (node.parts[0] if hasattr(node, "parts") else node).dtype
            got[prefix[:-1]] = (tuple(node.shape), str(dt)[6:])
    walk(tree, "")
    assert got == want
    assert isinstance(tree["blocks"], dict) == (rcfg.scan_layers and
                                                rcfg.uniform_pattern)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch, dtype, mesh):
    rcfg, cfg = _cfgs(arch, dtype)
    p, model = _params(rcfg, cfg)
    tokens, embeds = _inputs(cfg)
    want, want_aux = _ref_forward(rcfg, p, tokens, embeds, mesh)
    with torch.no_grad():
        got, aux = transformer.forward(model, cfg, tokens, embeds,
                                       port_mesh())
    s_total = S + (cfg.n_prefix_embeds if cfg.frontend else 0)
    assert got.shape == (B, s_total, cfg.vocab_padded)
    assert got.dtype == transformer.model_dtype(cfg)
    assert aux.dtype == torch.float32
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(aux), float(want_aux),
                               **(AUX_F32 if f32 else AUX_BF16))
    if cfg.moe is None:
        assert float(aux) == 0.0
    g, w = _f32(got), _f32(want)
    if f32 or cfg.moe is None:
        np.testing.assert_allclose(g, w, **(F32 if f32 else BF16))
    else:
        assert np.linalg.norm(g - w) <= MOE_BF16_REL_L2 * np.linalg.norm(w)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_frontend_needs_embeds():
    cfg = get_config("pixtral_12b", smoke=True)
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="embeds"):
        transformer.forward(model, cfg, np.zeros((1, 4), np.int32))


def _ref_cache_np(cache):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), cache)


def _port_cache_np(cache):
    if isinstance(cache, dict):
        return {k: _f32(v) for k, v in cache.items()}
    return [{k: _f32(v) for k, v in layer.items()} for layer in cache]


def _assert_caches_close(got, want):
    got, want = _port_cache_np(got), _ref_cache_np(want)
    pairs = ([(got, want)] if isinstance(want, dict)
             else list(zip(got, want, strict=True)))
    for g, w in pairs:
        assert set(g) == set(w)
        for name in w:
            assert g[name].shape == w[name].shape, name
            tol = STATE_F32 if name in ("h", "c", "n", "m") else CACHE_BF16
            np.testing.assert_allclose(g[name], w[name], err_msg=name, **tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    want = ref_tf.init_cache(rcfg, 3, 24, 1)
    got = transformer.init_cache(cfg, 3, 24, device="cpu")
    assert isinstance(got, dict) == isinstance(want, dict)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    if isinstance(got, dict):
        flat_g = [(k, got[k]) for k in sorted(got)]
    else:
        flat_g = [(f"{i}.{k}", layer[k]) for i, layer in enumerate(got)
                  for k in sorted(layer)]
    assert len(flat_g) == len(flat_w)
    for (name, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype)[6:] == w.dtype.name, name
        np.testing.assert_array_equal(_f32(g), np.asarray(w, np.float32))


def _decode_both(arch, steps, max_len, mesh, active_fn, seed=11):
    """``steps`` decode steps of 3 slots with per-slot positions in both
    packages (float32 models), logits held at each step; returns both
    caches, the port's model and the last positions."""
    rcfg, cfg = _cfgs(arch, "float32")
    p, model = _params(rcfg, cfg)
    rules = make_rules(mesh, rcfg.parallel.layout)
    dec = jax.jit(lambda pp, c, t, pos, act: ref_tf.decode_step(
        pp, rcfg, c, t, pos, rules, 1, mesh, active=act))
    r_cache = ref_tf.init_cache(rcfg, 3, max_len, 1)
    t_cache = transformer.init_cache(cfg, 3, max_len, device="cpu")
    rng = np.random.default_rng(seed)
    pos = np.zeros(3, np.int32)
    for step in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        active = active_fn(step)
        with jax.set_mesh(mesh):
            want, r_cache = dec(p, r_cache, jnp.asarray(toks),
                                jnp.asarray(pos), jnp.asarray(active))
        got, t_cache = transformer.decode_step(
            model, cfg, t_cache, torch.from_numpy(toks),
            torch.from_numpy(pos), torch.from_numpy(active), port_mesh())
        assert got.shape == (3, 1, cfg.vocab_padded)
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   err_msg=f"step {step}", **F32)
        pos = pos + active.astype(np.int32)
    return cfg, model, t_cache, r_cache, pos


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_match_reference(arch, mesh):
    """Five decode steps with per-slot positions and an inactive slot:
    logits and the cache against the reference's; the inactive slot's
    recurrent state is frozen while it sleeps."""
    def active_fn(step):
        return np.array([True, step % 2 == 0, True])

    cfg, model, t_cache, r_cache, pos = _decode_both(arch, 5, 16, mesh,
                                                     active_fn)
    _assert_caches_close(t_cache, r_cache)
    if isinstance(t_cache, list):
        # one more step with slot 1 asleep: its recurrent state is kept,
        # while the awake slots' states move
        state = {(i, name): layer[name].clone()
                 for i, layer in enumerate(t_cache)
                 for name in ("h", "c", "n", "m", "conv") if name in layer}
        assert state
        transformer.decode_step(model, cfg, t_cache,
                                torch.zeros((3, 1), dtype=torch.int64),
                                torch.from_numpy(pos),
                                torch.tensor([True, False, True]))
        for (i, name), before in state.items():
            assert torch.equal(t_cache[i][name][1], before[1]), (i, name)
        assert any(not torch.equal(t_cache[i][name][0], before[0])
                   for (i, name), before in state.items())


def test_ring_buffer_wraps_past_the_window(mesh):
    """recurrentgemma's local layer keeps ``local_window`` = 16 ring
    slots: 21 decode steps wrap it, and every step's logits and the final
    ring still match the reference's."""
    _, cfg = _cfgs("recurrentgemma_2b")
    assert cfg.local_window == 16
    cfg, _, t_cache, r_cache, pos = _decode_both(
        "recurrentgemma_2b", 21, 32, mesh,
        lambda step: np.array([True, True, step % 3 != 0]))
    local = [i for i in range(cfg.n_layers) if cfg.block_kind(i) == "local"]
    assert local and all(t_cache[i]["k"].shape[1] == 16 for i in local)
    assert pos.max() > 16
    _assert_caches_close(t_cache, r_cache)


@pytest.mark.parametrize("arch", ["granite_20b", "yi_6b", "xlstm_125m",
                                  "recurrentgemma_2b"])
def test_decode_matches_forward_slice(arch):
    """Mirror of the reference test of the same name: feeding tokens one by
    one through decode reproduces the forward's logits at the final
    position (same tolerance) and its greedy token."""
    cfg = get_config(arch, smoke=True)
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_inputs(cfg, s=7)[0])
    with torch.no_grad():
        want, _ = transformer.forward(model, cfg, toks)
    cache = transformer.init_cache(cfg, B, 16, device="cpu")
    got = None
    for i in range(7):
        got, cache = transformer.decode_step(model, cfg, cache,
                                             toks[:, i:i + 1], i)
    np.testing.assert_allclose(_f32(got[:, 0]), _f32(want[:, -1]),
                               atol=0.55, rtol=0.05)
    np.testing.assert_array_equal(_f32(got[:, 0]).argmax(-1),
                                  _f32(want[:, -1]).argmax(-1))
