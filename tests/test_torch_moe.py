"""The port's MoE against the JAX package's, on the CPU.

Routing, the load-balance loss, the dense oracle and the expert-parallel
path: on a one-bank mesh against the dense oracle (mirror of
``tests/test_runtime.py::test_moe_ep_matches_dense_oracle``), and at the
default ``capacity_factor`` 1.25, where tokens are dropped, on
``LocalMesh((2,))`` and ``((4,))`` against the reference's ``moe_ep`` on
``jax.make_mesh`` over the conftest's fake CPU devices; then over two
gloo ranks (:class:`~repro_torch.dist.ProcessGroupMesh`) against the
local mesh.  Weights are the reference's ``moe.init`` draws, carried as
numpy arrays; inputs come from a seeded numpy generator.

The drop set is checked three ways: the reference's kept assignments are
recomputed in numpy from its ``_route`` and its capacity rule, the
reference's EP output must equal the gate-weighted sum over exactly those
(so they are the ones it kept), and the port's
:func:`~repro_torch.models.moe.dispatch_plan` must keep exactly them.

Tolerances: float32 at atol 1e-5, rtol 1e-5 on outputs of order 1
(summation order) and the routing gates at 1e-6; the one-bank EP against
the dense oracle in bf16 at the reference test's atol 2e-2; the bf16
dense oracle against the reference's at atol 3e-2, rtol 3e-2 (a few
bf16 ulps); the gloo EP bitwise the local mesh's.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.dist.specs import make_rules
from repro.models import moe as ref_moe
from repro_torch.configs.registry import get_config
from repro_torch.dist import LocalMesh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(atol=1e-5, rtol=1e-5)
GATES = dict(atol=1e-6, rtol=1e-6)
BF16_DENSE = dict(atol=3e-2, rtol=3e-2)
# router skew and input shift of the drop tests: experts 0 and 1 gain
# about SKEW**2 * d = 2.6 logits on average over the rest
SKEW = 0.2


def _cfgs(arch="granite_moe_1b_a400m", dtype="float32", **moe_kw):
    out = []
    for get in (ref_config, get_config):
        cfg = dataclasses.replace(get(arch, smoke=True), dtype=dtype)
        if moe_kw:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
        out.append(cfg)
    return out


def _params(rcfg, cfg, seed=0, skew=0.0):
    """(reference params, the port's MoE) from ``moe.init``; ``skew`` is
    added to every weight of experts 0 and 1's router columns, so inputs
    with a positive mean crowd onto them and overflow their buckets."""
    jdt = jnp.dtype(rcfg.dtype)
    p = jax.tree.map(np.asarray, ref_moe.init(jax.random.PRNGKey(seed), rcfg,
                                              jdt))
    if skew:
        p["router"] = p["router"].copy()
        p["router"][:, :2] += skew
    m = moe.MoE(cfg, getattr(torch, rcfg.dtype), "cpu")
    for name, t in m.named_parameters():
        leaf = p
        for k in name.split("."):
            leaf = leaf[k]
        t.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return jax.tree.map(jnp.asarray, p), m


def _x(shape, d, seed=1, shift=0.0):
    x = np.random.default_rng(seed).standard_normal((*shape, d))
    return (x + shift).astype(np.float32)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def test_route_matches_reference_and_breaks_ties_low():
    rcfg, cfg = _cfgs()
    rp, m = _params(rcfg, cfg)
    x = _x((24,), cfg.d_model)
    want = ref_moe._route(rp["router"], jnp.asarray(x), cfg.moe.top_k)
    got = moe._route(m.router, torch.from_numpy(x), cfg.moe.top_k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), np.asarray(w, np.float32),
                                   **GATES)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # a zero router makes every probability equal: both packages pick the
    # lowest experts, in order, with equal gates
    zero = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    tie = ref_moe._route(jnp.asarray(zero), jnp.asarray(x), 3)
    got = moe._route(torch.from_numpy(zero), torch.from_numpy(x), 3)
    assert (got[1].numpy() == np.arange(3)).all()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(tie[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(tie[0]), **GATES)
    # a pairwise tie below a clear winner: the lower of the tied two
    logits = np.zeros((2, 4), np.float32)
    logits[:, [1, 3]] = 0.5
    logits[:, 2] = 2.0
    eye = np.eye(4, dtype=np.float32)
    got = moe._route(torch.from_numpy(eye), torch.from_numpy(logits), 2)
    want = ref_moe._route(jnp.asarray(eye), jnp.asarray(logits), 2)
    np.testing.assert_array_equal(got[1].numpy(), [[2, 1], [2, 1]])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(8), 40).astype(np.float32)
    experts = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    want = ref_moe.load_balance_loss(jnp.asarray(probs), jnp.asarray(experts),
                                     8)
    got = moe.load_balance_loss(torch.from_numpy(probs),
                                torch.from_numpy(experts).long(), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m",
                                  "deepseek_v2_lite_16b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense_matches_reference(arch, dtype):
    rcfg, cfg = _cfgs(arch, dtype)
    rp, m = _params(rcfg, cfg)
    x = _x((2, 16), cfg.d_model)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want, want_aux = jax.jit(lambda p, xx: ref_moe.moe_dense(p, xx, rcfg))(
        rp, jx)
    got, aux = moe.moe_dense(m, torch.from_numpy(_f32(jx)).to(
        getattr(torch, dtype)), cfg)
    assert got.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "float32" else BF16_DENSE))


def test_moe_ep_matches_dense_oracle():
    """Mirror of ``tests/test_runtime.py::test_moe_ep_matches_dense_oracle``:
    EP on a one-bank mesh equals the dense oracle with generous capacity
    (no drops)."""
    _, cfg = _cfgs(dtype="bfloat16", capacity_factor=4.0)
    params = moe.init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    with torch.no_grad():
        dense, _ = moe.moe_dense(params, x, cfg)
        ep, _ = moe.moe_ep(params, x, cfg, make_test_mesh())
    np.testing.assert_allclose(_f32(dense), _f32(ep), atol=2e-2)


def _bank_tokens(x, ep):
    """The (T_loc, D) tokens each bank owns, as the reference's shard_map
    splits them: its sequence slice when it divides and S > 1, else all."""
    b, s, d = x.shape
    if s % ep == 0 and s > 1:
        sl = s // ep
        return [x[:, j * sl:(j + 1) * sl].reshape(-1, d) for j in range(ep)]
    return [x.reshape(-1, d)] * ep


def _reference_keep(rp, rcfg, x, ep):
    """Per bank, the reference's kept assignments, recomputed in numpy from
    its routing and capacity rule: (experts (T,k), gates (T,k), keep
    (T,k))."""
    m = rcfg.moe
    out = []
    for xb in _bank_tokens(x, ep):
        gates, experts, _ = ref_moe._route(rp["router"], jnp.asarray(xb),
                                           m.top_k)
        experts, gates = np.asarray(experts), np.asarray(gates)
        dest = experts.reshape(-1) // (m.n_experts // ep)
        cap = int(max(8, -(-xb.shape[0] * m.top_k * m.capacity_factor
                           // ep)))
        rank = np.zeros_like(dest)
        for j in range(ep):
            rank[dest == j] = np.arange((dest == j).sum())
        out.append((experts, gates, (rank < cap).reshape(experts.shape)))
    return out


def _ffn(rp, e, x):
    f = rp["w2"].shape[1]
    h = x @ np.asarray(rp["w1"][e])
    g = h[:, :f]
    return (g / (1 + np.exp(-g)) * h[:, f:]) @ np.asarray(rp["w2"][e])


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("shape", [(2, 64), (16, 1)])
def test_ep_drops_what_the_reference_drops(ep, shape):
    """capacity_factor 1.25 (the default) on a skewed router: the port's
    EP on ``LocalMesh((ep,))`` keeps exactly the reference's assignments
    and its output equals the reference's ``moe_ep`` on ``ep`` devices."""
    rcfg, cfg = _cfgs()
    assert cfg.moe.capacity_factor == 1.25
    rp, m = _params(rcfg, cfg, skew=SKEW)
    x = _x(shape, cfg.d_model, shift=SKEW)
    jmesh = jax.make_mesh((ep,), ("model",))
    rules = make_rules(jmesh, "tp")
    with jax.set_mesh(jmesh):
        want, want_aux = jax.jit(lambda p, xx: ref_moe.moe_ep(
            p, xx, rcfg, rules, jmesh))(rp, jnp.asarray(x))
    want = np.asarray(want)
    keep = _reference_keep(rp, rcfg, x, ep)
    dropped = sum(int((~k).sum()) for _, _, k in keep)
    assert dropped > 0
    # the recomputed drop set is the one the reference applied
    expect = []
    for xb, (experts, gates, kept) in zip(_bank_tokens(x, ep), keep):
        y = np.zeros_like(xb)
        for t in range(xb.shape[0]):
            for c in range(experts.shape[1]):
                if kept[t, c]:
                    y[t] += gates[t, c] * _ffn(rp, experts[t, c], xb[t:t + 1])[0]
        expect.append(y)
    b, s, d = x.shape
    if s % ep == 0 and s > 1:
        expect = np.stack(expect).reshape(ep, b, s // ep, d).transpose(
            1, 0, 2, 3).reshape(b, s, d)
    else:
        expect = expect[0].reshape(b, s, d)
    np.testing.assert_allclose(expect, want, **F32)
    # the port keeps exactly those
    for xb, (experts, _, kept) in zip(_bank_tokens(x, ep), keep):
        _, t_exp, _ = moe._route(m.router, torch.from_numpy(xb),
                                 cfg.moe.top_k)
        np.testing.assert_array_equal(t_exp.numpy(), experts)
        cap = moe.capacity(xb.shape[0], cfg, ep)
        order, _, _, t_keep = moe.dispatch_plan(
            t_exp, ep, cfg.moe.n_experts // ep, cap)
        got_keep = np.zeros(t_exp.numel(), bool)
        got_keep[order.numpy()] = t_keep.numpy()
        np.testing.assert_array_equal(got_keep.reshape(kept.shape), kept)
    with torch.no_grad():
        got, aux = moe.moe_ep(m, torch.from_numpy(x), cfg,
                              LocalMesh((ep,), ("model",)))
    np.testing.assert_allclose(_f32(got), want, **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_ep_width_not_dividing_experts_falls_back_to_dense():
    _, cfg = _cfgs()
    params = moe.init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 6, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want = moe.moe_dense(params, x, cfg)
    got = moe.moe_ep(params, x, cfg, LocalMesh((3,), ("model",)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_local_all_to_all_transposes_banks():
    x = torch.arange(2 * 2 * 3).reshape(2, 2, 3)
    y = LocalMesh((2,), ("model",)).all_to_all(x, "model")
    assert torch.equal(y[1, 0], x[0, 1]) and torch.equal(y[0, 1], x[1, 0])


SCRIPT = textwrap.dedent("""
    import dataclasses
    import socket

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def rank_main(rank, world, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch.configs.registry import get_config
        from repro_torch.dist import LocalMesh, ProcessGroupMesh
        from repro_torch.models import moe
        base = get_config("deepseek_v2_lite_16b", smoke=True)
        pg = ProcessGroupMesh((2,), ("model",))
        local = LocalMesh((2,), ("model",))
        for dtype in (torch.float32, torch.bfloat16):
            cfg = dataclasses.replace(base, dtype=str(dtype)[6:])
            params = moe.init(torch.Generator().manual_seed(0), cfg, dtype)
            with torch.no_grad():
                params.router[:, :2] += 0.75      # crowd two experts
            for shape in ((2, 32), (6, 1)):
                x = torch.randn((*shape, cfg.d_model),
                                generator=torch.Generator().manual_seed(1))
                x = (x + 0.75).to(dtype)
                a, aux_a = moe.moe_ep(params, x, cfg, pg)
                b, aux_b = moe.moe_ep(params, x, cfg, local)
                assert torch.equal(a, b), (dtype, shape)
                assert torch.equal(aux_a, aux_b), (dtype, shape)
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            print("PG_OK", flush=True)


    if __name__ == "__main__":
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(rank_main, args=(2, port), nprocs=2)
""")


def test_process_group_ep_matches_local_mesh(tmp_path):
    """EP over two gloo ranks (``all_to_all_single``) is bitwise the
    ``LocalMesh((2,))`` EP, sequence-sharded and batch-only, in float32
    and bf16, with drops."""
    script = tmp_path / "pg_moe.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script)], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "PG_OK" in out.stdout, (
        out.stdout[-2000:], out.stderr[-4000:])
