"""The compressed cross-pod train step (int8 codes + error feedback).

The port's ``make_train_step_compressed`` on ``LocalMesh((2,), ("pod",))``
(both pods on the CPU, one after the other) against the reference's on
``jax.make_mesh((2, 2, 2), ("pod", "data", "model"))`` over the conftest's
8 fake CPU devices, in this process; and the same step on a 2-rank gloo
:class:`~repro_torch.dist.ProcessGroupMesh` held bitwise to the local one.

Tolerances (float32 smoke yi-6b, the reference's weights carried bit for
bit): the first loss within rtol 1e-5 (equal to 1e-7 seen).  The int8
codes sit on rounding boundaries, so a per-pod gradient that differs in
its last bits (summation order) can move one code by one level: the sum
of the codes equals a transcription of the reference's quantization on
the reference's own per-pod gradients except at no more than 1e-4 of the
elements, none by more than one level (1 of 86,336 seen).  Such a code
moves its EF element by half a quantization step, so after 1 and 3 steps
the EF is held at atol 1e-6 except at no more than 1e-3 of its elements
(1 and 11 of 86,336 seen), none further than 0.05 (a step of the
largest leaf; 0.0028 seen); the parameters at atol 2e-5 (3.0e-6 and
4.6e-6 seen).
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
from repro.launch.mesh import make_test_mesh
from repro.train import train_step as ref_ts
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.dist import LocalMesh
from repro_torch.dist import mesh as mesh_mod
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIRST_LOSS = dict(rtol=1e-5, atol=0)
CODES_OFF_SHARE = 1e-4
EF_ATOL, EF_OFF_SHARE, EF_MAX = 1e-6, 1e-3, 0.05
PARAMS = dict(atol=2e-5, rtol=0)


def _cfgs(dtype="float32"):
    return [dataclasses.replace(get("yi_6b", smoke=True), dtype=dtype)
            for get in (ref_config, get_config)]


def _batch(cfg):
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": np.ones((4, 16), np.float32)}


@pytest.fixture(scope="module")
def pod_mesh():
    return jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def _ref_codes(rcfg, rs, batch, levels=63):
    """The reference's int8 code sums of one step from ``rs``: its per-pod
    gradients (``loss_fn`` on each pod's rows) through a transcription of
    its ``reduce_leaf``, leaf by leaf of its (layer-stacked) tree."""
    mesh = make_test_mesh()
    rules = make_rules(mesh, rcfg.parallel.layout)
    with jax.set_mesh(mesh):
        grad = jax.jit(jax.grad(
            lambda p, b: ref_ts.loss_fn(p, rcfg, b, rules, 1, None)[0]))
        pods = [grad(rs.params, {k: v[2 * c:2 * c + 2]
                                 for k, v in batch.items()})
                for c in range(2)]

    def codes(g0, g1, e):
        gc = [g.astype(jnp.float32) + e for g in (g0, g1)]
        scale = jnp.maximum(*[jnp.max(jnp.abs(x)) / levels + 1e-12
                              for x in gc])
        return sum(jnp.clip(jnp.round(x / scale), -levels, levels)
                   .astype(jnp.int8) for x in gc)

    return [np.asarray(x) for x in
            jax.tree.leaves(jax.tree.map(codes, *pods, rs.ef))]


def _payloads(monkeypatch):
    """Every int8 sum the local mesh makes, in order."""
    seen = []
    psum = mesh_mod.LocalMesh.psum

    def spy(self, x, axis):
        out = psum(self, x, axis)
        if x.dtype == torch.int8:
            assert out.dtype == torch.int8
            seen.append(out[0])
        return out

    monkeypatch.setattr(mesh_mod.LocalMesh, "psum", spy)
    return seen


def _leaves_as_reference(state_tree, cfg, rs_tree):
    """(port leaves, reference leaves) of one tree, each as the
    reference's (layer-stacked) arrays, in its order."""
    got = [np.stack([x.detach().float().numpy() for x in parts])
           if ndim > parts[0].ndim else parts[0].detach().float().numpy()
           for parts, ndim in opt.groups(state_tree)]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(rs_tree)]
    return got, want


def test_compressed_step_tracks_reference(pod_mesh, monkeypatch):
    rcfg, cfg = _cfgs()
    batch = _batch(cfg)
    rules = make_rules(pod_mesh, rcfg.parallel.layout)
    rs = ref_ts.init_state(jax.random.PRNGKey(0), rcfg, compressed=True)
    state = convert.train_state_from_numpy(cfg, jax.tree.map(np.asarray, rs),
                                           device="cpu")
    want_codes = _ref_codes(rcfg, rs, batch)
    seen = _payloads(monkeypatch)
    step = ts.make_train_step_compressed(cfg, LocalMesh((2,), ("pod",)))
    with jax.set_mesh(pod_mesh):
        rstep = jax.jit(ref_ts.make_train_step_compressed(rcfg, rules, 2,
                                                          pod_mesh))
        for i in range(3):
            rs, rm = rstep(rs, batch)
            state, m = step(state, batch)
            if i == 0:
                np.testing.assert_allclose(float(m["loss"]),
                                           float(rm["loss"]), **FIRST_LOSS)
                sums = iter(seen)
                off = total = 0
                for (parts, ndim), want in zip(opt.groups(state.params),
                                               want_codes, strict=True):
                    got = torch.stack([next(sums) for _ in parts]) \
                        if ndim > parts[0].ndim else next(sums)
                    d = np.abs(got.numpy().astype(np.int32)
                               - want.astype(np.int32))
                    assert d.max() <= 1
                    off, total = off + int((d > 0).sum()), total + d.size
                assert off <= CODES_OFF_SHARE * total, (off, total)
            if i in (0, 2):
                got, want = _leaves_as_reference(state.ef, cfg, rs.ef)
                d = np.concatenate([np.abs(a - b).ravel()
                                    for a, b in zip(got, want, strict=True)])
                assert (d > EF_ATOL).sum() <= EF_OFF_SHARE * d.size
                assert d.max() <= EF_MAX
                got, want = _leaves_as_reference(state.params, cfg, rs.params)
                for a, b in zip(got, want, strict=True):
                    np.testing.assert_allclose(a, b, **PARAMS)
    assert int(state.step) == 3 == int(rs.step)


def test_compressed_pod_allreduce_trains():
    """The reference's ``test_grad_compress.py`` on the port: the loss
    falls over 12 steps, and the baseline step's first loss is within 2 %
    of the compressed one's."""
    _, cfg = _cfgs("bfloat16")
    batch = _batch(cfg)
    state = ts.init_state(cfg, torch.Generator().manual_seed(0),
                          compressed=True)
    step = ts.make_train_step_compressed(cfg, LocalMesh((2,), ("pod",)))
    state, m = step(state, batch)
    l0 = float(m["loss"])
    for _ in range(12):
        state, m = step(state, batch)
    l1 = float(m["loss"])
    assert l1 < l0, (l0, l1)
    base = ts.init_state(cfg, torch.Generator().manual_seed(0))
    _, mb = ts.make_train_step(cfg)(base, batch)
    assert abs(float(mb["loss"]) - l0) / l0 < 0.02, (float(mb["loss"]), l0)


def test_compressed_step_needs_a_pod_axis_and_an_even_batch():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="pod"):
        ts.make_train_step_compressed(cfg, LocalMesh((2,), ("model",)))
    state = ts.init_state(cfg, torch.Generator().manual_seed(0),
                          compressed=True)
    step = ts.make_train_step_compressed(cfg, LocalMesh((2,), ("pod",)))
    batch = {k: v[:3] for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="split"):
        step(state, batch)


SCRIPT = textwrap.dedent("""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    STEPS = 3


    def run(mesh, cfg, batch):
        from repro_torch.train import train_step as ts
        state = ts.init_state(cfg, torch.Generator().manual_seed(0),
                              compressed=True)
        step = ts.make_train_step_compressed(cfg, mesh)
        losses = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            losses.append(m["loss"])
        return state, losses


    def rank_main(rank, world, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        import dataclasses
        from repro_torch.configs.registry import get_config
        from repro_torch.dist import LocalMesh, ProcessGroupMesh
        from repro_torch.train import optimizer as opt
        cfg = dataclasses.replace(get_config("yi_6b", smoke=True),
                                  dtype="float32")
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (4, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "mask": np.ones((4, 16), np.float32)}
        local, local_losses = run(LocalMesh((2,), ("pod",)), cfg, batch)
        payload = []
        all_reduce = dist.all_reduce

        def spy(t, *args, **kwargs):
            payload.append(t.dtype)
            return all_reduce(t, *args, **kwargs)

        dist.all_reduce = spy
        pg, pg_losses = run(ProcessGroupMesh((2,), ("pod",)), cfg, batch)
        dist.all_reduce = all_reduce
        n_leaves = len(opt.tree_leaves(pg.params))
        assert payload.count(torch.int8) == STEPS * n_leaves, payload
        assert all(torch.equal(a, b) for a, b in zip(local_losses, pg_losses))
        for tree in ("params", "ef"):
            for a, b in zip(opt.tree_leaves(getattr(local, tree)),
                            opt.tree_leaves(getattr(pg, tree))):
                assert torch.equal(a, b), tree
        for tree in ("master", "m", "v"):
            for a, b in zip(opt.tree_leaves(getattr(local.opt, tree)),
                            opt.tree_leaves(getattr(pg.opt, tree))):
                assert torch.equal(a, b), tree
        assert int(pg.step) == STEPS and int(pg.opt.count) == STEPS
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            print("GLOO_COMPRESSED_OK", [float(x) for x in pg_losses])


    if __name__ == "__main__":
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(rank_main, args=(2, port), nprocs=2, join=True)
""")


def test_process_group_step_is_bitwise_the_local_one(tmp_path):
    script = tmp_path / "gloo_compressed.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert "GLOO_COMPRESSED_OK" in out.stdout, out.stdout + out.stderr[-3000:]
