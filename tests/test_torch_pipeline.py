"""GPipe pipeline schedule: the port against the reference and against
sequential execution.

The reference's ``make_pp_forward`` runs on ``jax.make_mesh((2, 2, 2),
("pod", "data", "model"))`` over the conftest's 8 fake CPU devices, in
this process, at its own test's sizes (L = 8, D = 32, M = 4, Bμ = 2,
S = 16, 2 stages); the port's on ``LocalMesh((2,), ("pod",))`` and on 2
gloo ranks of a :class:`~repro_torch.dist.ProcessGroupMesh` (spawned in
one subprocess), which must give the local mesh's output bitwise.

Tolerances: float32, atol and rtol 1e-5 against the reference's output
and against applying the layers in order (the reference test's).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.dist import pipeline as ref_pipeline
from repro_torch.dist import LocalMesh
from repro_torch.dist.pipeline import bubble_fraction, make_pp_forward

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
L, D, M, BMU, S = 8, 32, 4, 2, 16


def _block(lp, x):
    return torch.tanh(x @ lp["w"]) + x


def _ref_block(lp, x):
    return jnp.tanh(x @ lp["w"]) + x


@pytest.fixture(scope="module")
def pod_mesh():
    return jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def _inputs():
    """The reference test's draws, as numpy."""
    w = jax.random.normal(jax.random.PRNGKey(0), (L, D, D), jnp.float32) * 0.3
    x = jax.random.normal(jax.random.PRNGKey(1), (M, BMU, S, D), jnp.float32)
    return np.array(w), np.array(x)


def test_bubble_fraction():
    assert bubble_fraction(2, 4) == 0.2
    assert bubble_fraction(4, 12) == 0.2
    assert bubble_fraction(1, 8) == 0.0
    for stages, micro in ((2, 4), (4, 12), (1, 8), (3, 5)):
        assert bubble_fraction(stages, micro) == \
            ref_pipeline.bubble_fraction(stages, micro)
    for bad in ((0, 4), (2, 0)):
        with pytest.raises(ValueError):
            bubble_fraction(*bad)


def test_pipeline_matches_reference_and_sequential(pod_mesh):
    w, x = _inputs()
    fwd = make_pp_forward(_block, n_layers=L, n_stages=2, n_micro=M,
                          mesh=LocalMesh((2,), ("pod",)),
                          in_spec=(None, ("data",), None, None))
    got = fwd({"w": torch.from_numpy(w)}, torch.from_numpy(x))
    assert got.shape == (2 * M, BMU, S, D)

    ref_fwd = ref_pipeline.make_pp_forward(
        _ref_block, n_layers=L, n_stages=2, n_micro=M, mesh=pod_mesh,
        in_spec=P(None, ("data",), None, None))
    with jax.set_mesh(pod_mesh):
        w_sh = jax.device_put(w, NamedSharding(pod_mesh, P("pod", None, None)))
        want = np.asarray(jax.device_get(jax.jit(ref_fwd)({"w": w_sh}, x)))
    # the last stage's block holds the valid outputs
    np.testing.assert_allclose(got[M:].numpy(), want[M:], **TOL)

    seq = torch.from_numpy(x)
    for layer in range(L):
        seq = _block({"w": torch.from_numpy(w[layer])}, seq)
    np.testing.assert_allclose(got[M:].numpy(), seq.numpy(), **TOL)


def test_bad_arguments_raise_as_the_reference_does(pod_mesh):
    local = LocalMesh((2,), ("pod",))
    spec = (None, None, None, None)
    cases = [
        (dict(mesh=LocalMesh((2,), ("model",)), n_stages=2),
         dict(mesh=jax.make_mesh((8,), ("model",)), n_stages=2)),
        (dict(mesh=local, n_stages=4), dict(mesh=pod_mesh, n_stages=4)),
        (dict(mesh=local, n_stages=2, n_layers=7),
         dict(mesh=pod_mesh, n_stages=2, n_layers=7)),
        (dict(mesh=local, n_stages=2, in_spec=("pod", None, None, None)),
         dict(mesh=pod_mesh, n_stages=2, in_spec=P("pod", None, None, None))),
    ]
    for port_kw, ref_kw in cases:
        with pytest.raises(ValueError):
            ref_pipeline.make_pp_forward(
                _ref_block, **{"n_layers": L, "n_micro": M,
                               "in_spec": P(*spec), **ref_kw})
        with pytest.raises(ValueError):
            make_pp_forward(_block, **{"n_layers": L, "n_micro": M,
                                       "in_spec": spec, **port_kw})
    fwd = make_pp_forward(_block, L, 2, M, local, spec)
    with pytest.raises(ValueError, match="n_micro"):
        fwd({"w": torch.zeros(L, D, D)}, torch.zeros(M + 1, BMU, S, D))


SCRIPT = textwrap.dedent("""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    L, D, M, BMU, S = 8, 32, 4, 2, 16


    def block(lp, x):
        return torch.tanh(x @ lp["w"]) + x


    def rank_main(rank, world, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch.dist import LocalMesh, ProcessGroupMesh
        from repro_torch.dist.pipeline import make_pp_forward
        rng = np.random.default_rng(0)
        w = torch.from_numpy((rng.standard_normal((L, D, D)) * 0.3)
                             .astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((M, BMU, S, D))
                             .astype(np.float32))
        spec = (None, ("data",), None, None)
        local = make_pp_forward(block, L, 2, M, LocalMesh((2,), ("pod",)),
                                spec)({"w": w}, x)
        pg = make_pp_forward(block, L, 2, M, ProcessGroupMesh((2,), ("pod",)),
                             spec)({"w": w}, x)
        assert pg.shape == (2 * M, BMU, S, D)
        assert torch.equal(pg, local)
        seq = x
        for layer in range(L):
            seq = block({"w": w[layer]}, seq)
        np.testing.assert_allclose(pg[M:].numpy(), seq.numpy(), atol=1e-5,
                                   rtol=1e-5)
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            print("GLOO_PIPELINE_OK")


    if __name__ == "__main__":
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(rank_main, args=(2, port), nprocs=2, join=True)
""")


def test_process_group_pipeline_is_bitwise_the_local_one(tmp_path):
    script = tmp_path / "gloo_pipeline.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert "GLOO_PIPELINE_OK" in out.stdout, out.stdout + out.stderr[-3000:]
