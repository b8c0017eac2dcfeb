"""One train step of each of the port's ten architectures against the JAX
package's, on the CPU.

Mirror of ``tests/test_arch_smoke.py::test_train_step_runs_and_updates``,
held against the reference's jitted step from the same state: the
reference's ``init_state`` carried bit for bit by
``convert.train_state_from_numpy``, the same numpy batch (with the stub
frontend's embeddings where the arch has one), both steps on their
one-bank test mesh (an ``ep`` config's MoE runs expert-parallel).

Tolerances (float32 configs, ``dataclasses.replace(cfg,
dtype="float32")``, under the default ``OptCfg``):

* loss, aux and the global gradient norm: rtol 1e-5 (summation order);
* the first moment ``m`` (0.1 x the clipped gradient) leaf by leaf within
  1e-5 of the leaf's largest magnitude, as ``test_torch_train.py`` holds
  gradients;
* master weights and parameters: atol ``2.5 * lr`` plus rtol 1e-6.
  Adam's first step moves every weight by about ``lr`` times the sign of
  its gradient whatever the gradient's size, so a near-zero gradient
  whose sign differs between the packages moves its weight ``2 * lr``
  apart; every other weight agrees to rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as ref_config
from repro.dist.specs import make_rules
from repro.launch.mesh import make_test_mesh
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                 leaves_with_paths)
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_test_mesh as port_mesh
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

SCALARS = dict(rtol=1e-5, atol=0)
GRAD_OF_LEAF_MAX = 1e-5
B, S = 2, 32


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "mask": np.ones((B, S), np.float32)}
    if cfg.frontend is not None:
        batch["embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, transformer.STUB_FRONTEND_DIM)
        ).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference(arch):
    rcfg, cfg = (dataclasses.replace(get(arch, smoke=True), dtype="float32")
                 for get in (ref_config, get_config))
    mesh = make_test_mesh()
    rs = ref_ts.init_state(jax.random.PRNGKey(0), rcfg)
    state = convert.train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, rs), device="cpu")
    batch = _batch(cfg)
    before = {n: p.detach().clone()
              for n, p in state.opt.master.named_parameters()}
    with jax.set_mesh(mesh):
        rules = make_rules(mesh, rcfg.parallel.layout)
        rs, rm = jax.jit(ref_ts.make_train_step(
            rcfg, rules, 1, ref_opt.OptCfg(), mesh))(rs, batch)
    state, m = ts.make_train_step(cfg, opt.OptCfg(), port_mesh())(state,
                                                                   batch)
    assert int(state.step) == 1 == int(rs.step)
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), err_msg=k,
                                   **SCALARS)
    assert np.isfinite(float(m["loss"]))
    if cfg.moe is None:
        assert float(m["aux"]) == 0.0
    rs_np = jax.tree.map(np.asarray, rs)
    lr = float(ref_opt.lr_schedule(ref_opt.OptCfg(), jnp.int32(1)))

    def tree(t):
        return dict(convert.lm_params_from_numpy(
            cfg, t, device="cpu", dtype=torch.float32).named_parameters())

    for name, want in tree(rs_np.opt.m).items():
        got = dict(state.opt.m.named_parameters())[name]
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=GRAD_OF_LEAF_MAX * scale,
                                   err_msg=name)
    moved = 0
    for name, want in tree(rs_np.opt.master).items():
        got = dict(state.opt.master.named_parameters())[name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=2.5 * lr, err_msg=name)
        np.testing.assert_array_equal(
            dict(state.params.named_parameters())[name].detach().numpy(),
            got.numpy())
        moved += int(not torch.equal(got, before[name]))
    assert moved > 0


def _bytes(x) -> np.ndarray:
    """A leaf of either package as a host array holding its bits (bf16 as
    int16, a layer stack stacked)."""
    if hasattr(x, "parts"):
        return np.stack([_bytes(p) for p in x.parts])
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return np.ascontiguousarray(x.numpy())
    x = np.asarray(x)
    return np.ascontiguousarray(x.view(np.int16) if x.dtype.name ==
                                "bfloat16" else x)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "xlstm_125m",
                                  "recurrentgemma_2b"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_training_checkpoint_crosses_packages(tmp_path, arch, writer):
    """A training state of a scanned MoE/MLA stack (deepseek, (L, ...)
    leaves) and of the heterogeneous stacks (lists of per-layer trees)
    saved by one package's Checkpointer restores in the other's, every
    leaf bitwise, with the same key paths, shapes and dtypes."""
    rcfg, cfg = (get(arch, smoke=True) for get in (ref_config, get_config))
    rs = ref_ts.init_state(jax.random.PRNGKey(3), rcfg)
    state = convert.train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, rs), device="cpu")
    if writer == "reference":
        RefCheckpointer(tmp_path, keep=1).save(4, rs)
        port_side, _ = Checkpointer(tmp_path).restore(state, device="cpu")
        ref_side = rs
    else:
        Checkpointer(tmp_path, keep=1).save(4, state)
        ref_side, _ = RefCheckpointer(tmp_path).restore(rs)
        port_side = state
    got = [_bytes(x) for _, x in leaves_with_paths(port_side)]
    want = [_bytes(x) for x in jax.tree.leaves(ref_side)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))
    paths = {p for p, _ in leaves_with_paths(state)}
    stacked = rcfg.scan_layers and rcfg.uniform_pattern
    assert (".params/['blocks']/['moe']/['router']" in paths) == stacked
    assert (".params/['blocks']/[0]/['xl']/['w_if']" in paths) == (
        arch == "xlstm_125m")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_drivers_take_every_arch(arch, tmp_path):
    """``launch.serve`` serves and ``launch.train`` trains every arch's
    smoke config by its dashed alias (frontend archs on zero stub
    embeddings, as the reference's driver feeds them)."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    alias = arch.replace("_", "-")
    out = launch_serve.main(["--arch", alias, "--device", "cpu",
                             "--requests", "2", "--max-new", "2"])
    assert sorted(out["results"]) == [0, 1]
    state, report, _ = launch_train.train(alias, True, 2, 2, 16,
                                          str(tmp_path), device="cpu")
    assert int(state.step) == 2 and np.isfinite(report.losses).all()
