"""The port's sharding rules and spec trees against the JAX package's.

A spec here is a tuple of mesh axis names; the reference's is a
``PartitionSpec``.  Each reference spec is read as a tuple, with a
one-name tuple entry read as the name (``PartitionSpec`` treats the two
alike, and the reference's own trees hold both forms for the same binding:
its ``cache_specs`` unpacks a spec, which unwraps ``("data",)``).  Every
comparison is then exact, leaf for leaf: ``param_specs`` (weights and
``for_opt``), ``cache_specs`` and ``train_step.state_specs`` (with and
without EF buffers) for all ten registry archs, on both layouts, on
``("data", "model")`` meshes of 1 x 1 and 2 x 4 and on ``("model",)``
alone; ``make_rules``' bindings, ``batch_size=`` included; and the
``moe_zero1`` variant, which also trains one step.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ARCH_IDS, get_config as ref_config
from repro.dist.specs import make_rules as ref_make_rules
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as ref_transformer
from repro.train import train_step as ref_ts
from repro_torch.configs.registry import get_config
from repro_torch.dist import LocalMesh
from repro_torch.dist.specs import make_rules
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((8,), ("model",))]
ROLES = ("act_resid", "act_heads", "act_seq_heads", "act_ff", "w2",
         "w2_row", "embed", "logits", "am_table", "am_queries",
         "am_queries_dp", "am_meta", "am_index")


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _read(tree):
    """A reference spec tree as plain data, each spec a tuple."""
    if isinstance(tree, P):
        return tuple(_entry(e) for e in tree)
    if isinstance(tree, dict):
        return {k: _read(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_read(v) for v in tree]
    if tree is None:
        return None
    return {f.name: _read(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _port(tree):
    """The port's spec tree, with the same reading."""
    if isinstance(tree, tuple):
        return tuple(_entry(e) for e in tree)
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port(v) for v in tree]
    if tree is None:
        return None
    return {f.name: _port(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["1x1", "2x4", "model8"])
@pytest.mark.parametrize("layout", ["tp", "cp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_reference(arch, layout, shape, axes):
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    rrules = ref_make_rules(make_test_mesh(shape, axes), layout)
    rules = make_rules(LocalMesh(shape, axes), layout)
    for for_opt in (False, True):
        assert _port(transformer.param_specs(cfg, rules, for_opt)) == \
            _read(ref_transformer.param_specs(rcfg, rrules, for_opt))
    assert _port(transformer.cache_specs(cfg, rules)) == \
        _read(ref_transformer.cache_specs(rcfg, rrules))
    for compressed in (False, True):
        assert _port(ts.state_specs(cfg, rules, compressed)) == \
            _read(ref_ts.state_specs(rcfg, rrules, compressed))


@pytest.mark.parametrize("batch", [None, 1, 2, 3, 8])
@pytest.mark.parametrize("shape,axes", [
    ((2, 2, 2), ("pod", "data", "model")), ((2, 4), ("data", "model")),
    ((8,), ("data",)), ((8,), ("model",)), ((4, 2), ("pod", "data"))],
    ids=["pod-data-model", "data-model", "data", "model", "pod-data"])
def test_make_rules_binds_as_the_reference(shape, axes, batch):
    """tp, dp and fsdp, and every role, for each mesh and batch.  On a
    mesh whose only axis is ``data``, tp binds to ``data`` and nothing
    shards the weights; on ``("pod", "data")`` tp binds to ``data`` too."""
    for layout in ("tp", "cp"):
        for seq in (True, False):
            want = ref_make_rules(make_test_mesh(shape, axes), layout,
                                  batch_size=batch, resid_seq_shard=seq)
            got = make_rules(LocalMesh(shape, axes), layout,
                             batch_size=batch, resid_seq_shard=seq)
            assert (got.layout, got.tp, got.dp, got.fsdp,
                    got.resid_seq_shard) == (
                want.layout, want.tp, want.dp, want.fsdp,
                want.resid_seq_shard)
            for role in ROLES:
                assert _port(getattr(got, role)()) == \
                    _read(getattr(want, role)()), role
            for flags in ((False, False), (True, True)):
                assert _port(got.am_state(ternary=flags[0],
                                          indexed=flags[1])) == \
                    _read(want.am_state(ternary=flags[0],
                                        indexed=flags[1]))
    if axes == ("data",):
        assert (got.tp, got.fsdp) == ("data", None)
    if axes == ("pod", "data", "model") and batch is not None:
        assert got.dp == {1: None, 2: ("pod",), 3: None,
                          8: ("pod", "data")}[batch]


def test_unknown_layout_is_refused():
    with pytest.raises(ValueError, match="layout"):
        make_rules(LocalMesh((2,), ("model",)), "dp")


@pytest.mark.parametrize("arch", ["yi_6b", "recurrentgemma_2b"])
def test_leaf_specs_map_the_tree_onto_each_layer(arch):
    """``optimizer.leaf_specs``: each per-layer tensor takes its stacked
    leaf's spec without the layer axis, in ``tree_leaves`` order."""
    cfg = get_config(arch, smoke=True)
    rules = make_rules(LocalMesh((2, 4), ("data", "model")),
                       cfg.parallel.layout)
    lm = transformer.LM(cfg, device="meta")
    specs = dict(zip([n for n, _ in lm.named_parameters()],
                     opt.leaf_specs(lm, transformer.param_specs(cfg, rules))))
    assert len(specs) == len(list(lm.parameters()))
    assert specs["embed"] == ("model", "data")
    assert specs["final_norm.scale"] == (None,)
    assert specs["blocks.0.norm1.scale"] == (None,)
    assert specs["blocks.1.mlp.w_down"] == ("model", "data")
    for name, p in lm.named_parameters():
        assert len(specs[name]) == p.ndim, name
    if arch == "yi_6b":
        assert specs["blocks.0.attn.wq"] == ("data", "model")
    else:
        assert specs["blocks.0.rec.lam"] == ("model",)
    with pytest.raises(ValueError):
        opt.leaf_specs(lm, {**transformer.param_specs(cfg, rules),
                            "embed": (None, None, None)})


def test_moe_zero1_spec_structure():
    """The mirror of ``test_perf_variants.py::test_moe_zero1_spec_structure``:
    the weights' expert specs lose the per-layer fsdp dimension, the
    optimizer's keep it, and ``state_specs`` consumes both and trains one
    step, on the reference's 1 x 1 test mesh and on a 2 x 1 mesh, where
    the step shards the state over ``data``: the expert weights' state
    along D, the weights whole."""
    base = get_config("granite_moe_1b_a400m", smoke=True)
    cfg = dataclasses.replace(base, parallel=dataclasses.replace(
        base.parallel, moe_zero1=True))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": tokens, "labels": tokens,
             "mask": np.ones((2, 16), np.float32)}
    for shape in ((1, 1), (2, 1)):
        mesh = LocalMesh(shape, ("data", "model"))
        rules = make_rules(mesh, "tp")
        w = transformer.param_specs(cfg, rules)
        o = transformer.param_specs(cfg, rules, for_opt=True)
        assert w["blocks"]["moe"]["w1"] == (None, rules.tp, None, None)
        assert o["blocks"]["moe"]["w1"] == (None, rules.tp, rules.fsdp, None)
        specs = ts.state_specs(cfg, rules)
        assert specs.params == w and specs.opt.master == o
        state = ts.init_state(cfg, torch.Generator().manual_seed(0))
        step = ts.make_train_step(cfg, mesh=mesh, rules=rules)
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
        assert opt.is_sharded(state.opt) == (shape == (2, 1))
    w1 = state.opt.master["blocks"]["moe"]["w1"].parts[0]
    assert isinstance(w1, opt.Shard) and w1.dim == 1
    assert not isinstance(state.opt.master["blocks"]["moe"]["router"]
                          .parts[0], opt.Shard)
    assert state.params.blocks[0].moe.w1.shape == w1.shape
