"""The data-parallel step with its optimizer state sharded over ``fsdp``
(ZeRO-1), on the CPU.

* The sharded AdamW update is **bitwise** the unsharded one, given the
  same gradients, at fsdp widths 1-4 on a ``LocalMesh`` (width 3 leaves
  short slices), and over 2 and 4 gloo ranks.
* The split-batch step (yi-6b smoke config in float32, batch split over
  ``data`` = 2) against the reference's step jitted with ``in_shardings``
  from its ``state_specs`` on a 2 x 1 ``("data", "model")`` mesh of the
  conftest's fake devices, 3 steps under the default ``OptCfg``: loss
  within rtol 1e-5 (the float32 loss tolerance of
  ``test_torch_train.py``; the slices' partial sums reorder the
  reference's one sum: 1.0e-7 seen), parameters within 1e-5 of each
  leaf's largest magnitude (the gradient tolerance of
  ``test_torch_train.py``; 8.2e-8 seen), ``grad_norm`` within rtol 1e-5
  at every step (1.8e-7 seen): clipping and Adam's normalisation would
  hide a gradient off by a constant factor from the loss and the weights,
  not from the norm before clipping.  Over 2
  and 4 gloo ranks the same step is bitwise the ``LocalMesh`` one: the
  slices' gradients are gathered and summed in slice order on both.
* Checkpoints of sharded state hold the whole arrays: byte-equal files to
  the unsharded run's (with the batch replicated, so that the gradients
  are the unsharded run's), restored by ``reshard_restore`` onto fsdp
  widths 1 and 4 and continued bitwise the unsharded run.
"""

import dataclasses
import filecmp
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs.registry import get_config as ref_config
from repro.dist.specs import make_rules as ref_make_rules
from repro.launch.mesh import make_test_mesh
from repro.train import train_step as ref_ts
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.elastic import reshard_restore
from repro_torch.configs.registry import get_config
from repro_torch.data import lm_synth
from repro_torch.dist import LocalMesh
from repro_torch.dist.specs import make_rules
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_LOSS = dict(rtol=1e-5, atol=0)
SPLIT_NORM = dict(rtol=1e-5, atol=0)
PARAM_OF_LEAF_MAX = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(dtype="float32"):
    return dataclasses.replace(get_config("yi_6b", smoke=True), dtype=dtype)


def _mesh(width):
    return LocalMesh((width, 1), ("data", "model"))


def _flat(tree):
    """The tensors of an optimizer-state tree, whole, in groups order."""
    return [x.full() if isinstance(x, opt.Shard) else x
            for parts, _ in opt.groups(tree) for x in parts]


def _same_state(a, b):
    for x, y in zip(opt.tree_leaves(a.params), opt.tree_leaves(b.params),
                    strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for name in ("master", "m", "v"):
        for x, y in zip(_flat(getattr(a.opt, name)),
                        _flat(getattr(b.opt, name)), strict=True):
            assert torch.equal(x, y), name
    assert int(a.opt.count) == int(b.opt.count)
    assert int(a.step) == int(b.step)


# ---------------------------------------------------------------------------
# the sharded update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_sharded_apply_is_bitwise_the_unsharded(width):
    """bf16 weights, float32 state, three updates from random gradients
    (the same for both); grad_norm, master, m, v and the weights bitwise."""
    cfg = _cfg("bfloat16")
    mesh = _mesh(width)
    rules = make_rules(mesh, "tp")
    a = ts.init_state(cfg, torch.Generator().manual_seed(0))
    b = ts.init_state(cfg, torch.Generator().manual_seed(0))
    b.opt = opt.shard(b.opt, b.params, transformer.param_specs(
        cfg, rules, for_opt=True), mesh, rules.fsdp)
    assert opt.is_sharded(b.opt) == (width > 1)
    if width == 3:
        short = [x for parts, _ in opt.groups(b.opt.master) for x in parts
                 if isinstance(x, opt.Shard) and x.shape[x.dim] % 3]
        assert short                         # d_model 64, d_ff 128
        x = short[0]
        sizes = [p.shape[x.dim] for p in x.parts()]
        assert sizes == [len(r) for r in torch.tensor_split(
            torch.arange(x.shape[x.dim]), 3)] and sizes[-1] < sizes[0]
    rng = np.random.default_rng(3)
    ocfg = opt.OptCfg(lr=1e-2, warmup_steps=1, decay_steps=10)
    for _ in range(3):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32)).to(p.dtype) for p in opt.tree_leaves(a.params)]
        _, a.opt, sa = opt.apply(ocfg, a.opt, grads, a.params)
        _, b.opt, sb = opt.apply(ocfg, b.opt, grads, b.params)
        assert torch.equal(sa["grad_norm"], sb["grad_norm"])
        assert torch.equal(sa["lr"], sb["lr"])
    _same_state(a, b)


def test_unsharded_leaves_stay_whole_and_width_one_is_the_plain_step():
    cfg = _cfg()
    mesh = _mesh(2)
    rules = make_rules(mesh, "tp")
    state = ts.init_state(cfg, torch.Generator().manual_seed(0))
    sharded = opt.shard(state.opt, state.params,
                        transformer.param_specs(cfg, rules, True), mesh,
                        rules.fsdp)
    master = sharded.master
    assert not isinstance(master["final_norm"]["scale"], opt.Shard)
    assert not isinstance(master["blocks"]["norm1"]["scale"].parts[0],
                          opt.Shard)
    wq = master["blocks"]["attn"]["wq"].parts[0]
    assert isinstance(wq, opt.Shard) and wq.dim == 0 and wq.whole
    emb = master["embed"]
    assert emb.dim == 1                       # (V, D): D on fsdp
    assert opt.shard(sharded, state.params, {}, mesh, rules.fsdp) is sharded
    one = make_rules(_mesh(1), "tp")
    assert type(ts.make_train_step(cfg, mesh=_mesh(1), rules=one)) is \
        ts.TrainStep
    assert type(ts.make_train_step(cfg, mesh=mesh, rules=rules)) is \
        ts.ShardedTrainStep
    with pytest.raises(ValueError, match="mesh"):
        ts.make_train_step(cfg, rules=rules)


# ---------------------------------------------------------------------------
# the split-batch step against the reference's GSPMD step
# ---------------------------------------------------------------------------

def test_split_batch_step_tracks_the_reference_gspmd_step():
    rcfg = dataclasses.replace(ref_config("yi_6b", smoke=True),
                               dtype="float32")
    cfg = _cfg()
    data = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=4)
    rmesh = make_test_mesh((2, 1), ("data", "model"))
    rrules = ref_make_rules(rmesh, "tp", batch_size=4)
    rs = ref_ts.init_state(jax.random.PRNGKey(0), rcfg)
    state = convert.train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, rs), device="cpu")
    mesh = _mesh(2)
    rules = make_rules(mesh, "tp", batch_size=4)
    assert rules.dp == ("data",) and rules.fsdp == "data"
    step = ts.make_train_step(cfg, mesh=mesh, rules=rules)
    with jax.set_mesh(rmesh):
        shard = jax.tree.map(lambda s: NamedSharding(rmesh, s),
                             ref_ts.state_specs(rcfg, rrules),
                             is_leaf=lambda x: isinstance(x, P))
        bsh = NamedSharding(rmesh, P(rrules.dp, None))
        rstep = jax.jit(ref_ts.make_train_step(rcfg, rrules, 1, mesh=rmesh),
                        in_shardings=(shard, {"tokens": bsh, "labels": bsh,
                                              "mask": bsh}))
        rs = jax.device_put(rs, shard)
        for i in range(3):
            batch = lm_synth.batch_at(data, i)
            rs, rm = rstep(rs, batch)
            state, m = step(state, batch)
            np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                       err_msg=f"step {i}", **SPLIT_LOSS)
            np.testing.assert_allclose(float(m["tokens"]),
                                       float(rm["tokens"]))
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(rm["grad_norm"]),
                                       err_msg=f"step {i}", **SPLIT_NORM)
    assert opt.is_sharded(state.opt)
    want = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, rs.params), device="cpu")
    for (name, a), b in zip(state.params.named_parameters(),
                            want.parameters()):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_OF_LEAF_MAX * scale,
                                   err_msg=name)


def test_split_batch_needs_an_even_batch():
    cfg = _cfg()
    mesh = _mesh(2)
    step = ts.make_train_step(cfg, mesh=mesh, rules=make_rules(mesh, "tp"))
    state = ts.init_state(cfg, torch.Generator().manual_seed(0))
    data = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=8,
                              global_batch=3)
    with pytest.raises(ValueError, match="does not split"):
        step(state, lm_synth.batch_at(data, 0))


# ---------------------------------------------------------------------------
# the same step over gloo ranks
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import dataclasses
    import os
    import socket
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    STEPS = 3


    def run(mesh, cfg, data, steps=STEPS, state=None):
        from repro_torch.dist.specs import make_rules
        from repro_torch.data import lm_synth
        from repro_torch.train import train_step as ts
        rules = make_rules(mesh, "tp", batch_size=data.global_batch)
        if state is None:
            state = ts.init_state(cfg, torch.Generator().manual_seed(0))
        step = ts.make_train_step(cfg, mesh=mesh, rules=rules)
        assert type(step) is ts.ShardedTrainStep
        losses = []
        start = int(state.step)
        for i in range(start, start + steps):
            state, m = step(state, lm_synth.batch_at(data, i))
            losses.append(m["loss"])
        return state, losses


    def whole(tree):
        from repro_torch.train import optimizer as opt
        return [x.full() if isinstance(x, opt.Shard) else x
                for parts, _ in opt.groups(tree) for x in parts]


    def same(a, b):
        from repro_torch.train import optimizer as opt
        for x, y in zip(opt.tree_leaves(a.params), opt.tree_leaves(b.params)):
            assert torch.equal(x, y), "params"
        for name in ("master", "m", "v"):
            for x, y in zip(whole(getattr(a.opt, name)),
                            whole(getattr(b.opt, name)), strict=True):
                assert torch.equal(x, y), name


    def rank_main(rank, world, port, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.checkpoint.elastic import reshard_restore
        from repro_torch.configs.registry import get_config
        from repro_torch.data import lm_synth
        from repro_torch.dist import LocalMesh, ProcessGroupMesh
        from repro_torch.dist.specs import make_rules
        from repro_torch.train import optimizer as opt
        from repro_torch.train import train_step as ts
        cfg = dataclasses.replace(get_config("yi_6b", smoke=True),
                                  dtype="float32")
        data = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4)
        shape = {2: (2, 1), 4: (4, 1)}
        pgs = {w: ProcessGroupMesh(shape[w], ("data", "model"),
                                   ranks=list(range(w))) for w in (2, 4)}
        for w in (2, 4):
            pg = pgs[w]
            if pg.coords is None:
                continue
            local, local_losses = run(LocalMesh(shape[w], ("data", "model")),
                                      cfg, data)
            state, losses = run(pg, cfg, data)
            assert all(torch.equal(a, b) for a, b in
                       zip(local_losses, losses))
            master = state.opt.master["blocks"]["attn"]["wq"].parts[0]
            assert not master.whole and master.local.shape[0] == 64 // w
            same(local, state)
            if w == 2:
                # width 2 writes whole arrays; restore onto 4 ranks
                d = os.path.join(out, f"pg{rank}")
                Checkpointer(d).save(STEPS, state, {"step": STEPS})
                Checkpointer(os.path.join(out, f"local{rank}")).save(
                    STEPS, local, {"step": STEPS})
        dist.barrier()
        runs = []
        for mesh, ckpt in ((pgs[4], "pg0"),
                           (LocalMesh(shape[4], ("data", "model")),
                            "local0")):
            fresh = ts.init_state(cfg, torch.Generator().manual_seed(0))
            specs = ts.state_specs(cfg, make_rules(mesh, "tp"))
            back, _ = reshard_restore(Checkpointer(os.path.join(out, ckpt)),
                                      fresh, specs, mesh, device="cpu")
            assert not opt.is_sharded(back.opt)   # the step shards it
            back = run(mesh, cfg, data, 1, back)[0]
            assert opt.is_sharded(back.opt)
            runs.append(back)
        same(*runs)
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            print("GLOO_ZERO_OK", [float(x) for x in losses])


    if __name__ == "__main__":
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(rank_main, args=(4, port, sys.argv[1]), nprocs=4,
                 join=True)
""")


def test_process_group_step_is_bitwise_the_local_one(tmp_path):
    """2 and 4 gloo ranks (a 4-rank world; the 2-wide mesh takes ranks 0
    and 1): 3 split-batch steps bitwise the ``LocalMesh`` step's (losses,
    weights, whole master, m and v), each rank holding its slices only;
    the 2-wide state's checkpoint, written whole by each of its ranks,
    byte-equal to the ``LocalMesh`` state's, restored onto the 4 ranks and
    stepped once, bitwise the ``LocalMesh`` run stepped once."""
    script = tmp_path / "gloo_zero.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert "GLOO_ZERO_OK" in out.stdout, out.stdout + out.stderr[-3000:]
    for r in (0, 1):
        _same_files(tmp_path / f"pg{r}", tmp_path / f"local{r}")


# ---------------------------------------------------------------------------
# checkpoints, the loop and the entry point
# ---------------------------------------------------------------------------

def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _same_files(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), pa


def test_sharded_checkpoints_are_the_unsharded_ones(tmp_path):
    """``launch.train.train`` with the batch replicated (batch 1: the
    rules keep no dp axis, so the gradients are the unsharded run's) on
    fsdp width 2 and with no mesh: the same losses, the same weights, and
    byte-equal checkpoint files from the fault-tolerant loop.  The width-2
    checkpoint restores through ``reshard_restore`` onto widths 1 and 4
    and continues bitwise the unsharded run."""
    cfg = _cfg()
    kw = dict(smoke=True, batch=1, seq=16, ckpt_every=2, device="cpu",
              cfg=cfg)
    plain, rep, _ = launch_train.train("yi-6b", steps=4,
                                       ckpt_dir=str(tmp_path / "plain"),
                                       **kw)
    sharded, rep2, _ = launch_train.train("yi-6b", steps=4,
                                          ckpt_dir=str(tmp_path / "w2"),
                                          mesh=_mesh(2), **kw)
    assert make_rules(_mesh(2), "tp", batch_size=1).dp is None
    assert opt.is_sharded(sharded.opt)
    assert rep.losses == rep2.losses
    _same_state(plain, sharded)
    _same_files(tmp_path / "plain", tmp_path / "w2")
    data = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=16,
                              global_batch=1)
    ocfg = opt.OptCfg(warmup_steps=1, decay_steps=6)
    ref = plain
    for i in (4, 5):
        ref, _ = ts.make_train_step(cfg, ocfg)(ref, lm_synth.batch_at(data, i))
    for width in (1, 4):
        fresh = ts.init_state(cfg, torch.Generator().manual_seed(7))
        rules = make_rules(_mesh(width), "tp", batch_size=1)
        back, meta = reshard_restore(Checkpointer(tmp_path / "w2"), fresh,
                                     ts.state_specs(cfg, rules),
                                     _mesh(width), device="cpu")
        assert meta["step"] == 4 and not opt.is_sharded(back.opt)
        step = ts.make_train_step(cfg, ocfg, _mesh(width), rules)
        for i in (4, 5):
            back, _ = step(back, lm_synth.batch_at(data, i))
        assert opt.is_sharded(back.opt) == (width > 1)
        _same_state(ref, back)


def test_elastic_restore_between_mesh_shapes(tmp_path):
    """The mirror of ``test_runtime.py::test_elastic_restore_between_mesh_
    shapes``: parameters saved under one mesh restore under another mesh's
    specs, equal leaf for leaf."""
    cfg = get_config("yi_6b", smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    ck = Checkpointer(tmp_path)
    ck.save(1, params)
    mesh2 = LocalMesh((1, 1), ("data", "model"))
    specs = transformer.param_specs(cfg, make_rules(mesh2, "tp"))
    restored, _ = reshard_restore(ck, params, specs, mesh2, device="cpu")
    for a, b in zip(opt.tree_leaves(params), opt.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_entry_point_at_width_2(tmp_path):
    """``launch.train.train(mesh=...)`` on a 2 x 1 mesh: the batch of 4
    split over ``data``, the state sharded, the loss falling."""
    state, report, _ = launch_train.train(
        "yi-6b", True, 8, 4, 16, str(tmp_path), lr=1e-2,
        mesh=_mesh(2), ckpt_every=4, device="cpu")
    assert report.final_step == 8 and int(state.step) == 8
    assert opt.is_sharded(state.opt)
    assert report.losses[-1] < report.losses[0]
