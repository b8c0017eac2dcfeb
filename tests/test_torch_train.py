"""The port's training stack against the JAX package, on the CPU.

Data, optimizer, loss, gradients, train steps, the fault-tolerant loop,
the training entry point and training checkpoints.  Weights and optimizer
state come from the reference's ``init_state`` and reach the port bit for
bit through ``convert.train_state_from_numpy``; batches from ``batch_at``
(bitwise the same in both packages) or a seeded numpy generator.

Tolerances:

* ``batch_at`` and ``quantize_grad``'s codes: bitwise.
* ``lr_schedule``, and ``apply`` on identical gradients (master weights,
  moments and float32 parameters): rtol 1e-6; bf16 parameters are
  bitwise the master weights' cast; EF at atol 1e-6 (values of order 1).
  ``apply`` on an LM against the reference's stacked tree: rtol 1e-6 plus
  atol 1e-8 (see that test: the global norm's summation order).
* float32 config (``dataclasses.replace(cfg, dtype="float32")``): loss
  rtol 1e-5 (equal seen); gradients leaf by leaf within 1e-5 of the
  leaf's largest magnitude (7.8e-7 seen: summation order); each of 10
  steps' loss within rtol 1e-4 of the reference's jitted step under the
  default ``OptCfg`` (1.0e-5 seen at step 10; with a 3-step warmup the
  two runs drift to 1.6e-4 by step 10, since Adam's first steps move each
  weight by about ``lr`` whatever the sign noise of a near-zero
  gradient); a training checkpoint resumed in the other package within
  rtol 1e-4 of the package that wrote it.
* bf16 config: ``launch.train.train``'s losses on the reference's weights
  within rtol 5e-3 of the reference's ``train()`` (1.3e-3 seen over 30
  steps: bf16 weights and the same amplification).
"""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.checkpoint.fault_tolerance import FaultTolerantLoop as RefLoop
from repro.configs.registry import get_config as ref_config
from repro.data import lm_synth as ref_synth
from repro.dist.specs import make_rules
from repro.launch.mesh import make_test_mesh
from repro.launch.train import train as ref_train
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.fault_tolerance import (FaultTolerantLoop,
                                                    StragglerMonitor)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import lm_synth
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, transformer
from repro_torch.serve.engine import Engine
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

F32_LOSS = dict(rtol=1e-5, atol=0)
GRAD_OF_LEAF_MAX = 1e-5
STEP_LOSS = dict(rtol=1e-4, atol=0)
BF16_TRAIN_LOSS = dict(rtol=5e-3, atol=0)


def _cfgs(dtype="float32", **parallel):
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


def _states(rcfg, cfg, compressed=False):
    """(reference TrainState, the port's, carried bit for bit)."""
    rs = ref_ts.init_state(jax.random.PRNGKey(0), rcfg, compressed)
    return rs, convert.train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, rs), device="cpu")


def _ref_step(rcfg, mesh, ocfg=ref_opt.OptCfg()):
    rules = make_rules(mesh, rcfg.parallel.layout)
    return jax.jit(ref_ts.make_train_step(rcfg, rules, 1, ocfg, mesh))


def _data(cfg, seq=32, batch=4):
    return lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch)


def _t(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 7, 8])
@pytest.mark.parametrize("shard,n_shards", [(0, 1), (0, 2), (1, 2)])
def test_batch_at_bitwise(step, shard, n_shards):
    args = dict(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
    want = ref_synth.batch_at(ref_synth.LMDataCfg(**args), step, shard,
                              n_shards)
    got = lm_synth.batch_at(lm_synth.LMDataCfg(**args), step, shard, n_shards)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_data_deterministic_and_sharded():
    cfg = lm_synth.LMDataCfg(vocab_size=1000, seq_len=64, global_batch=8)
    a, b = lm_synth.batch_at(cfg, step=7), lm_synth.batch_at(cfg, step=7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], lm_synth.batch_at(cfg, 8)["tokens"])
    s0 = lm_synth.batch_at(cfg, 7, shard=0, n_shards=2)
    s1 = lm_synth.batch_at(cfg, 7, shard=1, n_shards=2)
    assert s0["tokens"].shape[0] == 4 and s1["tokens"].shape[0] == 4
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    with pytest.raises(ValueError):
        lm_synth.batch_at(cfg, 0, n_shards=3)


def test_prefetcher_yields_batch_at_in_order():
    cfg = lm_synth.LMDataCfg(vocab_size=100, seq_len=16, global_batch=2)
    pf = lm_synth.Prefetcher(cfg, start_step=5, depth=2)
    try:
        for step in (5, 6, 7):
            got_step, batch = pf.next()
            assert got_step == step
            np.testing.assert_array_equal(
                batch["tokens"], lm_synth.batch_at(cfg, step)["tokens"])
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_equals_reference():
    args = dict(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_frac=0.1)
    rc, c = ref_opt.OptCfg(**args), opt.OptCfg(**args)
    got = np.array([float(opt.lr_schedule(c, torch.tensor(s, dtype=torch.int32)))
                    for s in range(101)])
    want = np.array([float(ref_opt.lr_schedule(rc, jax.numpy.int32(s)))
                     for s in range(101)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    lrs = got[::10]
    assert lrs[1] == pytest.approx(1.0, abs=1e-3)      # end of warmup
    assert lrs[-1] == pytest.approx(0.1, abs=1e-2)     # decayed to min
    assert all(b <= a + 1e-6 for a, b in zip(lrs[1:], lrs[2:]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_equals_reference(dtype):
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "blk": {"u": (3, 4, 5)}}

    def draw(scale=1.0):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    p0 = draw()
    rparams = jax.tree.map(lambda a: jax.numpy.asarray(a, dtype), p0)
    params = jax.tree.map(
        lambda a: torch.from_numpy(a).to(getattr(torch, dtype)), p0)
    args = dict(lr=1e-2, warmup_steps=2, decay_steps=20, clip_norm=1.0)
    rc, c = ref_opt.OptCfg(**args), opt.OptCfg(**args)
    rstate, state = ref_opt.init(rparams), opt.init(params)
    for _ in range(4):
        g = draw(0.5)
        rparams, rstate, rstats = ref_opt.apply(rc, rstate, g, rparams)
        params, state, stats = opt.apply(
            c, state, jax.tree.map(torch.from_numpy, g), params)
        assert int(state.count) == int(rstate.count)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(rstats["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(stats["lr"]), float(rstats["lr"]),
                                   rtol=1e-6)
        for tree, rtree in ((state.master, rstate.master), (state.m, rstate.m),
                            (state.v, rstate.v)):
            for a, b in zip(opt.tree_leaves(tree), jax.tree.leaves(rtree)):
                np.testing.assert_allclose(_t(a), np.asarray(b), rtol=1e-6)
        for p, mstr in zip(opt.tree_leaves(params),
                           opt.tree_leaves(state.master)):
            assert p.dtype == getattr(torch, dtype)
            assert torch.equal(p, mstr.to(p.dtype))      # bitwise the cast
        for a, b in zip(opt.tree_leaves(params), jax.tree.leaves(rparams)):
            np.testing.assert_allclose(_t(a), np.asarray(b, np.float32),
                                       rtol=1e-6 if dtype == "float32" else 0)


def test_apply_on_an_lm_follows_the_reference_tree():
    """AdamW on an LM against the reference's on its layer-stacked tree,
    with the same gradients: each layer's norm scales, (L, d) leaves
    there, take weight decay (lr * wd = 1e-3 here, far above the
    tolerance); ``final_norm``'s (d,) does not.  The global norm sums in
    another order (a layer at a time here, a stacked leaf there), which can
    move the last bit of ``lr * step`` (9.3e-10 at lr 1e-2); where the
    update nearly cancels the weight that bit is a large share of the
    result, so the master weights are held at rtol 1e-6 plus atol 1e-8
    (7 of 16,384 embedding entries off by 1.9e-9 seen)."""
    rcfg, cfg = _cfgs()
    rs, state = _states(rcfg, cfg)
    rng = np.random.default_rng(4)
    g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), jax.tree.map(np.asarray, rs.params))
    grads = convert.lm_params_from_numpy(cfg, g, device="cpu")
    args = dict(lr=1e-2, warmup_steps=0, decay_steps=10)
    _, ropt_state, _ = ref_opt.apply(ref_opt.OptCfg(**args), rs.opt, g,
                                     rs.params)
    opt.apply(opt.OptCfg(**args), state.opt, list(grads.parameters()),
              state.params)
    want = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, ropt_state.master), device="cpu")
    for (name, a), b in zip(state.opt.master.named_parameters(),
                            want.parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)
    assert not torch.equal(state.opt.master.blocks[0].norm1.scale,
                           state.opt.master.final_norm.scale)


def test_optimizer_reduces_quadratic():
    cfg = opt.OptCfg(lr=0.1, warmup_steps=0, decay_steps=1000,
                     weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        g = {"w": 2 * state.master["w"]}
        params, state, _ = opt.apply(cfg, state, g, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_compression_error_feedback_converges():
    """int8+EF compression: accumulated estimate converges to true mean,
    on the reference test's draw."""
    g_true = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (256,))))
    ef = torch.zeros(256)
    acc = torch.zeros(256)
    for _ in range(64):
        q, scale, ef = opt.quantize_grad(g_true, ef)
        acc += opt.dequantize_grad(q, scale)
    np.testing.assert_allclose((acc / 64).numpy(), g_true.numpy(), atol=1e-3)


def test_quantize_grad_equals_reference():
    rng = np.random.default_rng(1)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    ef = (rng.standard_normal((64, 33)) * 0.01).astype(np.float32)
    for _ in range(3):
        rq, rs, ref = ref_opt.quantize_grad(g, ef)
        q, s, e = opt.quantize_grad(torch.from_numpy(g), torch.from_numpy(ef))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_allclose(float(s), float(rs), rtol=1e-6)
        np.testing.assert_allclose(e.numpy(), np.asarray(ref), atol=1e-6)
        np.testing.assert_allclose(opt.dequantize_grad(q, s).numpy(),
                                   np.asarray(ref_opt.dequantize_grad(rq, rs)),
                                   rtol=1e-6)
        ef = np.asarray(ref)


# ---------------------------------------------------------------------------
# loss, gradients and the train step
# ---------------------------------------------------------------------------

def test_loss_and_gradients_equal_reference(mesh):
    rcfg, cfg = _cfgs()
    rs, state = _states(rcfg, cfg)
    batch = lm_synth.batch_at(_data(cfg), 0)
    rules = make_rules(mesh, rcfg.parallel.layout)
    with jax.set_mesh(mesh):
        (rtotal, rm), rg = jax.jit(jax.value_and_grad(
            lambda p: ref_ts.loss_fn(p, rcfg, batch, rules, 1, mesh),
            has_aux=True))(rs.params)
    total, m = ts.loss_fn(state.params, cfg, batch)
    np.testing.assert_allclose(float(total.detach()), float(rtotal),
                               **F32_LOSS)
    for k in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), **F32_LOSS)
    grads, _ = ts._grads(state.params, cfg, batch)
    want = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rg),
                                        device="cpu")
    names = [n for n, _ in state.params.named_parameters()]
    for name, w, g in zip(names, want.parameters(), grads):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), rtol=0,
                                   atol=GRAD_OF_LEAF_MAX * scale,
                                   err_msg=name)


def test_ten_steps_track_reference(mesh):
    rcfg, cfg = _cfgs()
    rs, state = _states(rcfg, cfg)
    data = _data(cfg, seq=64)
    step = ts.make_train_step(cfg)
    with jax.set_mesh(mesh):
        rstep = _ref_step(rcfg, mesh)
        for i in range(10):
            batch = lm_synth.batch_at(data, i)
            rs, rm = rstep(rs, batch)
            state, m = step(state, batch)
            np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                       err_msg=f"step {i}", **STEP_LOSS)
    assert int(state.step) == 10 == int(rs.step)
    assert int(state.opt.count) == 10


def test_remat_on_and_off_give_bitwise_gradients():
    _, cfg = _cfgs(remat="block")
    _, plain = _cfgs(remat="none")
    _, state = _states(*_cfgs())
    batch = lm_synth.batch_at(_data(cfg), 3)
    a, _ = ts._grads(state.params, cfg, batch)
    b, _ = ts._grads(state.params, plain, batch)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_runs_and_updates(arch):
    cfg = get_config(arch, smoke=True)
    state = ts.init_state(cfg, torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in state.params.parameters()]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    batch = {"tokens": tokens, "labels": tokens,
             "mask": np.ones((2, 32), np.float32)}
    if cfg.frontend is not None:       # as the reference test's _batch
        batch["embeds"] = np.random.default_rng(1).standard_normal(
            (2, cfg.n_prefix_embeds, transformer.STUB_FRONTEND_DIM))
    state, metrics = ts.make_train_step(cfg)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state.step) == 1
    assert any(not torch.equal(a, b) for a, b in
               zip(before, state.params.parameters()))


# ---------------------------------------------------------------------------
# the forward-only flash kernel, and serving stays grad-free
# ---------------------------------------------------------------------------

def test_gradient_through_flash_attention_is_refused():
    _, cfg = _cfgs("float32", attn_impl="flash")
    state = ts.init_state(cfg, torch.Generator().manual_seed(0))
    blk = state.params.blocks[0]
    x = torch.randn(1, 8, cfg.d_model)
    pos = torch.arange(8).expand(1, 8)
    with pytest.raises(NotImplementedError, match="no backward"):
        attention.full_attention(blk.attn, x, cfg, pos)
    with pytest.raises(NotImplementedError, match="attn_impl='einsum'"):
        ts.make_train_step(cfg)(state, lm_synth.batch_at(_data(cfg, 8), 0))
    with torch.no_grad():                           # prefill stays allowed
        out = attention.full_attention(blk.attn, x, cfg, pos)
    assert out.shape == x.shape and out.grad_fn is None
    frozen = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        attention.full_attention(frozen.blocks[0].attn, x, cfg, pos)


def test_serving_builds_no_autograd_graph():
    cfg = get_config("yi_6b", smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in params.parameters())
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)))
    logits, aux = transformer.forward(params, cfg, tokens)  # lm_prefill's call
    assert logits.grad_fn is None and not logits.requires_grad
    # a training state's weights (requires_grad on) served by the engine
    state = ts.init_state(cfg, torch.Generator().manual_seed(0))
    eng = Engine.create(cfg, state.params, batch=2, max_len=16, device="cpu")
    eng.prefill(tokens.numpy())
    assert all(c.grad_fn is None and not c.requires_grad
               for c in eng.cache.values())
    out, _ = transformer.decode_step(state.params, cfg, eng.cache,
                                     tokens[:, :1], 8)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# the loop and the entry point
# ---------------------------------------------------------------------------

def test_train_loss_decreases_and_tracks_reference(tmp_path, monkeypatch):
    rcfg, cfg = _cfgs("bfloat16")
    rs = jax.tree.map(np.asarray, ref_ts.init_state(jax.random.PRNGKey(0),
                                                    rcfg))
    monkeypatch.setattr(launch_train.ts, "init_state",
                        lambda c, g, compressed=False:
                        convert.train_state_from_numpy(c, rs, device="cpu"))
    _, report, _ = launch_train.train("yi-6b", smoke=True, steps=30, batch=4,
                                      seq=64, ckpt_dir=str(tmp_path / "p"),
                                      device="cpu")
    assert report.losses[-1] < report.losses[0]
    assert report.final_step == 30
    _, ref_report, _ = ref_train("yi-6b", smoke=True, steps=30, batch=4,
                                 seq=64, ckpt_dir=str(tmp_path / "r"))
    np.testing.assert_allclose(report.losses, ref_report.losses,
                               **BF16_TRAIN_LOSS)


def test_fault_tolerant_loop_recovers(tmp_path):
    """Crash mid-run; the loop must restore and reach an equivalent final
    state (same step count, finite losses)."""
    fired = {"done": False}

    def injector(step):
        if step == 17 and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("injected node failure")

    state, report, _ = launch_train.train(
        "yi-6b", smoke=True, steps=25, batch=4, seq=32,
        ckpt_dir=str(tmp_path), ckpt_every=5, fault_injector=injector,
        device="cpu")
    assert report.final_step == 25
    assert report.restarts == 1
    assert all(np.isfinite(l) for l in report.losses)
    assert int(state.step) == 25
    # a restart with no checkpoint yet starts again from a fresh state
    fired["done"] = False
    early = {"done": False}

    def injector_early(step):
        if step == 2 and not early["done"]:
            early["done"] = True
            raise RuntimeError("injected node failure")

    _, rep2, _ = launch_train.train(
        "yi-6b", smoke=True, steps=4, batch=4, seq=32,
        ckpt_dir=str(tmp_path / "early"), ckpt_every=5,
        fault_injector=injector_early, device="cpu")
    assert rep2.restarts == 1 and rep2.final_step == 4
    assert rep2.losses[:2] == rep2.losses[2:4]


def test_loop_without_a_factory_refuses_a_stale_restart(tmp_path):
    cfg = get_config("yi_6b", smoke=True)
    state = ts.init_state(cfg, torch.Generator().manual_seed(0))
    data = _data(cfg)

    def injector(step):
        if step == 1:
            raise RuntimeError("injected node failure")

    loop = FaultTolerantLoop(ts.make_train_step(cfg), state,
                             lambda s: lm_synth.batch_at(data, s),
                             Checkpointer(tmp_path), ckpt_every=5,
                             fault_injector=injector)
    with pytest.raises(RuntimeError, match="updated in place"):
        loop.run(3)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=20, threshold=3.0)
    for i in range(15):
        mon.record(i, 0.1)
    assert mon.record(15, 1.0)           # 10x median -> flagged
    assert not mon.record(16, 0.12)
    assert mon.flagged and mon.flagged[0][0] == 15


def _manifest(d):
    step = sorted(d.glob("step_*"))[-1]
    m = json.loads((step / "manifest.json").read_text())
    return [(e["path"], e["shape"], e["dtype"]) for e in m["leaves"]]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, mesh, writer):
    """Ten steps in one package, checkpointed by its loop; five more in
    each package from that checkpoint, both through their loops."""
    rcfg, cfg = _cfgs()
    data = _data(cfg, seq=32)
    rs0, _ = _states(rcfg, cfg)
    rs0_np = jax.tree.map(np.asarray, rs0)

    def fresh():
        return convert.train_state_from_numpy(cfg, rs0_np, device="cpu")

    def port_loop(d, steps):
        loop = FaultTolerantLoop(
            ts.make_train_step(cfg), fresh,
            lambda s: lm_synth.batch_at(data, s), Checkpointer(d, keep=2),
            ckpt_every=5)
        return loop.run(steps)

    with jax.set_mesh(mesh):
        rstep = _ref_step(rcfg, mesh)

        def ref_loop(d, steps):
            loop = RefLoop(rstep, rs0,
                           lambda s: ref_synth.batch_at(data, s),
                           RefCheckpointer(d, keep=2), ckpt_every=5)
            return loop.run(steps)

        first = tmp_path / "first"
        if writer == "reference":
            ref_loop(first, 10)
        else:
            port_loop(first, 10)
        shutil.copytree(first, tmp_path / "second")
        _, ref_rep = ref_loop(first, 15)
        port_state, port_rep = port_loop(tmp_path / "second", 15)
    assert len(ref_rep.losses) == len(port_rep.losses) == 5
    np.testing.assert_allclose(port_rep.losses, ref_rep.losses, **STEP_LOSS)
    assert int(port_state.step) == 15 == int(port_state.opt.count)
    # both packages wrote step 15 with the same key paths, shapes, dtypes
    assert _manifest(first) == _manifest(tmp_path / "second")
    assert ".params/['blocks']/['attn']/['wq']" in dict(
        (p, s) for p, s, _ in _manifest(first))


def test_bf16_train_state_round_trips_bitwise(tmp_path):
    rcfg, cfg = _cfgs("bfloat16")
    rs, state = _states(rcfg, cfg, compressed=True)
    RefCheckpointer(tmp_path / "r").save(0, rs, {"step": 0})
    Checkpointer(tmp_path / "p").save(0, state, {"step": 0})
    assert _manifest(tmp_path / "r") == _manifest(tmp_path / "p")
    back, _ = Checkpointer(tmp_path / "r").restore(state, device="cpu")
    assert back.params.embed.dtype == torch.bfloat16
    for a, b in zip(opt.tree_leaves(back.params),
                    opt.tree_leaves(state.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.requires_grad
    for tree in ("master", "m", "v"):
        for a, b in zip(opt.tree_leaves(getattr(back.opt, tree)),
                        opt.tree_leaves(getattr(state.opt, tree))):
            assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in
               zip(opt.tree_leaves(back.ef), opt.tree_leaves(state.ef)))
    rback, _ = RefCheckpointer(tmp_path / "p").restore(rs)
    for a, b in zip(jax.tree.leaves(rback), jax.tree.leaves(rs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
