"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

Small sizes throughout: smoke configs, short sequences, meshes of 2-4
ranks.  What is held:

* the record's schema, the reference's keys (``nvlink_bytes`` /
  ``net_bytes`` in place of ``ici_bytes`` / ``dcn_bytes``) and its skip
  reason; the command line refuses the flags that select what the port
  does not have;
* ``grad_compress``, ``flash_model`` and ``attn_bf16_scores`` change what
  is counted;
* a split the port makes that does not divide fails the cell, naming the
  leaf;
* the trip count: the sLSTM's and mLSTM's loops counted as one step times
  ``n`` give the full loop's FLOPs and bytes exactly in a forward; with a
  backward, FLOPs exactly and bytes within one step's share (the steps at
  the loop's two ends differentiate fewer inputs than the steady state's);
* MoE FLOPs at the static capacity of the EP path against
  ``roofline.model.active_params``, and the dense oracle's where the port
  runs it (a train step);
* ``ShardedTrainStep``'s collective bytes against the reduce-scatter +
  all-gather arithmetic, and the NVLink / network split by host;
* the FLOP count against ``FlopCounterMode`` itself and against the
  reference's ``repro.roofline.hlo_parse.program_costs`` on the compiled
  HLO of ``repro.models.transformer.forward`` on one device: equal (0
  tolerance) for the dense smoke configs and xlstm.  ``repro.launch.dryrun`` is never
  imported: it sets ``XLA_FLAGS`` to 512 devices at import.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import get_config as ref_config
from repro.dist.specs import make_rules as ref_make_rules
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as ref_tf
from repro.roofline import hlo_parse
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_config
from repro_torch.dist.specs import make_rules
from repro_torch.launch import dryrun
from repro_torch.models import layers, moe, transformer, xlstm
from repro_torch.roofline import model as roof
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

TRAIN = ShapeCfg("train_4k", 64, 4, "train")
PREFILL = ShapeCfg("prefill_32k", 128, 4, "prefill")
DECODE = ShapeCfg("decode_32k", 128, 4, "decode")
MESH = ((2, 2), ("data", "model"))


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("shape", [TRAIN, PREFILL, DECODE],
                         ids=lambda s: s.kind)
def test_record_schema(results, shape):
    cfg = get_config("yi_6b", smoke=True)
    rec = dryrun.run_cell("yi_6b", shape, False, cfg=cfg, mesh=MESH)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["reason"] is None
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (
        cfg.name, shape.name, "mesh2x2")
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "total_bytes"}
    mem = rec["memory"]
    assert mem["total_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert min(mem.values()) > 0
    assert set(rec["collectives"]) == {"by_kind_bytes", "counts",
                                       "nvlink_bytes", "net_bytes"}
    rf = roof.Roofline(1, 1, 0, 0, 1, 1).to_dict()
    assert set(rec["roofline"]) == set(rf)
    assert rec["roofline"]["n_chips"] == 4
    assert rec["roofline"]["model_flops_global"] == roof.model_flops(
        cfg, shape, shape.kind)
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["per_rank"]["batch_rows"] == 2          # 4 rows over data 2
    on_disk = json.loads((results / f"{cfg.name}_{shape.name}_mesh2x2.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    # a second call reads the record back
    assert dryrun.run_cell("yi_6b", shape, False, cfg=cfg,
                           mesh=MESH) == on_disk
    # the train step's gradient sum and weight gather ran over data
    if shape.kind == "train":
        assert set(rec["collectives"]["counts"]) == {"all-to-all",
                                                     "all-gather"}


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("xlstm-125m", "long_500k", True),
    ("deepseek-v2-lite-16b", "decode_32k", True),
    ("granite-moe-1b-a400m", "decode_32k", False)])
def test_production_cells(results, arch, shape, multi_pod):
    """A sample of the production cells at full size, as ``--all`` counts
    them: ok, on the mesh's 256 or 512 ranks, every named split the port
    makes dividing; the MoE decodes take EP over ``model``."""
    rec = dryrun.run_cell(arch, shape, multi_pod)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
    assert rec["roofline"]["n_chips"] == (512 if multi_pod else 256)
    assert rec["roofline"]["t_bound_s"] > 0
    if rec["moe"] is not None:
        assert rec["moe"]["ep"] == 16
        assert rec["moe"]["count"].startswith("static capacity")


def test_skip_reason_and_refused_flags(results):
    rec = dryrun.run_cell("yi_6b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == ("full quadratic attention at 524k tokens "
                             "(assignment skip rule; see DESIGN.md §4)")
    assert (results / "yi-6b_long_500k_pod16x16.json").exists()
    for flag in (["--kv-replicate", "2"], ["--no-seq-shard"],
                 ["--moe-zero1"]):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "yi-6b", "--shape", "long_500k", *flag])


def test_options_change_what_is_counted():
    """``grad_compress`` on a pod mesh runs the compressed step (the int8
    codes summed over ``pod``, the state whole); ``flash_model`` drops the
    score tensors' bytes and keeps the FLOPs; ``attn_bf16_scores``, which
    the port reads, changes the bytes (in eager PyTorch it adds a bf16
    copy of the scores to the float32 ones)."""
    cfg = get_config("yi_6b", smoke=True)
    mesh = ((2, 2, 1), ("pod", "data", "model"))
    comp = dryrun.count_cell(cfg, TRAIN, *mesh, grad_compress=True)
    base = dryrun.count_cell(cfg, TRAIN, *mesh)
    assert comp["per_rank"]["program"] == "make_train_step_compressed"
    assert base["per_rank"]["program"] == "ShardedTrainStep"
    assert set(comp["collectives"]["counts"]) == {"all-gather", "all-reduce"}
    parts = comp["per_rank"]["argument_parts"]
    n = sum(p.numel() for p in transformer.LM(cfg, device="meta")
            .parameters())
    assert parts["optimizer_state"] == 12 * n
    assert parts["error_feedback"] == 4 * n
    shape = ShapeCfg("prefill_32k", 1024, 2, "prefill")
    one = ((1, 1), ("data", "model"))
    eins = dryrun.count_cell(cfg, shape, *one)["roofline"]
    flash = dryrun.count_cell(cfg, shape, *one, flash_model=True)["roofline"]
    lp_cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, attn_bf16_scores=True))
    lp = dryrun.count_cell(lp_cfg, shape, *one)["roofline"]
    assert flash["flops_per_device"] == eins["flops_per_device"] \
        == lp["flops_per_device"]
    assert flash["hbm_bytes_per_device"] < eins["hbm_bytes_per_device"] \
        < lp["hbm_bytes_per_device"]


def test_non_dividing_split_names_the_leaf(results):
    """d_model 64 over a data axis of 3: the optimizer state's fsdp split
    does not divide, and the first such leaf is named."""
    cfg = get_config("yi_6b", smoke=True)
    with pytest.raises(dryrun.ShardingError, match=r"opt\.embed: dim 1 "
                       r"\(64\) over \('data',\) \(width 3\) does not "
                       r"divide"):
        dryrun.count_cell(cfg, TRAIN, (3, 1), ("data", "model"))
    rec = dryrun.run_cell("yi_6b", TRAIN, False, cfg=cfg,
                          mesh=((3, 1), ("data", "model")))
    assert rec["status"] == "error" and "opt.embed" in rec["reason"]
    assert "ShardingError" in rec["traceback"]


def test_tp_split_not_made_by_the_port_is_listed():
    """yi's smoke cache holds 2 KV heads, which a model axis of 4 does not
    divide; the port does not split over model, so the cell runs and
    lists the leaf."""
    cfg = get_config("yi_6b", smoke=True)
    out = dryrun.count_cell(cfg, DECODE, (1, 4), ("data", "model"))
    bad = out["per_rank"]["tp_not_dividing"]
    assert bad and all(b.startswith("cache.") and "'model'" in b
                       for b in bad)


def _counted(fn, hook: bool, grad: bool):
    c = dryrun.CostCounter()
    tok = layers.SCAN_COUNTER.set(c.scan if hook else None)
    try:
        with c:
            y = fn()
            if grad:
                y.backward(torch.empty_like(y))
    finally:
        layers.SCAN_COUNTER.reset(tok)
    return c


@pytest.mark.parametrize("block", ["slstm", "mlstm"])
def test_trip_count_equals_the_full_loop(block):
    cfg = get_config("xlstm_125m", smoke=True)
    cls, fn, s = ((xlstm.SLSTM, xlstm.slstm_block, 16) if block == "slstm"
                  else (xlstm.MLSTM, xlstm.mlstm_block, 4 * xlstm.CHUNK))
    n = s if block == "slstm" else s // xlstm.CHUNK
    for grad in (False, True):
        p = cls(cfg, device="meta").requires_grad_(grad)
        x = torch.empty((2, s, cfg.d_model), dtype=torch.bfloat16,
                        device="meta", requires_grad=grad)
        full = _counted(lambda: fn(p, x, cfg), False, grad)
        trip = _counted(lambda: fn(p, x, cfg), True, grad)
        assert trip.trips == {n: 1} and not full.trips
        assert trip.flops == full.flops
        if grad:
            assert abs(trip.bytes - full.bytes) <= full.bytes / (n - 1)
        else:
            assert trip.bytes == full.bytes


def _moe_layer_active(cfg) -> int:
    """Per-layer parameters a token touches in the MoE block (router,
    top_k routed and the shared experts), by ``active_params``."""
    dense = dataclasses.replace(cfg, moe=None, d_ff=0)
    return (roof.active_params(cfg) - roof.active_params(dense)) \
        // cfg.n_layers


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b",
                                  "granite_moe_1b_a400m"])
def test_moe_static_capacity_flops_are_active_params(arch):
    cfg = get_config(arch, smoke=True)
    m = cfg.moe
    t = 4 * m.n_experts                   # top_k slots spread evenly
    p = moe.MoE(cfg, device="meta")
    x = torch.empty((1, t, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    c = dryrun.CostCounter()
    with torch.no_grad(), c:
        dryrun.moe_static(p, x, cfg)
    assert c.flops == 2 * t * _moe_layer_active(cfg)
    # the whole prefill forward: every layer's block, and in the record
    out = dryrun.count_cell(cfg, ShapeCfg("prefill_32k", 64, 2, "prefill"),
                            (1, 1), ("data", "model"))
    assert out["moe"]["top_k"] == m.top_k and out["moe"]["ep"] == 1
    assert out["moe"]["count"].startswith("static capacity")


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b",
                                  "granite_moe_1b_a400m"])
def test_moe_without_a_mesh_counts_the_dense_oracle(arch):
    """A layer given no mesh (a train step's slices) runs the dense oracle
    on meta and counts what it runs, every token through every expert;
    a train cell's record says so."""
    cfg = get_config(arch, smoke=True)
    m = cfg.moe
    t = 4 * m.n_experts
    p = moe.MoE(cfg, device="meta")
    x = torch.empty((1, t, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    c = dryrun.CostCounter()
    with torch.no_grad(), dryrun.counting(c):
        moe.moe_block(p, x, cfg)
    fc = FlopCounterMode(display=False)
    with torch.no_grad(), fc:
        moe.moe_dense(p, x, cfg)
    assert c.flops == fc.get_total_flops() and c.moe_ep_layers == 0
    routed = 2 * t * m.n_experts * 3 * cfg.d_model * m.d_ff_expert
    assert c.flops >= routed
    out = dryrun.count_cell(cfg, TRAIN, (2, 1), ("data", "model"))
    assert out["per_rank"]["program"] == "ShardedTrainStep"
    assert out["moe"]["count"].startswith("dense oracle")
    assert out["moe"]["experts_per_bank"] == m.n_experts


def test_moe_under_ep_sends_the_ports_buffers():
    """Prefill on a model axis of 2: each bank owns half the sequence, its
    routed products are half the slots, and four all-to-alls of the
    port's (1, ep, capacity, ...) send buffers go out and back."""
    cfg = get_config("deepseek_v2_lite_16b", smoke=True)
    m = cfg.moe
    p = moe.MoE(cfg, device="meta")
    t = 4 * m.n_experts
    x = torch.empty((1, t, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    c = dryrun.CostCounter()
    mesh = dryrun.RecordingMesh((2,), ("model",), c)
    with torch.no_grad(), c:
        dryrun.moe_static(p, x, cfg, mesh)
    router = 2 * t * cfg.d_model * m.n_experts
    routed = 2 * (t // 2) * m.top_k * 3 * cfg.d_model * m.d_ff_expert
    shared = 2 * t * m.n_shared * 3 * cfg.d_model * m.d_ff_expert
    assert c.flops == router + routed + shared
    kinds = [call["kind"] for call in mesh.calls]
    assert kinds == ["all-to-all"] * 4 + ["all-gather", "all-reduce"]
    cap = moe.capacity(t // 2, cfg, 2)
    x_buf = 2 * cap * cfg.d_model * 2                   # bf16 (1, 2, cap, d)
    assert mesh.calls[0]["bytes"] == x_buf / 2


def test_sharded_step_collective_bytes():
    """One rank of ``("data", "model")`` = (2, 1): each gradient leaf is
    reduce-scattered (an all-to-all of its padded chunks) and all-gathered,
    the metrics likewise, and each fsdp-split weight is gathered from its
    float32 master's slices in its own dtype."""
    cfg = get_config("yi_6b", smoke=True)
    g = 2
    out = dryrun.count_cell(cfg, TRAIN, (g, 1), ("data", "model"))
    lm = transformer.LM(cfg, device="meta")
    mesh = dryrun.RecordingMesh((g, 1), ("data", "model"))
    rules = make_rules(mesh, cfg.parallel.layout, batch_size=4)
    specs = opt.leaf_specs(lm, ts.state_specs(cfg, rules).opt.master)

    def padded(numel):
        return -(-numel // g) * g

    grads = sum(padded(p.numel()) * p.element_size()
                for p in lm.parameters()) + padded(3) * 4
    rs = (g - 1) / g * grads                 # reduce-scatter: (g-1) x chunk
    ag = (g - 1) / g * grads                 # the summed chunks gathered
    gathered = 0
    for p, spec in zip(lm.parameters(), specs):
        d = opt.axis_dim(spec, "data")
        if d is not None:
            held = dryrun.held_numel(p.shape, spec, mesh, ("data",))
            gathered += (g - 1) / g * g * held * p.element_size()
    coll = out["collectives"]
    assert coll["by_kind_bytes"]["all-to-all"] == pytest.approx(rs, rel=1e-12)
    assert coll["by_kind_bytes"]["all-gather"] == pytest.approx(
        ag + gathered, rel=1e-12)
    assert coll["counts"]["all-to-all"] == len(specs) + 1
    # two ranks of one host: NVLink; a model group of 16 spans two hosts
    assert coll["net_bytes"] == 0
    assert coll["nvlink_bytes"] == pytest.approx(rs + ag + gathered)
    big = dryrun.RecordingMesh((16, 16), ("data", "model"))
    assert big.members("model") == list(range(16))
    assert big.members("data") == list(range(0, 256, 16))
    big._record("all-reduce", "model", 1024, 1024)
    big._record("all-reduce", "data", 1024, 1024)
    small = dryrun.RecordingMesh((2, 16, 8), ("pod", "data", "model"))
    small._record("all-gather", "model", 1024, 128)
    assert [c["nvlink"] for c in big.calls + small.calls] == [False, False,
                                                             True]
    assert small.calls[0]["bytes"] == 7 / 8 * 1024


def test_held_numel_is_the_largest_slice():
    mesh = dryrun.RecordingMesh((3, 2), ("data", "model"))
    assert dryrun.held_numel((10, 7), ("data", None), mesh, ("data",)) == 28
    assert dryrun.held_numel((10, 7), ("data", "model"), mesh,
                             ("data",)) == 28
    assert dryrun.held_numel((10, 7), (("data", "model"), None), mesh,
                             ("data", "model")) == 14
    assert dryrun.held_numel((10, 7), ("model", None), mesh, ()) == 70


@pytest.mark.parametrize("arch", ["yi_6b", "granite_20b",
                                  "recurrentgemma_2b", "xlstm_125m"])
def test_flops_equal_reference_program_costs(arch):
    """The prefill forward's FLOPs against the reference's: its forward
    jitted on one CPU device, compiled, and read by ``program_costs``
    (every dot, 2 x result x contraction), and against
    ``FlopCounterMode`` on the same meta forward.  Tolerance: none.

    xlstm runs two mLSTM chunks (S = 128).  At one chunk (S = 64) the
    reference reads 2.8 % lower: XLA drops the loop of one trip and with
    it the final (c, n) state update, which nothing reads, while eager
    PyTorch computes it (the chunk's two state products, 1,622,016 FLOPs
    at the smoke size).  From two chunks on, the loop's body keeps that
    update and the counts are equal."""
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    b, s = 2, (2 * xlstm.CHUNK if arch == "xlstm_125m" else 64)
    mesh = make_test_mesh()
    rules = ref_make_rules(mesh, rcfg.parallel.layout)
    params = jax.eval_shape(lambda: ref_tf.init_params(jax.random.PRNGKey(0),
                                                       rcfg))
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    with jax.set_mesh(mesh):
        hlo = jax.jit(lambda p, t: ref_tf.forward(
            p, rcfg, t, rules, 1, None, mesh)).lower(
                params, tok).compile().as_text()
    want = hlo_parse.program_costs(hlo)["flops"]
    lm = transformer.LM(cfg, device="meta")
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    c = dryrun.CostCounter()
    with torch.no_grad(), dryrun.counting(c):
        transformer.forward(lm, cfg, tokens)
    fc = FlopCounterMode(display=False)
    with torch.no_grad(), fc:
        transformer.forward(lm, cfg, tokens)
    assert c.flops == want == fc.get_total_flops()
