"""The port stands alone: no JAX, no reference package, no hidden fallback.

* importing the port's modules, its benchmarks, examples and
  ``chip_smoke.py`` pulls in neither ``jax`` nor ``repro``;
* with no GPU, the entry points that default to the GPU raise instead of
  running on the CPU;
* a CPU tensor never reaches the CUDA kernel loader: the CPU path of every
  entry point runs the plain versions;
* a CUDA tensor never reaches a plain version: with no card to launch on,
  the kernel path raises.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import get_config
from repro_torch import tcam
from repro_torch.core import am, hdc
from repro_torch.dist import LocalMesh
from repro_torch.index import ivf
from repro_torch.kernels import _build
from repro_torch.kernels.cam_search import kernel, ops
from repro_torch.kernels.hdc_encode import kernel as enc_kernel
from repro_torch.kernels.hdc_encode import ops as enc_ops
from repro_torch.kernels.hdc_encode import ref as enc_ref
from repro_torch.kernels.mibo_mc import kernel as mc_kernel
from repro_torch.kernels.mibo_mc import ops as mc_ops
from repro_torch.kernels.flash_attention import kernel as fl_kernel
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.kernels.flash_attention import ref as fl_ref
from repro_torch.kernels.mibo_mc import ref as mc_ref
from repro_torch import convert
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.serve import AMService
from repro_torch.serve.engine import Engine

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from torch_benchmarks import bench_am_topk  # noqa: E402

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.am, repro_torch.serve\n"
        "import repro_torch.convert, repro_torch.kernels.cam_search\n"
        "import repro_torch.core.hdc, repro_torch.core.fefet\n"
        "import repro_torch.core.mibo, repro_torch.core.cam_array\n"
        "import repro_torch.core.energy, repro_torch.core.baselines\n"
        "import repro_torch.data.hdc_data, repro_torch.kernels.hdc_encode\n"
        "import repro_torch.kernels.mibo_mc\n"
        "import repro_torch.kernels.flash_attention, repro_torch.convert\n"
        "import repro_torch.configs.registry, repro_torch.models.layers\n"
        "import repro_torch.models.attention, repro_torch.models.transformer\n"
        "import repro_torch.models.moe, repro_torch.models.mla\n"
        "import repro_torch.models.rglru, repro_torch.models.xlstm\n"
        "import repro_torch.serve.engine, repro_torch.serve.scheduler\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.tcam, repro_torch.tcam.masks\n"
        "import repro_torch.tcam.routing, repro_torch.index\n"
        "import repro_torch.index.ivf, repro_torch.index.partition\n"
        "import repro_torch.dist, repro_torch.dist.mesh\n"
        "import repro_torch.dist.specs, repro_torch.launch.mesh\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.checkpointer\n"
        "import repro_torch.checkpoint.elastic, repro_torch.serve.snapshot\n"
        "import repro_torch.train.optimizer, repro_torch.train.train_step\n"
        "import repro_torch.data.lm_synth, repro_torch.dist.pipeline\n"
        "import repro_torch.checkpoint.fault_tolerance\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.roofline, repro_torch.roofline.model\n"
        "import repro_torch.roofline.report, repro_torch.launch.dryrun\n"
        "sys.path.insert(0, ROOT)\n"
        "import torch_benchmarks.run, torch_benchmarks.common, chip_smoke\n"
        "import torch_benchmarks.bench_am_serve\n"
        "import torch_benchmarks.bench_am_topk\n"
        "chip_smoke._kernel_modules()\n"
        "import runpy\n"
        "for ex in ('quickstart', 'hdc_classification', 'lpm_routing',\n"
        "           'serve_am_cache', 'train_lm'):\n"
        "    runpy.run_path(ROOT + f'/torch_examples/{ex}.py', run_name='x')\n"
        "import io, json, tempfile\n"
        "h = runpy.run_path(ROOT + '/tests/harness/torch_replica_harness.py',"
        " run_name='x')\n"
        "ops = [{'op': 'create', 'table': 't', 'capacity': 8},\n"
        "       {'op': 'append', 'table': 't', 'seq': 0, 'code': [1] * 16,\n"
        "        'value': 'v'}, {'op': 'sync'}, {'op': 'quit'}]\n"
        "sys.stdin = io.StringIO(''.join(json.dumps(o) + '\\n' "
        "for o in ops))\n"
        "h['run_replica'](tempfile.mkdtemp(), 2, False, 'cpu')\n"
        "from repro_torch.configs.registry import ARCH_IDS, get_config\n"
        "[get_config(a) for a in ARCH_IDS]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c",
                          f"ROOT = {os.path.dirname(SRC)!r}\n" + code],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_no_gpu_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = np.zeros((4, 8), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AMService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AMService(mesh=LocalMesh((8,), ("model",)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        am.make_table(codes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        am.serving_meta(4, 0.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hdc.make_model(hdc.HDCConfig(n_features=3, n_classes=2, dim=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enc_ops.encode_quantize(np.zeros((2, 3)), np.zeros((3, 8)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mc_ops.monte_carlo_ml_currents(np.zeros(4, np.int32),
                                       np.zeros(4, np.int32))
    cfg = get_config("yi_6b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(cfg, 1, 8)
    cpu_model = transformer.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine.create(cfg, cpu_model, batch=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.train("yi-6b", True, 2, 2, 8, "unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.train_state_from_numpy(cfg, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_am_topk.main(["--smoke"])
    # asking for the CPU explicitly works
    assert am.make_table(codes, device="cpu").device.type == "cpu"


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel loader reached for {name!r}")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    kernel.reset_launches()
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 8, (50, 12)).astype(np.int32)
    q = torch.from_numpy(codes[:4])
    t = torch.from_numpy(codes)
    ops.mismatch_counts(q, t, 3)
    ops.topk_fused(q, t, k=3, bits=3, valid_rows=40, count_le=2.0)
    table = am.make_table(codes, bits=3, distance="l1", device="cpu")
    am.search(table, codes[:4], k=3, backend="cuda")
    am.search(table, codes[:4], k=300, backend="pallas")
    am.search(table, codes[:4], matches=2, backend="cuda")
    svc = AMService(device="cpu")
    svc.create_table("t", width=12, capacity=64, backend="cuda",
                     ternary=True)
    svc.append("t", codes)
    assert svc.lookup("t", codes[5], k=2).best_row == 5
    index = ivf.build(table, sets=4, method="hyperplane")
    ivf.search(index, codes[:4], k=3, probes=2, backend="cuda")
    ivf.search(index, codes[:4], k=300, probes=4, backend="cuda")
    mesh = LocalMesh((8,), ("model",))
    for merge in ("allgather", "tree", "ring"):
        am.search_sharded(table, codes[:4], mesh=mesh, k=3, backend="cuda",
                          merge=merge)
        am.search_sharded(table, codes[:4], mesh=mesh, matches=2,
                          backend="cuda", merge=merge)
        ivf.search_sharded(index, codes[:4], mesh=mesh, k=3, probes=2,
                           backend="cuda", merge=merge)
    am.search_sharded(table, codes[:4], mesh=mesh, k=300, backend="cuda")
    sharded = AMService(mesh=mesh, device="cpu")
    sharded.create_table("t", width=12, capacity=64, backend="cuda")
    sharded.append("t", codes)
    assert sharded.lookup("t", codes[5], k=2).best_row == 5
    rt = tcam.build_routing_table([(0, 0, 1), (0xAB, 8, 2)], width=8,
                                  bits=2, device="cpu")
    tcam.lookup(rt, [0xABCD, 7], matches=2, backend="cuda")
    enc_ops.encode_quantize(torch.ones((3, 5)), torch.ones((5, 7)), 2)
    mc_ops.monte_carlo_ml_currents(torch.zeros(6, dtype=torch.int32),
                                   torch.ones(6, dtype=torch.int32),
                                   n_samples=10)
    fl_kernel.reset_launches()
    qkv = torch.ones((1, 8, 2, 8))
    fl_ops.flash_attention_bshd(qkv, qkv[:, :, :1], qkv[:, :, :1])
    cfg = get_config("yi_6b", smoke=True)
    flash = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, attn_impl="flash"))
    model = transformer.init_params(flash, torch.Generator())
    with torch.no_grad():
        transformer.forward(model, flash, torch.zeros((1, 8),
                                                      dtype=torch.int64))
    launch_serve.main(["--device", "cpu", "--requests", "2", "--max-new",
                       "2"])
    for arch in ("deepseek-v2-lite-16b", "recurrentgemma-2b", "xlstm-125m"):
        launch_serve.main(["--device", "cpu", "--arch", arch, "--requests",
                           "2", "--max-new", "2"])
    vlm = get_config("pixtral_12b", smoke=True)
    vlm = dataclasses.replace(vlm, parallel=dataclasses.replace(
        vlm.parallel, attn_impl="flash"))
    with torch.no_grad():
        transformer.forward(
            transformer.init_params(vlm, torch.Generator()), vlm,
            torch.zeros((1, 8), dtype=torch.int64),
            torch.zeros((1, vlm.n_prefix_embeds,
                         transformer.STUB_FRONTEND_DIM)))
    assert kernel.launches == {"cam_search": 0, "cam_search_topk": 0,
                               "cam_search_topk_few": 0, "cam_pack": 0,
                               "cam_pack_l1": 0}
    assert enc_kernel.launches == {"hdc_encode": 0}
    assert mc_kernel.launches == {"mibo_mc": 0}
    assert fl_kernel.launches == {"flash_attention": 0}
    # and a CPU tensor handed to a kernel wrapper is refused, not loaded
    with pytest.raises(ValueError, match="CUDA"):
        kernel.cam_search(q.to(torch.int8), t.to(torch.int8), levels=8)


def test_mixed_devices_are_refused():
    q = torch.zeros((1, 4), dtype=torch.int32)
    t = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="queries on"):
        ops.mismatch_counts(q, t)


class _FellBack(Exception):
    pass


def test_cuda_tensors_never_fall_back_to_plain(monkeypatch):
    """A CUDA tensor (a fake one: there is no card here) reaching
    ``hdc_encode.ops``, ``mibo_mc.ops``, ``flash_attention.ops`` or the
    IVF coarse pass goes to the kernel, which cannot launch, and the call
    raises; the plain version is never run."""
    def fell_back(*args, **kwargs):
        raise _FellBack("plain version run for a CUDA tensor")

    def no_card(name):
        raise RuntimeError(f"no card to build {name!r} for")

    monkeypatch.setattr(enc_ref, "encode_quantize", fell_back)
    monkeypatch.setattr(mc_ref, "ml_currents", fell_back)
    monkeypatch.setattr(fl_ref, "attention", fell_back)
    monkeypatch.setattr(am, "_ref_backend", fell_back)
    monkeypatch.setattr(_build, "load", no_card)
    enc_kernel.reset_launches()
    mc_kernel.reset_launches()
    fl_kernel.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty((3, 5), device="cuda")
        proj = torch.empty((5, 7), device="cuda")
        noise = torch.zeros((10, 6), device="cuda")
        code = torch.zeros(6, dtype=torch.int32, device="cuda")
        q = torch.empty((1, 8, 2, 8), device="cuda")
        kv = torch.empty((1, 8, 1, 8), device="cuda")
        words = torch.zeros((3, 16), dtype=torch.int32, device="cuda")
        index = ivf.IVFIndex(
            centroids=words, slabs=torch.zeros((3, 2, 16), dtype=torch.int32,
                                               device="cuda"),
            row_ids=torch.zeros((3, 2), dtype=torch.int32, device="cuda"),
            set_sizes=torch.ones(3, dtype=torch.int32, device="cuda"),
            set_radius=torch.zeros(3, device="cuda"))
        for call in (lambda: enc_ops.encode_quantize(x, proj, 2),
                     lambda: mc_ops.ml_currents_with_noise(code, code, noise,
                                                           noise),
                     lambda: fl_ops.flash_attention_bshd(q, kv, kv),
                     lambda: ivf._coarse(index, words, 2)):
            with pytest.raises(Exception) as err:
                call()
            assert not isinstance(err.value, _FellBack), err.value
    assert enc_kernel.launches == {"hdc_encode": 0}
    assert mc_kernel.launches == {"mibo_mc": 0}
    assert fl_kernel.launches == {"flash_attention": 0}
