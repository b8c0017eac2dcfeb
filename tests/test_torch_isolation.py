"""The port stands alone: no JAX, no reference package, no hidden fallback.

* importing the port's modules pulls in neither ``jax`` nor ``repro``;
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
from repro_torch.core import am, hdc
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
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer
from repro_torch.serve import AMService
from repro_torch.serve.engine import Engine

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
        "import repro_torch.serve.engine, repro_torch.serve.scheduler\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.configs.registry import ARCH_IDS, get_config\n"
        "[get_config(a) for a in ARCH_IDS]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_no_gpu_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = np.zeros((4, 8), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AMService()
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
    transformer.forward(model, flash, torch.zeros((1, 8), dtype=torch.int64))
    launch_serve.main(["--device", "cpu", "--requests", "2", "--max-new",
                       "2"])
    assert kernel.launches == {"cam_search": 0, "cam_search_topk": 0,
                               "cam_pack": 0}
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
    ``hdc_encode.ops``, ``mibo_mc.ops`` or ``flash_attention.ops`` goes to
    the kernel, which cannot launch, and the call raises; the plain version
    is never run."""
    def fell_back(*args, **kwargs):
        raise _FellBack("plain version run for a CUDA tensor")

    def no_card(name):
        raise RuntimeError(f"no card to build {name!r} for")

    monkeypatch.setattr(enc_ref, "encode_quantize", fell_back)
    monkeypatch.setattr(mc_ref, "ml_currents", fell_back)
    monkeypatch.setattr(fl_ref, "attention", fell_back)
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
        for call in (lambda: enc_ops.encode_quantize(x, proj, 2),
                     lambda: mc_ops.ml_currents_with_noise(code, code, noise,
                                                           noise),
                     lambda: fl_ops.flash_attention_bshd(q, kv, kv)):
            with pytest.raises(Exception) as err:
                call()
            assert not isinstance(err.value, _FellBack), err.value
    assert enc_kernel.launches == {"hdc_encode": 0}
    assert mc_kernel.launches == {"mibo_mc": 0}
    assert fl_kernel.launches == {"flash_attention": 0}
