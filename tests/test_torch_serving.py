"""The port's serving engine, scheduler and serving driver, on the CPU.

Mirrors ``tests/test_serving.py``, ``test_runtime.py::
test_serve_engine_greedy_matches_forward`` and ``test_launch_serve.py`` on
the port, and holds the port's engine and batcher against the reference's
on the same weights (carried by ``convert.lm_params_from_numpy``).  Greedy
tokens are compared under a float32 copy of the smoke config, where a
near-tie between the frameworks' bf16 roundings cannot flip them; logits at
atol 1e-4, rtol 1e-5 (about 1e-5 seen: summation order only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as ref_tf
from repro.serve.engine import Engine as RefEngine
from repro.serve.scheduler import ContinuousBatcher as RefBatcher
from repro.serve.scheduler import Request as RefRequest
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import ContinuousBatcher, Request

torch.set_num_threads(2)

F32 = dict(atol=1e-4, rtol=1e-5)


def _setup(batch=3, max_len=48, seed=0):
    cfg = get_config("yi_6b", smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(seed))
    eng = Engine.create(cfg, params, batch=batch, max_len=max_len,
                        device="cpu")
    return cfg, params, eng


def _prompts(cfg, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


@pytest.fixture(scope="module")
def f32_pair():
    """(ref cfg, ref params, port cfg, port params, mesh): the smoke config
    in float32, the reference's weights carried across."""
    rcfg = dataclasses.replace(ref_config("yi_6b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("yi_6b", smoke=True),
                              dtype="float32")
    params = ref_tf.init_params(jax.random.PRNGKey(0), rcfg)
    model = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return rcfg, params, cfg, model, make_test_mesh()


# ---------------------------------------------------------------------------
# mirrors of tests/test_serving.py and test_runtime.py on the port
# ---------------------------------------------------------------------------

def test_engine_inactive_slots_do_not_advance():
    _, _, eng = _setup()
    toks = np.array([5, 7, 9], np.int32)
    eng.step_logits(toks, active=np.array([True, False, True]))
    np.testing.assert_array_equal(eng.pos, [1, 0, 1])
    # and the inactive slot's cache rows stay zero
    assert not eng.cache["k"][:, 1].any() and eng.cache["k"][:, 0, 0].any()


def _greedy(cfg, params, prompt, n):
    """Uniform-batch greedy generation as the oracle."""
    eng = Engine.create(cfg, params, batch=1, max_len=48, device="cpu")
    return [int(t) for t in eng.generate(prompt[None], num_tokens=n)[0]]


def test_continuous_batcher_matches_uniform_greedy():
    """Requests admitted at different times generate exactly what a
    dedicated single-request engine generates (per-slot isolation)."""
    cfg, params, eng = _setup(batch=2)
    p1, p2, p3 = _prompts(cfg, (4, 6, 3))
    batcher = ContinuousBatcher(eng)
    for rid, (p, n) in enumerate([(p1, 5), (p2, 4), (p3, 5)]):
        batcher.submit(Request(rid=rid, prompt=p, max_new_tokens=n))
    done = batcher.run()
    assert len(done) == 3
    got = {r.rid: r.generated for r in done}
    assert got[0] == _greedy(cfg, params, p1, 5)
    assert got[1] == _greedy(cfg, params, p2, 4)
    assert got[2] == _greedy(cfg, params, p3, 5)
    # request 3 reused a slot freed mid-run
    assert batcher.ticks < (4 + 5) + (6 + 4) + (3 + 5)


def test_generate_shapes_and_determinism():
    cfg, params, eng = _setup(batch=2)
    prompts = np.stack(_prompts(cfg, (4, 4), seed=1))
    out = eng.generate(prompts, num_tokens=6)
    assert out.shape == (2, 6) and out.dtype == torch.int32
    eng2 = Engine.create(cfg, params, batch=2, max_len=48, device="cpu")
    assert torch.equal(out, eng2.generate(prompts, num_tokens=6))


def test_serve_engine_greedy_matches_forward():
    """Decode path == forward path: the engine's greedy next token is the
    argmax of the forward logits at the last position."""
    cfg, params, eng = _setup(batch=2, max_len=32, seed=1)
    prompts = np.stack(_prompts(cfg, (6, 6), seed=2))
    logits, _ = transformer.forward(params, cfg, torch.from_numpy(prompts))
    want = logits[:, -1, :cfg.vocab_size].float().argmax(-1)
    got = eng.prefill(prompts).argmax(-1)
    assert torch.equal(got, want)


def test_temperature_sampling_follows_the_generator():
    cfg, params, eng = _setup(batch=2)
    tok = torch.tensor([[3], [4]], dtype=torch.int32)
    a = eng.step(tok, temperature=0.8,
                 generator=torch.Generator().manual_seed(5))
    eng2 = Engine.create(cfg, params, batch=2, max_len=48, device="cpu")
    b = eng2.step(tok, temperature=0.8,
                  generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_engine_refuses_params_on_another_device():
    cfg, params, _ = _setup()
    with pytest.raises(ValueError, match="params are on"):
        Engine.create(cfg, params, batch=1, max_len=8, device="meta")


# ---------------------------------------------------------------------------
# the port's engine and batcher against the reference's (float32 config)
# ---------------------------------------------------------------------------

def test_step_logits_match_reference_engine(f32_pair):
    rcfg, params, cfg, model, mesh = f32_pair
    ref = RefEngine.create(rcfg, params, mesh, batch=3, max_len=32)
    eng = Engine.create(cfg, model, batch=3, max_len=32, device="cpu")
    rng = np.random.default_rng(4)
    for step in range(6):
        toks = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
        active = np.array([True, step % 3 != 1, step > 1])
        want = ref.step_logits(toks, active)
        got = eng.step_logits(toks, active)
        assert got.shape == want.shape == (3, cfg.vocab_size)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_array_equal(eng.pos, ref.pos)


def test_greedy_generation_matches_reference_engine(f32_pair):
    rcfg, params, cfg, model, mesh = f32_pair
    prompts = np.stack(_prompts(cfg, (5, 5), seed=6))
    want = RefEngine.create(rcfg, params, mesh, batch=2,
                            max_len=32).generate(jnp.asarray(prompts), 6)
    got = Engine.create(cfg, model, batch=2, max_len=32,
                        device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batcher_matches_reference_batcher(f32_pair):
    rcfg, params, cfg, model, mesh = f32_pair
    work = [(p, n) for p, n in zip(_prompts(cfg, (4, 7, 3, 5), seed=8),
                                   (5, 3, 6, 4))]
    ref = RefBatcher(RefEngine.create(rcfg, params, mesh, batch=2,
                                      max_len=32))
    port = ContinuousBatcher(Engine.create(cfg, model, batch=2, max_len=32,
                                           device="cpu"))
    for rid, (p, n) in enumerate(work):
        ref.submit(RefRequest(rid=rid, prompt=p, max_new_tokens=n))
        port.submit(Request(rid=rid, prompt=p, max_new_tokens=n))
    want = {r.rid: r.generated for r in ref.run()}
    got = {r.rid: r.generated for r in port.run()}
    assert got == want
    assert port.ticks == ref.ticks


# ---------------------------------------------------------------------------
# the serving driver's flags (mirrors of tests/test_launch_serve.py)
# ---------------------------------------------------------------------------

def test_parse_defaults_equal_reference():
    got = vars(launch_serve.parse_args([]))
    assert got.pop("device") is None
    assert got == vars(ref_serve.parse_args([]))
    argv = ["--am-cache", "32", "--am-merge", "tree", "--am-probes", "2",
            "--full", "--slots", "5", "--max-new", "3"]
    got = vars(launch_serve.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == vars(ref_serve.parse_args(argv))
    with pytest.raises(SystemExit):
        launch_serve.parse_args(["--am-merge", "mesh"])


def test_cache_disabled_builds_no_service():
    args = launch_serve.parse_args(["--am-cache", "0", "--device", "cpu"])
    assert launch_serve.build_cache_service(args) is None


def test_default_service_is_local_flat():
    args = launch_serve.parse_args(["--device", "cpu"])
    svc = launch_serve.build_cache_service(args, start_driver=False)
    try:
        s = svc.stats()
        assert s["driver"] is None
        ts = s["tables"]["responses"]
        assert (ts["capacity"], ts["backend"], ts["policy"]) == (8, "pallas",
                                                                 "lru")
        key = np.arange(launch_serve.CACHE_DIM) % 8
        svc.append("responses", key, values=["v"])
        fut = svc.submit("responses", key)
        svc.flush()
        assert fut.result().hit and fut.result().value == "v"
    finally:
        svc.close()


def test_driver_resolves_submit_without_flush():
    args = launch_serve.parse_args(["--device", "cpu"])
    svc = launch_serve.build_cache_service(args)
    try:
        key = np.arange(launch_serve.CACHE_DIM) % 8
        svc.append("responses", key, values=[1])
        assert svc.submit("responses", key).result(timeout=30.0).hit
    finally:
        svc.close()


@pytest.mark.parametrize("flags", [["--am-sharded"], ["--am-index", "4"],
                                   ["--am-snapshot-dir", "snap"],
                                   ["--am-restore"]])
def test_unported_flags_raise(flags):
    args = launch_serve.parse_args(flags + ["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="port slice"):
        launch_serve.build_cache_service(args)


def test_main_serves_every_request(capsys):
    out = launch_serve.main(["--device", "cpu"])
    assert sorted(out["results"]) == list(range(6))
    assert out["cache"]["hits"] > 0
    assert out["cache"]["rows"] == len(out["generated"]) <= 8
    # a cached answer is the generation of the same prompt
    for i, gen in out["results"].items():
        for j in out["generated"]:
            if np.array_equal(out["workload"][i], out["workload"][j]):
                np.testing.assert_array_equal(gen, out["results"][j])
    assert "6/6 requests" in capsys.readouterr().out
