"""Test-session environment pinning.

Must run before the first ``import jax`` anywhere in the test process:

* forces the CPU platform and 8 fake host devices, so every mesh-dependent
  test sees the same deterministic device topology on any host (laptop, CI,
  TPU pod frontend);
* when the real ``hypothesis`` package is unavailable (hermetic containers),
  installs the minimal shim from ``tests/_hypothesis_stub.py`` so property
  tests still run as seeded randomized sweeps.

Also arms a per-test hang guard (``faulthandler.dump_traceback_later``): a
test that deadlocks — the failure mode of the threaded AMDriver tests —
dumps every thread's traceback and kills the process after
``REPRO_TEST_TIMEOUT`` seconds (default 600), so CI fails in minutes with a
stack instead of idling to the job timeout.
"""

import faulthandler
import os
import sys

import pytest

# -- JAX platform pinning (before any jax import) ---------------------------

os.environ.setdefault("JAX_PLATFORMS", "cpu")

_FLAG = "--xla_force_host_platform_device_count=8"
_existing = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _existing:
    os.environ["XLA_FLAGS"] = f"{_existing} {_FLAG}".strip()

assert "jax" not in sys.modules, (
    "jax was imported before tests/conftest.py could pin XLA_FLAGS; "
    "check for jax imports in pytest plugins or earlier conftests")

# -- hypothesis fallback ----------------------------------------------------

try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub
    _hypothesis_stub.install()

# -- markers ------------------------------------------------------------------

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where none is present")


# -- compiled-executable cache bounding -------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _bound_jit_cache():
    """Drop jax's compiled-executable caches between test modules.

    A full-suite run compiles thousands of XLA executables in one process;
    every live executable pins JIT code mappings, and once the process
    crosses the kernel's ``vm.max_map_count`` ceiling (65530 here) the next
    compilation segfaults inside ``backend_compile`` — deterministically at
    whatever test happens to sit past the cliff.  Clearing per module keeps
    the map count bounded while leaving in-module caching behaviour (e.g.
    the serving compile-accounting tests) untouched.
    """
    yield
    import jax
    jax.clear_caches()


# -- per-test hang guard ----------------------------------------------------

_TEST_TIMEOUT = float(os.environ.get("REPRO_TEST_TIMEOUT", "600"))


@pytest.fixture(autouse=True)
def _hang_guard():
    """Dump all thread stacks and abort if a single test exceeds the budget.

    ``exit=True`` hard-kills the process after the dump: a deadlocked
    driver thread would otherwise hold pytest open until the CI job
    timeout.  Disable with REPRO_TEST_TIMEOUT=0 when debugging.
    """
    if _TEST_TIMEOUT > 0:
        faulthandler.dump_traceback_later(_TEST_TIMEOUT, exit=True)
    yield
    if _TEST_TIMEOUT > 0:
        faulthandler.cancel_dump_traceback_later()
