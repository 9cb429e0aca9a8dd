import os
# unit tests run on the CPU with a virtual 8-device mesh for the sharding
# tests; tests marked `gpu` need a GPU (chip_smoke.py and bench.py drive
# the card end to end)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The XLA CPU runtime has segfaulted nondeterministically late in full-
# suite runs (3 runs, 3 different tests, each fine in isolation) —
# executable-cache/memory pressure over ~285 jit-heavy tests. Dropping
# compiled executables between modules bounds it; subsets re-verify in
# <5 min if a module needs isolation.
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    try:
        import jax
        jax.clear_caches()
    except Exception:
        pass


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU (decided at
    run time, never at import: every xdist worker collects the same
    tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (JAX backend is {jax.default_backend()})")
    return jax.devices()[0]
