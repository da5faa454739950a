"""Test harness config: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated without accelerators via
``xla_force_host_platform_device_count`` (see SURVEY.md §4).  Set env vars
before anything imports jax.  Tests that need a GPU carry the ``chip``
marker; the ``gpu`` fixture skips them here.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)      # bench.py / __graft_entry__ / chip_smoke

# the tests run on the CPU backend, whatever accelerator the host has
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import gc

import jax  # noqa: E402
import pytest  # noqa: E402

from mcmctoffitting_tpu.utils import compile_cache  # noqa: E402

# pytest autoloads a plugin that imports jax BEFORE this conftest, so the
# env var above can be too late; override the already-read config directly
# (backends are initialized lazily, so this still takes effect here)
jax.config.update("jax_platforms", "cpu")

# the package's numerics are float32 throughout (as on the GPU)
jax.config.update("jax_enable_x64", False)

# persist compiled executables across pytest processes so reruns only pay
# for new shapes; a fixed subdirectory of the checkout, apart from the
# GPU programs' cache (or JAX_COMPILATION_CACHE_DIR when that is set)
compile_cache.enable(".jax_cache_cpu")
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (tests marked ``chip``; they run on
    the card as phases of ``python chip_smoke.py``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run on the card via chip_smoke.py")


def _vm_map_count() -> int:
    """Number of memory mappings this process holds (see vm.max_map_count)."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux; the guard below becomes a no-op
        return 0


# The full suite runs ~200 tests in ONE process; accumulated executables,
# cached operator tables and allocator fragmentation can exhaust the
# kernel's vm.max_map_count (65530 here), after which LLVM's JIT dies with
# "Cannot allocate memory" mid-compile.  When the count nears the limit,
# drop every cache we own and let the persistent compile cache make the
# recompiles cheap.
_MAP_GUARD_THRESHOLD = int(os.environ.get("MCMC_MAP_GUARD", "45000"))
_MAP_LOG = os.environ.get("MCMC_MAP_LOG", "")


def _clear_all_caches() -> None:
    from mcmctoffitting_tpu.models import onebd, simult
    from mcmctoffitting_tpu.ops import e0grid

    jax.clear_caches()
    e0grid.cached_e0_grid_table.cache_clear()
    simult._build_table.cache_clear()
    onebd._build_table.cache_clear()
    gc.collect()


@pytest.fixture(autouse=True)
def _vm_map_guard(request):
    yield
    n = _vm_map_count()
    if _MAP_LOG:
        with open(_MAP_LOG, "a") as f:
            f.write(f"{n}\t{request.node.nodeid}\n")
    if n > _MAP_GUARD_THRESHOLD:
        _clear_all_caches()
        if _MAP_LOG:
            with open(_MAP_LOG, "a") as f:
                f.write(f"{_vm_map_count()}\tAFTER-CLEAR\n")
