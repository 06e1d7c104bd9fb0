"""Test configuration: run JAX on a simulated 8-device CPU mesh.

JAX_PLATFORMS=cpu is set before jax is imported and pinned in jax.config
as well, so every test runs on the CPU backend whatever accelerator the
machine has. Golden tests compare against cv2 on CPU; the same code paths
run on the GPU through chip_smoke.py.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache, placed as tpuva.utils.enable_compilation_cache
# places it (JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache):
# repeat suite runs then skip most compiles.
from tpuva.utils import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


import pytest  # noqa: E402

# Build the optional C++ host runtime so tests/test_native.py actually runs
# instead of shipping green skips. Incremental: a built tree is a no-op
# make. Collection-time because the module's skipif
# checks availability at import. Quietly skipped where no compiler exists.
import shutil  # noqa: E402
import subprocess  # noqa: E402

if shutil.which("make") and shutil.which("g++"):
    try:
        subprocess.run(
            ["make", "-C", os.path.join(os.path.dirname(__file__), "..", "native")],
            check=False, capture_output=True, timeout=120,
        )
    except Exception:
        pass


@pytest.fixture(autouse=True, scope="module")
def _jax_cache_hygiene_per_module():
    """Free compiled executables at module boundaries.

    A single pytest process running the whole suite accumulates hundreds
    of live XLA:CPU executables; deep into that state, XLA's AOT
    serialization of one more executable segfaults the process (observed
    deterministically at ~70% of a cold-cache full run, in
    put_executable_and_time — upstream XLA:CPU bug, not reproducible with
    any file subset). Dropping the in-memory caches at each module
    boundary keeps the process out of that regime; recompiles are cheap
    because the persistent disk cache still hits."""
    yield
    import jax

    jax.clear_caches()
