"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Everything must pass hermetically on CPU.  The on-card tests
(tests/test_on_chip.py, marker ``chip``) run on a GPU when the suite is
launched with NAF_TPU_REAL_DEVICE=1 (chip_smoke.py does); without a GPU
they skip.
"""

import os

if not os.environ.get("NAF_TPU_REAL_DEVICE"):
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    # subprocesses (CLI tests, multihost workers) inherit both
    os.environ["JAX_PLATFORMS"] = "cpu"
    # no persistent compile cache on CPU test runs: XLA:CPU entries written
    # by other machines can abort the process on read (machine-feature
    # mismatch), and failed loads log onto the CLIs' golden stderr
    os.environ["JAX_COMPILATION_CACHE_DIR"] = ""
    import jax

    jax.config.update("jax_platforms", "cpu")

import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = Path("/root/reference")
REF_BUILD = REPO / ".ref_build"


def _build_reference() -> bool:
    """Build reference ennaf/unnaf against system zstd (test oracle only)."""
    REF_BUILD.mkdir(exist_ok=True)
    for tool in ("ennaf", "unnaf"):
        exe = REF_BUILD / tool
        if exe.exists():
            continue
        src = REF / tool / "src" / f"{tool}.c"
        if not src.exists():
            return False
        r = subprocess.run(
            ["gcc", "-O2", "-std=gnu99", "-o", str(exe), str(src), "-lzstd"],
            capture_output=True,
        )
        if r.returncode != 0:
            return False
    return True


HAVE_REFERENCE = _build_reference()

requires_reference = pytest.mark.skipif(
    not HAVE_REFERENCE, reason="reference binaries unavailable"
)


@pytest.fixture(scope="session")
def ref_bin():
    if not HAVE_REFERENCE:
        pytest.skip("reference binaries unavailable")
    return {"ennaf": str(REF_BUILD / "ennaf"), "unnaf": str(REF_BUILD / "unnaf")}


def run_ref(args, input_bytes=b"", binary=None):
    env = dict(os.environ)
    env.setdefault("TMPDIR", "/tmp")
    return subprocess.run(args, input=input_bytes, capture_output=True, env=env)


@pytest.fixture(autouse=True, scope="module")
def _drop_jit_executables_between_modules():
    """Free compiled executables after each test module.

    Every jitted program pins JIT code pages; across the full suite the
    process' memory-map count grows past vm.max_map_count (65530 default
    — measured 14k -> 57k+ in 8 minutes), at which point LLVM's mmap fails
    and XLA:CPU segfaults mid-compile (the round-5 full-suite crashes at
    ~40%/85%).  Clearing jax's caches at module boundaries caps the map
    count; modules recompile their own shapes anyway.
    """
    yield
    import jax

    jax.clear_caches()
