"""JAX environment setup shared by the CLIs and benchmarks.

Enables the persistent compilation cache so repeated CLI invocations reuse
the compiled programs for the fixed set of bucketed kernel shapes.
"""

from __future__ import annotations

import os

#: Cache location when ``JAX_COMPILATION_CACHE_DIR`` is not set: a fixed,
#: gitignored directory inside the checkout (the path is part of the
#: cache's key, so it must not move between runs).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str | None:
    """Directory this package points JAX's compile cache at, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads it itself; an
    empty value switches the cache off)."""
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return None
    return DEFAULT_CACHE_DIR


def setup_jax() -> None:
    path = cache_dir()
    if path is None:
        return
    import jax

    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)


def quiet_device_logs() -> None:
    """Silence jax/XLA startup chatter on stderr (CLI --device paths).

    The reference CLIs' stderr is a byte-exact contract (the golden suite
    diffs it).  Must run BEFORE the first jax import (glog reads its env at
    load).
    """
    import logging

    os.environ["TF_CPP_MIN_LOG_LEVEL"] = "3"
    # glog/absl C++ severities; 3 = FATAL-only for both spellings
    os.environ["ABSL_MIN_LOG_LEVEL"] = "3"
    os.environ["GLOG_minloglevel"] = "3"
    for name in ("jax._src.xla_bridge", "jax._src.compiler", "jax"):
        logging.getLogger(name).setLevel(logging.ERROR)
