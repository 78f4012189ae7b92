"""Device selection (parallel/mesh.devices) and compile-cache placement
(utils/jaxenv)."""

import os
from pathlib import Path
from types import SimpleNamespace

import pytest

from naf_tpu.parallel import mesh as M
from naf_tpu.utils import jaxenv

REPO = Path(__file__).resolve().parent.parent


def _fake_jax(platform: str, platforms):
    devs = [SimpleNamespace(platform=platform, id=i) for i in range(2)]
    return SimpleNamespace(devices=lambda: devs,
                           config=SimpleNamespace(jax_platforms=platforms))


@pytest.mark.parametrize("platforms", [None, "cuda,cpu", "cuda"])
def test_devices_refuses_silent_cpu_fallback(monkeypatch, platforms):
    """JAX fell back to the CPU although an accelerator was asked for (or
    nothing was): --device must fail, not run on the CPU."""
    monkeypatch.setattr(M, "jax", _fake_jax("cpu", platforms))
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        M.devices()


def test_devices_cpu_when_asked_and_gpu(monkeypatch):
    monkeypatch.setattr(M, "jax", _fake_jax("cpu", "cpu"))
    assert [d.platform for d in M.devices()] == ["cpu", "cpu"]
    monkeypatch.setattr(M, "jax", _fake_jax("gpu", "cuda,cpu"))
    assert [d.platform for d in M.devices()] == ["gpu", "gpu"]
    # the real process: the tests pin the CPU, which is allowed
    monkeypatch.undo()
    assert M.block_mesh(2).devices.size == 2


def test_cache_dir_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(jaxenv.cache_dir())
    assert path == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    calls = []
    import jax

    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(os, "makedirs", lambda p, exist_ok: None)
    jaxenv.setup_jax()
    assert ("jax_compilation_cache_dir", str(path)) in calls


@pytest.mark.parametrize("value", ["/somewhere/else", ""])
def test_cache_dir_env_wins(monkeypatch, value):
    """JAX_COMPILATION_CACHE_DIR set (empty = off): the package sets no
    cache directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    assert jaxenv.cache_dir() is None
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    jaxenv.setup_jax()
    assert calls == []
