"""Deferred jax loading.

The host data path (native scanner/renderer + zstd) never touches jax, and a
CLI codec must not pay ~4s of device-plugin import to compress a 1 KB file.
These helpers let the ops modules keep their jax definitions at module
scope while deferring the actual ``import jax`` (and device initialization)
to the first device-path call.
"""

from __future__ import annotations

import functools
import importlib


class LazyModule:
    """Attribute-proxy that imports the real module on first access."""

    def __init__(self, name: str):
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_mod", None)

    def _load(self):
        mod = object.__getattribute__(self, "_mod")
        if mod is None:
            name = object.__getattribute__(self, "_name")
            if name.split(".")[0] == "jax":
                from .jaxenv import setup_jax

                setup_jax()   # enable the persistent compile cache first
            mod = importlib.import_module(name)
            object.__setattr__(self, "_mod", mod)
        return mod

    def __getattr__(self, attr):
        return getattr(self._load(), attr)


def lazy_jit(fn=None, **jit_kwargs):
    """Like ``jax.jit`` but imports jax (and compiles) on first call."""
    if fn is None:
        return functools.partial(lazy_jit, **jit_kwargs)
    cell: list = []

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not cell:
            from .jaxenv import setup_jax

            setup_jax()
            import jax

            cell.append(jax.jit(fn, **jit_kwargs))
        return cell[0](*args, **kwargs)

    return wrapper
