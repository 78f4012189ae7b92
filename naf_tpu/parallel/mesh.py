"""Device selection and mesh construction for the block-parallel pipeline."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.jaxenv import setup_jax

setup_jax()   # persistent compile cache

BLOCK_AXIS = "blocks"


def devices() -> list:
    """The devices the device path runs on: every accelerator JAX sees.

    CPU devices are returned only when the CPU was asked for
    (``JAX_PLATFORMS=cpu``, as the tests do).  Otherwise a missing or
    failed accelerator raises instead of letting ``--device`` run on a
    silent CPU fallback.
    """
    devs = jax.devices()
    if devs[0].platform == "cpu" and jax.config.jax_platforms != "cpu":
        raise RuntimeError(
            "naf_tpu: no accelerator found for the device path "
            "(set JAX_PLATFORMS=cpu to run it on the CPU)")
    return devs


def block_mesh(n_devices: int | None = None, devs=None) -> Mesh:
    """1-D mesh over devices; the single axis carries block data parallelism.

    Sequence parallelism (one giant sequence split across devices) rides the
    same axis: blocks are byte ranges, and the carry algebra (nibble parity,
    mask-run state, line-length max) stitches their boundaries, so a single
    record spanning many blocks works identically.
    """
    if devs is None:
        devs = devices()
        if n_devices is not None:
            devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (BLOCK_AXIS,))


def block_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BLOCK_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
