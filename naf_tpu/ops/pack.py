"""4-bit nucleotide packing — the encoder's hottest per-byte transform.

Reference behavior: ennaf/src/encoders.c:30-69 — each sequence byte maps to a
4-bit IUPAC code via a LUT; two codes pack into one byte, low nibble first;
odd-length streams carry a parity nibble across calls.

Host wrapper over two forms: numpy (the default for host-resident streams)
and XLA (the form the sharded device pipeline fuses into its emit pass,
ops.scan.pack_even).
"""

from __future__ import annotations

import numpy as np

from ..utils.lazy import LazyModule, lazy_jit

jnp = LazyModule("jax.numpy")

from ..format import constants as C
from . import tables as T


def _pack_pairs(codes: jnp.ndarray) -> jnp.ndarray:
    """u8[..., 2*m] 4-bit codes -> u8[..., m]; low nibble first."""
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return lo | (hi << 4)


# ---------------------------------------------------------------------------
# XLA path
# ---------------------------------------------------------------------------

@lazy_jit
def pack_4bit_xla(seq: jnp.ndarray) -> jnp.ndarray:
    """seq: u8[N] ASCII (N even) -> u8[N/2] packed codes."""
    codes = jnp.take(T.NUC_CODE, seq.astype(jnp.int32))
    return _pack_pairs(codes)


def bucket_size(n: int, align: int) -> int:
    """Round n up to a power-of-two multiple of `align` (min one tile).

    Bounds the number of distinct jit shapes (and thus compilations) to
    O(log n) across a run; callers slice the padded tail off.
    """
    m = align
    while m < n:
        m *= 2
    return m


def pack_4bit(seq_np: np.ndarray, parity_nibble: int | None = None,
              backend: str | None = None) -> tuple[np.ndarray, int | None]:
    """Host wrapper: pack an ASCII uint8 array into 4-bit codes.

    `parity_nibble` is the pending low nibble (a 4-bit code) carried from the
    previous block, or None.  Returns (packed bytes, new carry nibble or None).
    Parity semantics mirror ennaf/src/encoders.c:40-68.
    """
    seq_np = np.ascontiguousarray(seq_np, dtype=np.uint8)
    backend = backend or "numpy"
    prefix = b""
    if parity_nibble is not None:
        if seq_np.size == 0:
            return np.frombuffer(b"", dtype=np.uint8), parity_nibble
        first_code = int(C.NUC_CODE[seq_np[0]])
        prefix = bytes((parity_nibble | (first_code << 4),))
        seq_np = seq_np[1:]

    n = seq_np.size
    carry: int | None = None
    if n % 2 == 1:
        carry = int(C.NUC_CODE[seq_np[-1]])
        seq_np = seq_np[:-1]
        n -= 1

    if n == 0:
        packed = np.frombuffer(prefix, dtype=np.uint8).copy()
        return packed, carry

    if backend == "numpy":
        codes = C.NUC_CODE[:256][seq_np]
        out = codes[0::2] | (codes[1::2] << 4)
    else:
        padded = np.pad(seq_np, (0, bucket_size(n, 2) - n))
        out = np.asarray(pack_4bit_xla(jnp.asarray(padded)))[: n // 2]
    if prefix:
        out = np.concatenate([np.frombuffer(prefix, dtype=np.uint8), out])
    return out, carry
