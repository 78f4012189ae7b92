"""4-bit nucleotide unpacking — the decoder's hottest per-byte transform.

Reference behavior: unnaf writes two ASCII chars per packed byte through a
256->u16 LUT (unnaf/src/utils.c:74-83, output.c:433-454).

Device form: nibble split + a 16-way select for the code->char map,
interleave via a (m, 2) reshape.  RNA renders code 1 as 'U'
(unnaf/src/unnaf.c:369).
"""

from __future__ import annotations

import numpy as np

from ..utils.lazy import LazyModule, lazy_jit

jnp = LazyModule("jax.numpy")

from ..format import constants as C

_DNA_CHARS = tuple(C.CODE_TO_NUC_DNA.tolist())
_RNA_CHARS = tuple(C.CODE_TO_NUC_RNA.tolist())


def _code_to_char(codes: jnp.ndarray, rna: bool) -> jnp.ndarray:
    """4-bit codes -> ASCII via a 16-way select."""
    chars = _RNA_CHARS if rna else _DNA_CHARS
    ci = codes.astype(jnp.int32)
    out = jnp.full_like(ci, chars[15])
    for code in range(15):
        out = jnp.where(ci == code, chars[code], out)
    return out.astype(jnp.uint8)


def _unpack_array(packed: jnp.ndarray, rna: bool) -> jnp.ndarray:
    lo = _code_to_char(packed & 15, rna)
    hi = _code_to_char(packed >> 4, rna)
    return jnp.stack([lo, hi], axis=-1).reshape(*packed.shape[:-1], -1)


@lazy_jit(static_argnames=("rna",))
def unpack_4bit_xla(packed: jnp.ndarray, rna: bool = False) -> jnp.ndarray:
    """packed: u8[M] -> u8[2M] ASCII."""
    return _unpack_array(packed, rna)


def unpack_4bit(packed_np: np.ndarray, total_chars: int, rna: bool = False,
                backend: str | None = None) -> np.ndarray:
    """Host wrapper: unpack 4-bit codes to `total_chars` ASCII bytes."""
    from .pack import bucket_size  # avoid cycle at import time

    packed_np = np.ascontiguousarray(packed_np, dtype=np.uint8)
    if packed_np.size == 0:
        return np.zeros(0, dtype=np.uint8)
    m = packed_np.size
    backend = backend or "numpy"
    if backend == "numpy":
        lut = C.CODES_TO_NUCS_RNA if rna else C.CODES_TO_NUCS_DNA
        out = lut[packed_np].reshape(-1)
    else:
        padded = np.pad(packed_np, (0, bucket_size(m, 1) - m))
        out = np.asarray(unpack_4bit_xla(jnp.asarray(padded), rna=rna))
    return out[:total_chars]
