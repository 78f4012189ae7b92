"""Device-side LZ match-candidate scoring (SURVEY §7 step 6).

The zstd bitstream is inherently serial, but match *finding* is the
data-parallel 99% of the work.  This kernel computes, for every input
position, the K closest earlier positions sharing the same 4-byte window —
with a sort instead of a hash table (hash tables are sequential-write; a
(key, position) sort is how you express "group equal windows" in XLA):

    keys      = hash32(window4(data))          # gather + multiply
    order     = argsort(keys, stable)          # XLA sort, runs on device
    cand[p,j] = j-th previous position in p's equal-key run

Hash collisions are harmless: the host serializer re-verifies bytes before
using a candidate (naf_zstd.cpp), exactly as it does for its own hash
table.  The output feeds ``naf_zstd_compress_cand_k`` — device proposes the
candidate chain, host extends/scores/packs the bitstream.
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils.lazy import LazyModule, lazy_jit

jnp = LazyModule("jax.numpy")

#: candidate chain depth proposed per position
TOP_K = 4


@lazy_jit(static_argnames=("k",))
def _candidates(data, k: int):
    n = data.shape[0]
    d = data.astype(jnp.uint32)
    # 4-byte little-endian window at each position (tail windows wrap
    # harmlessly; the host ignores candidates in the last 12 bytes)
    w = (d
         | jnp.roll(d, -1) << 8
         | jnp.roll(d, -2) << 16
         | jnp.roll(d, -3) << 24)
    keys = (w * jnp.uint32(2654435761)) >> 15
    order = jnp.argsort(keys, stable=True)          # pos ascending per key
    sk = jnp.take(keys, order)
    cols = []
    for j in range(1, k + 1):
        same = jnp.concatenate(
            [jnp.zeros(j, bool), sk[j:] == sk[:-j]])
        prev = jnp.concatenate(
            [jnp.zeros(j, jnp.int32), order[:-j].astype(jnp.int32)])
        cols.append(jnp.where(same, prev, jnp.int32(-1)))
    cand_sorted = jnp.stack(cols, axis=-1)          # [n, k]
    return jnp.zeros((n, k), jnp.int32).at[order].set(cand_sorted)


def find_match_candidates(data: np.ndarray, k: int = 1) -> np.ndarray:
    """int32[n, k] (or [n] when k == 1): closest earlier same-window
    positions, nearest first, -1 padded."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.size < 16:
        out = np.full((data.size, k), -1, np.int32)
        return out[:, 0] if k == 1 else out
    out = np.asarray(_candidates(data, k))
    return out[:, 0] if k == 1 else out


# ---------------------------------------------------------------------------
# Bounded-memory span pipeline (`tnaf --engine device -# [--long N]`):
# candidates are generated per SPAN over a sliding history window, so device
# memory is O(span + history) regardless of section size — the serializer
# (naf_zstd_compress_cand_stream) consumes each span's rows incrementally.
# ---------------------------------------------------------------------------

#: serialized span; must be a multiple of the zstd 128 KB block size
SPAN = 4 << 20


def _pow2(n: int, lo: int = 1 << 16) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


def find_match_candidates_windowed(data: np.ndarray, k: int, lo: int,
                                   hi: int, hist: int = SPAN) -> np.ndarray:
    """ABSOLUTE int32[hi-lo, k] candidates for positions [lo, hi), matched
    within ``data[max(0, lo-hist):hi]`` (bounded device window).

    The window is zero-padded up to a power-of-two bucket so jit
    recompilations stay bounded; pad positions sit after every real row in
    the stable argsort, so they can never be proposed as (earlier)
    candidates for real positions.
    """
    wlo = max(0, lo - hist)
    win = np.ascontiguousarray(data[wlo:hi], dtype=np.uint8)
    if win.size < 16:
        return np.full((hi - lo, k), -1, np.int32)
    cap = _pow2(win.size)
    if win.size < cap:
        win = np.concatenate([win, np.zeros(cap - win.size, np.uint8)])
    rel = np.asarray(_candidates(win, k))[lo - wlo:hi - wlo].astype(np.int64)
    return np.where(rel >= 0, rel + wlo, -1).astype(np.int32)


@lazy_jit
def _ldm_anchor_candidates(data):
    """Closest earlier anchor (stride 8) sharing the same 8-byte window
    hash — the long-distance-matching candidate pass for ``--long``."""
    d = data.astype(jnp.uint32).reshape(-1, 8)
    w0 = d[:, 0] | d[:, 1] << 8 | d[:, 2] << 16 | d[:, 3] << 24
    w1 = d[:, 4] | d[:, 5] << 8 | d[:, 6] << 16 | d[:, 7] << 24
    keys = (w0 * jnp.uint32(2654435761)) ^ (w1 * jnp.uint32(2246822519))
    order = jnp.argsort(keys, stable=True)
    sk = jnp.take(keys, order)
    same = jnp.concatenate([jnp.zeros(1, bool), sk[1:] == sk[:-1]])
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            order[:-1].astype(jnp.int32)])
    cand_sorted = jnp.where(same, prev, jnp.int32(-1))
    return jnp.zeros(keys.shape[0], jnp.int32).at[order].set(cand_sorted)


def find_ldm_candidates(data: np.ndarray, lo: int, hi: int,
                        hist: int = 64 << 20) -> np.ndarray:
    """ABSOLUTE int32[hi-lo] long-range candidate per position for
    [lo, hi): each 8-byte-aligned anchor proposes its closest equal-hash
    predecessor; intermediate positions inherit anchor + offset (the host
    serializer byte-verifies every proposal, so near-misses cost nothing).
    """
    wlo = max(0, lo - hist) & ~7
    win = np.ascontiguousarray(data[wlo:hi], dtype=np.uint8)
    if win.size < 64:
        return np.full(hi - lo, -1, np.int32)
    cap = _pow2(win.size)
    if win.size < cap:
        win = np.concatenate([win, np.zeros(cap - win.size, np.uint8)])
    anchors = np.asarray(_ldm_anchor_candidates(win))
    m0 = (lo - wlo) // 8
    m1 = (hi - wlo + 7) // 8
    arel = anchors[m0:m1].astype(np.int64)
    abs_anchor = np.where(arel >= 0, arel * 8 + wlo, -1)
    base = np.repeat(abs_anchor, 8)
    offs = np.tile(np.arange(8, dtype=np.int64), m1 - m0)
    col = np.where(base >= 0, base + offs, -1)
    start = lo - (wlo + m0 * 8)
    return col[start:start + (hi - lo)].astype(np.int32)
