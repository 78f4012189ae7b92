"""Stream compaction (ops.scan.compact: prefix count + scatter) vs numpy.

The emit pass compacts every kept stream with it: the sequence and quality
streams (mostly kept), the id/comment bytes (mostly dropped) and the i32
record-boundary positions.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from naf_tpu.ops import scan as S


def _check(v, k):
    out, cnt = S.compact(jnp.asarray(k), jnp.asarray(v))
    want = v[k]
    got = np.asarray(out)
    assert got.dtype == v.dtype
    assert int(cnt) == want.size
    assert np.array_equal(got[: want.size], want)
    assert not got[want.size:].any(), "garbage beyond count"


@pytest.mark.parametrize("n,p_keep", [
    (32768, 0.99),     # dense (the DNA regime)
    (70000, 0.986),    # ragged length, dense
    (131072, 0.5),
    (40000, 0.01),     # sparse (id/comment regime)
    (32768, 1.0),      # keep-all
    (33000, 0.0),      # drop-all
    (1, 1.0),
    (130, 0.7),
])
def test_compact_cases(n, p_keep):
    rng = np.random.default_rng(hash((n, int(p_keep * 100))) % 2**31)
    v = rng.integers(0, 256, n, dtype=np.uint8)
    k = rng.random(n) < p_keep
    _check(v, k)


def test_compact_fuzz():
    rng = np.random.default_rng(7)
    for _ in range(10):
        n = int(rng.integers(1, 150000))
        p = float(rng.random())
        v = rng.integers(0, 256, n, dtype=np.uint8)
        k = rng.random(n) < p
        _check(v, k)


def test_compact_structured_masks():
    """Newline-grid masks (the actual seq-stream pattern) and block masks."""
    rng = np.random.default_rng(8)
    n = 100_000
    v = rng.integers(0, 256, n, dtype=np.uint8)
    k = np.ones(n, bool)
    k[70::71] = False              # 70-char FASTA lines
    _check(v, k)
    k2 = np.zeros(n, bool)
    k2[5_000:25_000] = True        # one dense kept span (header regime)
    _check(v, k2)


def test_compact_int32_values():
    """Position compaction (record bounds) uses i32 values."""
    rng = np.random.default_rng(9)
    n = 50_000
    v = np.arange(n, dtype=np.int32) * 3
    k = rng.random(n) < 0.003      # sparse markers
    _check(v, k)


def test_compact_matches_scan_compact():
    """Inside jit, as the emit pass calls it, with a traced mask."""
    rng = np.random.default_rng(10)
    n = 40_000
    v = rng.integers(0, 256, n, dtype=np.uint8)
    k = rng.random(n) < 0.9

    @jax.jit
    def f(vals):
        return S.compact(vals >= 26, vals)

    out, cnt = f(jnp.asarray(v))
    want = v[v >= 26]
    assert int(cnt) == want.size
    assert np.array_equal(np.asarray(out)[:want.size], want)
    _check(v, k)


def test_dense_compact_matches_numpy():
    rng = np.random.default_rng(3)
    for dens in (1.0, 0.99, 0.985, 0.9, 0.5, 0.05):
        n = int(rng.integers(100, 3 * 128 * 128))
        keep = rng.random(n) < dens
        vals = rng.integers(0, 256, n, dtype=np.uint8)
        _check(vals, keep)


def test_dense_compact_fasta_grid_and_hole_clusters():
    rng = np.random.default_rng(4)
    pat = np.ones(71, bool)
    pat[70] = False                       # FASTA 70-char lines
    keep = np.tile(pat, 2000)
    keep[40_000:41_000] = False           # one dense hole cluster
    vals = rng.integers(0, 256, keep.size, dtype=np.uint8)
    _check(vals, keep)
