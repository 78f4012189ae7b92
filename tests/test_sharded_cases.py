"""Sharded device encode (encode_sharded on a 4-device virtual CPU mesh)
vs the host encoder: archives must equal naf_tpu.pipeline.encoder.encode
byte-for-byte, which the golden suite pins against the reference decoder.
Every case runs with NAF_TPU_NO_FALLBACK=1, so a device fault fails the
test instead of hiding behind the host fallback's identical archive.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from naf_tpu.parallel import pipeline as PL
from naf_tpu.parallel.mesh import block_mesh
from naf_tpu.pipeline.encoder import EncodeOptions, encode


def _gen(total=200_000, rec_len=20_000, seed=0, mask=True):
    rng = np.random.default_rng(seed)
    rows = []
    made = 0
    i = 0
    while made < total:
        n = min(rec_len, total - made)
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
        if mask:
            for s in rng.integers(0, max(1, n - 300), size=max(1, n // 4000)):
                seq[s:s + 300] |= 32
        body = b"\n".join(seq[j:j + 70].tobytes()
                          for j in range(0, n, 70))
        rows.append(b">rec%d c%d\n" % (i, i) + body + b"\n")
        made += n
        i += 1
    return b"".join(rows)


@pytest.fixture(autouse=True)
def _no_fallback(monkeypatch):
    monkeypatch.setenv("NAF_TPU_NO_FALLBACK", "1")


def _sharded(data: bytes, opts=None, D=4):
    opts = opts or EncodeOptions()
    return PL.encode_sharded(data, opts, mesh=block_mesh(D))


def test_multirecord_masked():
    data = _gen()
    host, _ = encode(data, EncodeOptions())
    assert _sharded(data)[0] == host


def test_giant_record_spans_blocks():
    data = _gen(total=150_000, rec_len=150_000, seed=1)
    host, _ = encode(data, EncodeOptions())
    assert _sharded(data)[0] == host


def test_unmasked_no_mask_flag():
    data = _gen(total=100_000, seed=2, mask=False)
    opts = EncodeOptions(no_mask=True)
    host, _ = encode(data, opts)
    assert _sharded(data, opts)[0] == host


def test_unexpected_chars_counted():
    """Unexpected characters: replaced in the archive, counted in stats."""
    data = b">r1\nACGTZZACGT\n" + _gen(total=60_000, seed=3)[:]
    host, host_stats = encode(data, EncodeOptions())
    blob, stats = _sharded(data)
    assert blob == host
    assert np.array_equal(stats.unexpected_seq, host_stats.unexpected_seq)
    assert int(stats.unexpected_seq[ord("Z")]) == 2


def test_encode_sharded_any_mesh_size():
    """One device per block down to a single device: the same archive."""
    data = _gen(total=120_000, seed=4)
    host, _ = encode(data, EncodeOptions())
    for D in (1, 3, 4):
        assert _sharded(data, D=D)[0] == host, D


def _gen_fq(n_reads=400, read_len=100, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=read_len)
        if i % 3 == 0:
            seq[10:60] |= 32
        qual = rng.integers(35, 74, size=read_len, dtype=np.uint8)
        com = b" x" if i % 4 else b""
        out.append(b"@read%04d/1%s\n%s\n+\n%s\n"
                   % (i, com, seq.tobytes(), qual.tobytes()))
    return b"".join(out)


def test_fastq_pipeline():
    data = _gen_fq()
    host, _ = encode(data, EncodeOptions())
    assert _sharded(data)[0] == host


def test_fastq_varied_reads():
    rng = np.random.default_rng(6)
    out = []
    for i in range(300):
        ln = int(rng.integers(1, 250))
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=ln)
        qual = rng.integers(33, 100, size=ln, dtype=np.uint8)
        out.append(b"@v%d\n%s\n+\n%s\n" % (i, seq.tobytes(),
                                           qual.tobytes()))
    data = b"".join(out)
    host, _ = encode(data, EncodeOptions())
    assert _sharded(data)[0] == host


def test_fastq_any_mesh_size():
    data = _gen_fq(n_reads=600, read_len=64, seed=7)
    host, _ = encode(data, EncodeOptions())
    for D in (1, 4):
        assert _sharded(data, D=D)[0] == host, D
