"""The two device passes (stats_blocks_sharded + emit_blocks_sharded, run
through the host helpers stats_pass/emit_pass) vs a numpy oracle built on
ops.scan.

The oracle recomputes every pass output — block counts, run and record
counts, longest line, histograms, the packed stream, id/comment/quality
bytes and the per-record and mask-run lengths — from
ops.scan.scan_fasta_block / scan_fastq_block, which tests/test_scan_oracle.py
checks against the host numpy parser.
"""

from __future__ import annotations

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from naf_tpu.format import constants as C
from naf_tpu.ops import scan as S
from naf_tpu.parallel import block as B
from naf_tpu.parallel.mesh import block_mesh

TILE = 1 << 15


def _passes(blk: np.ndarray, prev: int, sis: bool, seq_type: int,
            fastq: bool):
    mesh = block_mesh(1)
    blocks = B.Blocks(blk[None], np.asarray([prev], np.uint8),
                      np.asarray([sis]))
    dev = B.upload_blocks(blocks, mesh)
    st = B.stats_pass(dev, mesh=mesh, seq_type=seq_type, fastq=fastq)
    caps = B.emit_caps(st, fastq=fastq, text_like=False)
    em = B.emit_pass(dev, st, caps, mesh=mesh, seq_type=seq_type,
                     fastq=fastq)
    return st, em


def _runs(lower: np.ndarray) -> np.ndarray:
    if lower.size == 0:
        return np.zeros(0, np.int64)
    edges = np.flatnonzero(lower[1:] != lower[:-1]) + 1
    return np.diff(np.concatenate([[0], edges, [lower.size]]))


def _assert_match(body: np.ndarray, prev: int, seq_type: int = 0,
                  sis: bool = False, fastq: bool = False):
    # the device reader pads blocks with LF to an even width
    blk = np.concatenate([body, np.full(2 - body.size % 2, 10, np.uint8)])
    scan = S.scan_fastq_block if fastq else S.scan_fasta_block
    kw = {} if fastq else {"starts_in_seq": sis}
    s = {k: np.asarray(v) for k, v in scan(
        jnp.asarray(blk), jnp.asarray(np.uint8(prev)), seq_type=seq_type,
        **kw).items()}
    st, em = _passes(blk, prev, sis, seq_type, fastq)
    (packed, first_code, cnt, id_vals, com_vals, qual_vals, seq_lens,
     id_lens, com_lens, qual_lens, run_lens) = [e[0] for e in em]

    sv = s["stream_val"][s["stream_keep"]]
    n = sv.size
    lower = sv >= 96
    rec = np.cumsum(s["rec_start"])
    n_rec = int(s["rec_start"].sum())
    qual_keep = s.get("qual_keep", np.zeros(blk.size, bool))

    # pass 1
    assert int(st.counts[0]) == n == int(cnt)
    assert int(st.id_bytes[0]) == int(s["id_keep"].sum())
    assert int(st.com_bytes[0]) == int(s["com_keep"].sum())
    assert int(st.qual_bytes[0]) == int(qual_keep.sum())
    assert int(st.n_rec[0]) == n_rec
    assert int(st.n_runs[0]) == _runs(lower).size
    assert bool(st.first_lower[0]) == bool(n and lower[0])
    assert int(st.longest[0]) == int(S.longest_line_block(
        jnp.asarray(s["seq_keep"]), jnp.asarray(s["is_eol"])))
    keys = ("hist_id", "hist_comment", "hist_seq") + (
        ("hist_qual",) if fastq else ())
    for k, key in enumerate(keys):
        lo, hi = st.hists[2 * k][0], st.hists[2 * k + 1][0]
        got = lo.astype(np.int64) + (hi.astype(np.int64) << 16)
        assert np.array_equal(got, s[key]), key

    # pass 2
    codes = C.NUC_CODE[:256][sv]
    pairs = codes[0:n - n % 2:2] | (codes[1:n - n % 2:2] << 4)
    assert np.array_equal(packed[:n // 2], pairs)
    if n % 2:
        assert int(packed[n // 2]) & 0x0F == int(codes[-1])
    if n:
        assert int(first_code) == int(codes[0])
    n_id = int(s["id_keep"].sum())
    assert np.array_equal(id_vals[:n_id], blk[s["id_keep"]])
    n_com = int(s["com_keep"].sum())
    assert np.array_equal(com_vals[:n_com], s["com_val"][s["com_keep"]])
    for got, keep in ((seq_lens, s["seq_keep"]), (id_lens, s["id_keep"]),
                      (com_lens, s["com_keep"]), (qual_lens, qual_keep)):
        want = np.bincount(rec[keep], minlength=n_rec + 1)
        assert np.array_equal(got[:n_rec + 1], want)
    want_runs = _runs(lower)
    assert np.array_equal(run_lens[:want_runs.size], want_runs)
    if fastq:
        n_q = int(qual_keep.sum())
        assert np.array_equal(qual_vals[:n_q], s["qual_val"][qual_keep])


def _gen_fasta(rng, n_rec=30, max_len=3000, alphabet=b"ACGTNn"):
    """Realistic FASTA: soft-masking in runs."""
    rows = []
    for i in range(n_rec):
        com = b" comment %d" % i if i % 3 else b""
        rows.append(b">rec%d%s\n" % (i, com))
        seq = rng.choice(np.frombuffer(alphabet, np.uint8),
                         size=int(rng.integers(1, max_len)))
        for s in rng.integers(0, max(1, seq.size - 50),
                              size=max(1, seq.size // 500)):
            seq[s:s + 50] |= 32
        rows.append(seq.tobytes() + b"\n")
    return np.frombuffer(b"".join(rows), np.uint8)


def test_structured_fasta_multi_tile():
    rng = np.random.default_rng(0)
    body = _gen_fasta(rng, n_rec=60, max_len=4000)[1:]
    _assert_match(body, ord(">"))


def test_masked_runs_and_wrapped_lines():
    rng = np.random.default_rng(1)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=120_000)
    for s in rng.integers(0, 119_000, size=60):
        seq[s:s + 400] |= 32
    wrapped = b"\n".join(seq[i:i + 70].tobytes()
                         for i in range(0, seq.size, 70))
    body = np.frombuffer(b"r1 big record\n" + wrapped + b"\n", np.uint8)
    _assert_match(body, ord(">"))


def test_unexpected_chars_counted():
    body = np.frombuffer(b"x\x01y bad\x02com\nAC!GT*acg\n>n2\nACGT\n",
                         np.uint8)
    _assert_match(body, ord(">"))


def test_mid_record_continuation():
    body = np.frombuffer(b"acGTACgt\nACGT\n>n2 c\nTTTT\n", np.uint8)
    _assert_match(body, ord("\n"), sis=True)


def test_single_char_mask_runs():
    body = np.frombuffer(b"r\n" + b"Aa" * 400 + b"\n", np.uint8)
    _assert_match(body, ord(">"))


def test_empty_and_tiny():
    _assert_match(np.frombuffer(b"r\nA\n", np.uint8), ord(">"))
    _assert_match(np.frombuffer(b"\n", np.uint8), ord(">"))


def test_tile_boundary_carries():
    rng = np.random.default_rng(2)
    # records and case changes straddling power-of-two offsets
    chunks = []
    for i in range(6):
        chunks.append(b">r%d\n" % i)
        n = TILE - 7 + int(rng.integers(0, 13))
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
        for s in rng.integers(0, max(1, n - 300), size=max(1, n // 800)):
            seq[s:s + 300] |= 32
        chunks.append(seq.tobytes() + b"\n")
    body = np.frombuffer(b"".join(chunks), np.uint8)[1:]
    _assert_match(body, ord(">"))


def test_header_dense_input():
    """Header-dense input (more header bytes than sequence)."""
    rows = [b">h%d very long comment line to overflow\nA\n" % i
            for i in range(3000)]
    body = np.frombuffer(b"".join(rows), np.uint8)[1:]
    _assert_match(body, ord(">"))


def test_fuzz_small_blocks():
    rng = np.random.default_rng(3)
    pool = np.frombuffer(b">ACGTNACGT \t\r\nacgt" + b"xyz*-", np.uint8)
    for trial in range(6):
        n = int(rng.integers(1, 1500))
        body = rng.choice(pool, size=n)
        _assert_match(body, ord(">"))


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------

def _gen_fastq(rng, n_reads=300, read_len=90, masked=True):
    out = []
    for i in range(n_reads):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=read_len)
        if masked and i % 3 == 0:
            seq[10:60] |= 32
        qual = rng.integers(35, 74, size=read_len, dtype=np.uint8)
        com = b" len%d" % read_len if i % 4 else b""
        out.append(b"@rd%04d%s\n%s\n+\n%s\n"
                   % (i, com, seq.tobytes(), qual.tobytes()))
    return np.frombuffer(b"".join(out), np.uint8)[1:]


def test_fastq_multi_tile():
    rng = np.random.default_rng(20)
    _assert_match(_gen_fastq(rng, n_reads=900, read_len=120), ord("@"),
                  fastq=True)


def test_fastq_tiny_and_unexpected():
    body = np.frombuffer(
        b"r1 c\nACGT\n+\n!!!!\n@r2\nNNZA\n+\n!!\x7f!\n", np.uint8)
    _assert_match(body, ord("@"), fastq=True)


def test_fastq_varied_lengths():
    rng = np.random.default_rng(21)
    out = []
    for i in range(200):
        ln = int(rng.integers(1, 200))
        seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=ln)
        qual = rng.integers(33, 100, size=ln, dtype=np.uint8)
        out.append(b"@x%d\n%s\n+\n%s\n" % (i, seq.tobytes(), qual.tobytes()))
    _assert_match(np.frombuffer(b"".join(out), np.uint8)[1:], ord("@"),
                  fastq=True)


def test_apply_mask_parity():
    """The decode's mask-case step (parallel/decode.apply_mask_parity)."""
    from naf_tpu.parallel.decode import apply_mask_parity

    rng = np.random.default_rng(30)
    n = 200_000
    chars = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    bounds = np.sort(rng.choice(n, size=400, replace=False))
    tog = np.zeros(n, np.uint8)
    np.add.at(tog, bounds, 1)
    parity = (np.cumsum(tog) & 1).astype(np.uint8)
    expect = chars + 32 * parity
    pad = np.full(112, 1 << 30, np.int64)          # out-of-range: dropped
    got = np.asarray(apply_mask_parity(
        jnp.asarray(chars), jnp.asarray(np.concatenate([bounds, pad]))))
    assert np.array_equal(got, expect)
