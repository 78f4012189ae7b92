"""Device classify (ops.scan) vs the numpy parser oracle (pipeline/parser.py).

Each block is scanned by ``scan_fasta_block`` / ``scan_fastq_block`` and
its per-byte classification reduced to what the parser returns for the
same bytes: the sequence stream, the id/comment blobs, per-record lengths,
the unexpected-char histograms, the record count and (FASTA) the longest
line.  The parser runs its pure-numpy path (the native scanner is switched
off), which tests/test_native.py fuzzes against the native C++ scanner.
"""

from __future__ import annotations

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from naf_tpu import native
from naf_tpu.format import constants as C
from naf_tpu.ops import scan as S
from naf_tpu.pipeline import parser as P

TILE = 1 << 15      # structure sizes below straddle this many bytes


@pytest.fixture(autouse=True)
def _numpy_oracle(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def _blob(vals: np.ndarray, rec: np.ndarray, n_rec: int) -> bytes:
    """Kept bytes grouped by record, each record '\\0'-terminated."""
    out = []
    for r in range(n_rec):
        out.append(vals[rec == r].tobytes() + b"\0")
    return b"".join(out)


def _reduce(s: dict, body: np.ndarray, fastq: bool):
    """Scan outputs -> the parser's view of the same bytes."""
    g = {k: np.asarray(v) for k, v in s.items()}
    rec = np.cumsum(g["rec_start"])          # marker byte -> its record
    n_rec = int(g["rec_start"].sum()) + 1
    out = dict(
        n=n_rec,
        seq=g["stream_val"][g["stream_keep"]].tobytes(),
        ids=_blob(body[g["id_keep"]], rec[g["id_keep"]], n_rec),
        com=_blob(g["com_val"][g["com_keep"]], rec[g["com_keep"]], n_rec),
        lengths=np.bincount(rec[g["seq_keep"]], minlength=n_rec),
        h_id=g["hist_id"], h_com=g["hist_comment"], h_seq=g["hist_seq"])
    if fastq:
        out["qual"] = g["qual_val"][g["qual_keep"]].tobytes()
        out["h_qual"] = g["hist_qual"]
    else:
        out["longest"] = int(S.longest_line_block(s["seq_keep"],
                                                  s["is_eol"]))
    return out


def _check(got: dict, host: P.ParseResult, fastq: bool):
    assert got["n"] == host.n_sequences
    assert got["seq"] == host.seq.tobytes()
    assert got["ids"] == host.ids_blob
    assert got["com"] == host.comments_blob
    assert np.array_equal(got["lengths"], host.lengths.astype(np.int64))
    for k, h in (("h_id", host.unexpected_id),
                 ("h_com", host.unexpected_comment),
                 ("h_seq", host.unexpected_seq)):
        assert np.array_equal(got[k], h[:256].astype(np.int64)), k
    if fastq:
        assert got["qual"] == host.qual.tobytes()
        assert np.array_equal(got["h_qual"],
                              host.unexpected_qual[:256].astype(np.int64))
    else:
        assert got["longest"] == host.longest_line


def _assert_match(body: np.ndarray, prev: int, seq_type: int = 0,
                  sis: bool = False):
    """Scan ``body`` (the bytes after a '>' marker, or after ``prev`` for a
    block cut inside a record) and compare with the parser on the whole
    input.  An EOL-class ``prev`` means the block starts a line: the oracle
    input is then '>' + prev + body (record 0 has an empty header, and the
    bytes before the block's first marker are its sequence when ``sis``)."""
    line_start = bool(C.IS_EOL[prev])
    assert line_start or not sis
    if line_start and not sis:
        # a block that starts a line outside a record starts with a marker
        assert body.size == 0 or body[0] == ord(">")
    prefix = b">" + (bytes([prev]) if line_start else b"")
    s = S.scan_fasta_block(jnp.asarray(body), jnp.asarray(np.uint8(prev)),
                           seq_type=seq_type, starts_in_seq=sis)
    host = P.parse_fasta(prefix + body.tobytes(), seq_type)
    _check(_reduce(s, body, fastq=False), host, fastq=False)


def _gen_fasta(rng, n_rec=30, max_len=3000, alphabet=b"ACGTacgtNnZz \t"):
    rows = []
    for i in range(n_rec):
        com = b" comment %d" % i if i % 3 else b""
        rows.append(b">rec%d%s\n" % (i, com))
        seq = rng.choice(np.frombuffer(alphabet, np.uint8),
                         size=int(rng.integers(1, max_len)))
        rows.append(seq.tobytes() + b"\n")
    return np.frombuffer(b"".join(rows), np.uint8)


def test_structured_fasta_multi_tile():
    rng = np.random.default_rng(0)
    body = _gen_fasta(rng, n_rec=60, max_len=4000)[1:]
    _assert_match(body, ord(">"))


@pytest.mark.parametrize("seq_type", [C.SEQ_TYPE_DNA, C.SEQ_TYPE_RNA,
                                      C.SEQ_TYPE_PROTEIN, C.SEQ_TYPE_TEXT])
def test_all_seq_types(seq_type):
    rng = np.random.default_rng(seq_type)
    body = _gen_fasta(rng, n_rec=12, max_len=800,
                      alphabet=b"ACGTUacgtNnXx*?-Zz>@ \t")[1:]
    _assert_match(body, ord(">"), seq_type=seq_type)


def test_random_bytes_fuzz():
    """Arbitrary byte soup: every class transition, CR/LF variants, 8-bit."""
    rng = np.random.default_rng(7)
    for trial in range(6):
        n = int(rng.integers(100, 3 * TILE))
        body = rng.integers(0, 256, n, dtype=np.uint8)
        # raise the density of structural bytes
        for ch, frac in ((ord(">"), 0.02), (10, 0.1), (13, 0.02),
                         (32, 0.05), (9, 0.01)):
            idx = rng.integers(0, n, max(1, int(n * frac)))
            body[idx] = ch
        if trial % 2:
            _assert_match(body, ord("\n"), sis=True)
        else:
            _assert_match(body, ord(">"))


def test_starts_in_seq_and_prev_byte():
    rng = np.random.default_rng(3)
    body = _gen_fasta(rng, n_rec=5)[1:]
    _assert_match(body, ord("\n"), sis=True)
    _assert_match(body, ord("A"), sis=False)
    # marker at byte 0 only counts after an EOL prev byte
    b2 = np.frombuffer(b">x c\nACGT\n", np.uint8)
    _assert_match(b2, ord("\n"))
    _assert_match(b2, ord("A"))


def test_tile_boundary_markers():
    """Records cut exactly at power-of-two block offsets."""
    T = TILE
    line = b"A" * 63 + b"\n"
    filler = line * (T // 64)
    body = (filler[: T - 3] + b"\n>r1 c\n" + filler[: T - 10]
            + b"\n>r2\n" + b"ACGT\n")
    _assert_match(np.frombuffer(body, np.uint8), ord(">"))


def test_header_spanning_tiles():
    """A header line longer than a tile keeps the ID/COMMENT state."""
    T = TILE
    body = b"x" * (T // 2) + b" " + b"c" * T + b"\nACGT\n"
    _assert_match(np.frombuffer(body, np.uint8), ord(">"))


def test_empty_and_tiny():
    _assert_match(np.frombuffer(b"r\nA\n", np.uint8), ord(">"))
    _assert_match(np.frombuffer(b"\n", np.uint8), ord(">"))
    _assert_match(np.frombuffer(b"A", np.uint8), ord(">"))


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------

def _assert_fastq_match(body: np.ndarray, prev: int, seq_type: int = 0,
                        pad: int = 0):
    """``pad`` LF bytes are appended to the scanned block only (the device
    reader pads blocks with LF); the oracle sees the unpadded input."""
    assert prev == ord("@")
    blk = np.concatenate([body, np.full(pad, 10, np.uint8)])
    s = S.scan_fastq_block(jnp.asarray(blk), jnp.asarray(np.uint8(prev)),
                           seq_type=seq_type)
    host = P.parse_fastq(b"@" + body.tobytes(), seq_type)
    _check(_reduce(s, blk, fastq=True), host, fastq=True)


def _gen_fastq(rng, n_rec, max_len=200, alphabet=b"ACGTNacgtZz "):
    """Reads whose quality length equals the kept (non-space) read length,
    as the parser requires; quality bytes span '!'..'~' ('@' and '+'
    included)."""
    rows = []
    for i in range(n_rec):
        ln = int(rng.integers(1, max_len))
        seq = rng.choice(np.frombuffer(alphabet, np.uint8), size=ln)
        seq[0] = ord("A")
        n_keep = int((~C.IS_SPACE[:256][seq]).sum())
        seq = seq.tobytes()
        qual = rng.integers(33, 127, size=n_keep, dtype=np.uint8).tobytes()
        com = b" c%d @x" % i if i % 3 else b""
        rows.append(b"@read%d%s\n%s\n+\n%s\n" % (i, com, seq, qual))
    return np.frombuffer(b"".join(rows), np.uint8)[1:]


def test_fastq_multi_tile():
    rng = np.random.default_rng(11)
    _assert_fastq_match(_gen_fastq(rng, 1200), ord("@"))


def test_fastq_long_reads_span_tiles():
    """Reads longer than a tile."""
    rng = np.random.default_rng(12)
    body = _gen_fastq(rng, 4, max_len=2 * TILE // 3)
    _assert_fastq_match(body, ord("@"))


def test_fastq_weird_bytes():
    """'@'/'+' inside quality strings, unexpected chars everywhere."""
    rng = np.random.default_rng(13)
    body = _gen_fastq(rng, 300, alphabet=b"ACGT@+>\x01~ acgt")
    _assert_fastq_match(body, ord("@"))


def test_fastq_lf_padding_tail():
    body = np.frombuffer(b"r1\nACGT\n+\n!!!!\n", np.uint8)
    _assert_fastq_match(body, ord("@"), pad=37)
