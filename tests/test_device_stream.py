"""Chunked device encode (parallel/stream.py DeviceScanEngine).

Pins the three invariants of the streaming device path:
  1. byte-identity with the in-memory encoder for every chunk size — the
     carry algebra (nibble parity, mask-run tail, open-record length) must
     be exact across chunk AND block boundaries;
  2. seamless per-piece delegation to the native scanner (protein modes,
     irregular FASTQ, mid-line giant records) without breaking identity;
  3. error parity: invalid inputs raise the reference's exact texts no
     matter which engine scanned the failing piece.

Also pins the host-streaming FASTQ regression where a chunk boundary at an
exact record end left the next record's '@' unstripped (quality lines
starting with '@' made it visible — reference robust parser:
/root/reference/ennaf/src/process.c:477-544).
"""

import io

import numpy as np
import pytest

import naf_tpu.parallel.block as B
from naf_tpu.format import constants as C
from naf_tpu.pipeline.encoder import EncodeOptions, encode
from naf_tpu.pipeline.parser import InputError
from naf_tpu.pipeline.stream import encode_stream


@pytest.fixture(scope="module")
def engine_cls():
    from naf_tpu.parallel.stream import DeviceScanEngine

    return DeviceScanEngine


def stream_bytes(data: bytes, opts=None, *, chunk_size: int, engine) -> bytes:
    buf = io.BytesIO()
    encode_stream(io.BytesIO(data), buf, opts or EncodeOptions(),
                  chunk_size=chunk_size, engine=engine)
    return buf.getvalue()


def assert_identical(data: bytes, opts=None, chunks=(64, 257, 5000),
                     *, engine_cls, expect_device=True):
    opts = opts or EncodeOptions()
    ref, _ = encode(data, opts)
    for cs in chunks:
        eng = engine_cls()
        got = stream_bytes(data, opts, chunk_size=cs, engine=eng)
        assert got == ref, f"chunk_size={cs}"
        if expect_device:
            assert eng.device_chunks > 0, f"chunk_size={cs} never hit device"


def rand_fasta(rng, n_rec, maxlen=300):
    out = []
    for i in range(n_rec):
        L = int(rng.integers(1, maxlen))
        seq = rng.choice(list(b"ACGTacgtNnRy-"), size=L)
        s = bytes(seq.tolist())
        lines = [s[j:j + 61] for j in range(0, len(s), 61)]
        out.append(b">seq%d comment %d\n" % (i, i)
                   + b"\n".join(lines) + b"\n")
    return b"".join(out)


def rand_fastq(rng, n_rec, qual_lo=33, qual_hi=74):
    out = []
    for i in range(n_rec):
        L = int(rng.integers(1, 120))
        s = bytes(rng.choice(list(b"ACGTacgtn"), size=L).tolist())
        q = bytes(rng.integers(qual_lo, qual_hi, size=L,
                               dtype=np.uint8).tolist())
        out.append(b"@read%d some comment\n" % i + s + b"\n+\n" + q + b"\n")
    return b"".join(out)


class TestFasta:
    def test_multi_record(self, engine_cls):
        data = rand_fasta(np.random.default_rng(0), 40)
        assert_identical(data, engine_cls=engine_cls)

    def test_giant_single_record(self, engine_cls):
        """Sequence-parallel: one record spanning every chunk and block."""
        rng = np.random.default_rng(1)
        seq = rng.choice(list(b"ACGTacgt"), size=20000)
        lines = [bytes(seq[j:j + 63].tolist())
                 for j in range(0, seq.size, 63)]
        data = b">chr1 giant\n" + b"\n".join(lines) + b"\n"
        assert_identical(data, chunks=(64, 300, 1111),
                         engine_cls=engine_cls)

    def test_single_giant_line_delegates(self, engine_cls):
        """An unwrapped record (one line > chunk) must carry the open-line
        length; the engine delegates those pieces to the native scanner."""
        rng = np.random.default_rng(2)
        seq = bytes(rng.choice(list(b"ACGTN"), size=30000).tolist())
        data = b">x\n" + seq + b"\n"
        ref, _ = encode(data, EncodeOptions())
        eng = engine_cls()
        got = stream_bytes(data, chunk_size=1024, engine=eng)
        assert got == ref
        assert eng.native_chunks > 0

    def test_edges(self, engine_cls):
        for data in (b">\n", b">", b">a\nACGT", b">a\n>b\n\n>c\nAC\n",
                     b">i b\nACGTRYKMSWBDHVNacgtrykmswbdhvn\nZZ!!QQ\nACGT\n"):
            assert_identical(data, chunks=(8, 64), engine_cls=engine_cls,
                             expect_device=False)

    def test_rna_and_options(self, engine_cls):
        data = rand_fasta(np.random.default_rng(3), 12)
        rna = data.replace(b"T", b"U").replace(b"t", b"u")
        assert_identical(rna, EncodeOptions(seq_type=C.SEQ_TYPE_RNA),
                         chunks=(64, 999), engine_cls=engine_cls)
        assert_identical(data, EncodeOptions(no_mask=True), chunks=(257,),
                         engine_cls=engine_cls)
        assert_identical(data, EncodeOptions(level=19), chunks=(257,),
                         engine_cls=engine_cls)
        assert_identical(data, EncodeOptions(title="t"), chunks=(257,),
                         engine_cls=engine_cls)

    def test_protein_delegates(self, engine_cls):
        data = b">p1\nMKVLA*xx\n>p2\nACDEFGHIKLMNPQRSTVWY\n"
        opts = EncodeOptions(seq_type=C.SEQ_TYPE_PROTEIN)
        ref, _ = encode(data, opts)
        eng = engine_cls()
        assert stream_bytes(data, opts, chunk_size=16, engine=eng) == ref
        assert eng.device_chunks == 0 and eng.native_chunks > 0


class TestFastq:
    def test_regular(self, engine_cls):
        data = rand_fastq(np.random.default_rng(4), 200)
        assert_identical(data, chunks=(64, 300, 4096),
                         engine_cls=engine_cls)

    def test_qual_at_sign(self, engine_cls):
        """Quality lines starting with '@' + chunk cuts at record ends."""
        data = b"".join(
            b"@r%d c\nACGT\n+\n@@F@\n" % i for i in range(50))
        # sweep cuts across every phase of the 20-byte record period
        assert_identical(data, chunks=tuple(range(17, 27)) + (4096,),
                         engine_cls=engine_cls)

    def test_host_stream_strip_regression(self):
        """Host-only: boundary-at-record-end left the next '@' unstripped."""
        data = b"@r1 c\nACGT\n+\n@AAA\n@r2 c\nGGGG\n+\nBBBB\n"
        ref, _ = encode(data, EncodeOptions())
        for cs in range(8, 40):
            buf = io.BytesIO()
            encode_stream(io.BytesIO(data), buf, EncodeOptions(),
                          chunk_size=cs)
            assert buf.getvalue() == ref, f"chunk_size={cs}"

    def test_qual_mismatch_error_parity(self, engine_cls):
        data = b"@r1\nACGT\n+\nI\n@r2\nGG\n+\nII\n"
        with pytest.raises(InputError) as e_mem:
            encode(data, EncodeOptions())
        for cs in (8, 64):
            with pytest.raises(InputError) as e_str:
                stream_bytes(data, chunk_size=cs, engine=engine_cls())
            assert str(e_str.value) == str(e_mem.value)

    def test_plus_line_with_text(self, engine_cls):
        data = b"".join(b"@r%d x\nACGTacgt\n+r%d x\nIIIIIIII\n" % (i, i)
                        for i in range(30))
        assert_identical(data, chunks=(64, 999), engine_cls=engine_cls)


class TestCli:
    def test_tnaf_device_streams(self, tmp_path, monkeypatch):
        """--device on a large-ish file takes the chunked path and the
        archive matches the in-memory device encoder."""
        import naf_tpu.cli.tnaf as tnaf_cli

        data = rand_fasta(np.random.default_rng(5), 300)
        src = tmp_path / "in.fa"
        src.write_bytes(data)
        out = tmp_path / "out.naf"
        monkeypatch.setenv("NAF_TPU_STREAM_THRESHOLD", "1024")
        monkeypatch.setenv("NAF_TPU_DEVICE_CHUNK", "4096")
        rc = tnaf_cli.main(["--device", "-o", str(out), str(src)])
        assert rc == 0
        ref, _ = encode(data, EncodeOptions())
        assert out.read_bytes() == ref


class TestPerBlockRetry:
    """SURVEY §5 failure detection: an injected device fault requeues the
    chunk to the host scanner — byte-identical archive + warning, no abort."""

    def test_fault_every_chunk(self, engine_cls, monkeypatch):
        rng = np.random.default_rng(60)
        data = rand_fasta(rng, 40)
        ref, _ = encode(data, EncodeOptions())

        def boom(*a, **k):
            raise RuntimeError("injected device fault")

        monkeypatch.setattr(B, "stats_blocks_sharded", boom)
        eng = engine_cls()
        with pytest.warns(UserWarning, match="requeued to host scanner"):
            got = stream_bytes(data, chunk_size=300, engine=eng)
        assert got == ref
        assert eng.fault_chunks > 0 and eng.device_chunks == 0

    def test_fault_reraises_under_no_fallback(self, engine_cls, monkeypatch):
        """NAF_TPU_NO_FALLBACK=1: a device fault fails the encode instead of
        hiding behind a still-correct archive."""
        rng = np.random.default_rng(63)
        data = rand_fasta(rng, 20)

        def boom(*a, **k):
            raise RuntimeError("injected device fault")

        monkeypatch.setattr(B, "stats_blocks_sharded", boom)
        monkeypatch.setenv("NAF_TPU_NO_FALLBACK", "1")
        eng = engine_cls()
        with pytest.raises(RuntimeError, match="injected device fault"):
            stream_bytes(data, chunk_size=300, engine=eng)
        assert eng.fault_chunks == 0

    def test_fault_once_then_recover(self, engine_cls, monkeypatch):
        """Only the faulting chunk is requeued; later chunks return to the
        device."""
        rng = np.random.default_rng(61)
        data = rand_fasta(rng, 60)
        ref, _ = encode(data, EncodeOptions())
        def once_flaky(real):
            calls = {"n": 0}

            def fn(*a, **k):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise RuntimeError("injected transient fault")
                return real(*a, **k)
            return fn

        monkeypatch.setattr(B, "stats_blocks_sharded",
                            once_flaky(B.stats_blocks_sharded))
        eng = engine_cls()
        with pytest.warns(UserWarning, match="requeued to host scanner"):
            got = stream_bytes(data, chunk_size=400, engine=eng)
        assert got == ref
        assert eng.fault_chunks == 1
        assert eng.device_chunks > 0      # recovered after the fault

    def test_encode_sharded_fault_falls_back(self, monkeypatch):
        from naf_tpu.parallel.pipeline import encode_sharded

        rng = np.random.default_rng(62)
        data = rand_fasta(rng, 25)
        ref, _ = encode(data, EncodeOptions())

        def boom(*a, **k):
            raise RuntimeError("injected device fault")

        monkeypatch.setattr(B, "stats_blocks_sharded", boom)
        with pytest.warns(UserWarning, match="falling back to the"):
            blob, _ = encode_sharded(data, EncodeOptions())
        assert blob == ref
