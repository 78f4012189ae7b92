"""Unit tests: VLE codec, container header/section framing, zstd sections."""

import io

import numpy as np
import pytest

from naf_tpu.codec import compress_section, decompress_section
from naf_tpu.format import (
    NafArchive, NafHeader, NafReader, Section, naf_bytes,
    SEQ_TYPE_PROTEIN, VleError, decode_vle, encode_vle, read_vle,
)


@pytest.mark.parametrize("v", [0, 1, 127, 128, 129, 300, 2**14, 2**21 - 1,
                               2**32, 2**63 - 1, 123456789012345])
def test_vle_roundtrip(v):
    b = encode_vle(v)
    got, pos = decode_vle(b)
    assert got == v and pos == len(b)
    assert read_vle(io.BytesIO(b)) == v


def test_vle_minimal_length():
    assert encode_vle(0) == b"\x00"
    assert encode_vle(127) == b"\x7f"
    assert encode_vle(128) == b"\x81\x00"     # MSB-limb-first base 128


def test_vle_rejects_leading_0x80():
    with pytest.raises(VleError):
        decode_vle(b"\x80\x01")


def test_vle_overflow():
    with pytest.raises(VleError):
        decode_vle(b"\xff" * 10 + b"\x7f")


def test_zstd_section_roundtrip():
    data = b"ACGT" * 1000
    payload = compress_section(data, level=3)
    assert decompress_section(payload, len(data)) == data
    # magic is stripped
    assert not payload.startswith(bytes((0x28, 0xB5, 0x2F, 0xFD)))


def test_container_roundtrip():
    secs = {
        k: Section(uncompressed_size=10, payload=compress_section(b"x" * 10))
        for k in ("ids", "comments", "lengths", "mask", "sequence")
    }
    h = NafHeader(line_length=80, n_sequences=3)
    blob = naf_bytes(NafArchive(header=h, sections=secs))
    r = NafReader(io.BytesIO(blob))
    assert r.header.seq_type == 0
    assert r.header.has_mask and not r.header.has_quality
    assert r.line_length == 80 and r.n_sequences == 3
    u, payload = r.load_section("lengths")     # skips ids+comments
    assert u == 10
    assert decompress_section(payload, 10) == b"x" * 10
    u2, _ = r.load_section("sequence")         # skips mask
    assert u2 == 10


def test_container_v2_seq_type():
    secs = {k: Section(10, compress_section(b"y" * 10))
            for k in ("ids", "comments", "lengths", "sequence")}
    h = NafHeader(format_version=2, seq_type=SEQ_TYPE_PROTEIN, has_mask=False)
    blob = naf_bytes(NafArchive(header=h, sections=secs))
    r = NafReader(io.BytesIO(blob))
    assert r.header.seq_type == SEQ_TYPE_PROTEIN
    assert r.header.format_version == 2


# ---------------------------------------------------------------------------
# system-libzstd encode backend (codec/syszstd.py)
# ---------------------------------------------------------------------------

def _have_syszstd():
    from naf_tpu.codec import syszstd

    return syszstd.load() is not None


@pytest.mark.skipif(not _have_syszstd(), reason="no system libzstd")
@pytest.mark.parametrize("level", [-131072, -5, 1, 9, 19, 22])
def test_syszstd_levels_roundtrip(level):
    """Every CLI-reachable level produces a frame that decodes back."""
    from naf_tpu.codec import decompress_section

    data = (b"ACGTacgtNRYKM" * 5000)[: 60_001]
    payload = compress_section(data, level=level)
    assert decompress_section(payload, len(data)) == data


@pytest.mark.skipif(not _have_syszstd(), reason="no system libzstd")
def test_syszstd_streaming_matches_oneshot_rule():
    """Payload size alone decides the frame (in-memory == many tiny writes),
    on both sides of the one-shot/streaming cutover."""
    from naf_tpu.codec import SectionCompressor

    rng = np.random.default_rng(3)
    for n in (1 << 16, (4 << 20) + 4096):     # below / above the cutover
        data = rng.integers(0, 16, n, dtype=np.uint8)
        a = SectionCompressor(19, threads=2)
        a.write(data)
        one = a.finish()
        b = SectionCompressor(19, threads=2)
        for off in range(0, n, 65537):
            b.write(data[off:off + 65537])
        many = b.finish()
        assert one == many


@pytest.mark.skipif(not _have_syszstd(), reason="no system libzstd")
def test_syszstd_ldm_window_roundtrip():
    """--long path: LDM + explicit windowLog through the system library."""
    from naf_tpu.codec import decompress_section

    rng = np.random.default_rng(4)
    unit = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    data = unit + b"\x00" * (1 << 20) + unit      # long-range repeat
    payload = compress_section(data, level=19, window_log=24, threads=2)
    assert decompress_section(payload, len(data)) == data
    assert len(payload) < len(unit) * 1.2         # the repeat was found


def test_syszstd_decompress_roundtrip():
    """libzstd decode (one-shot and streamed) of frames the zstandard
    package writes: plain, long-window, content-size-less, empty."""
    import zstandard

    from naf_tpu.codec import syszstd

    rng = np.random.default_rng(5)
    unit = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    cases = [b"", b"ACGT" * 1000, unit + b"\x00" * (3 << 20) + unit]
    for data in cases:
        for kw in ({"level": 3}, {"level": 19, "write_content_size": False}):
            frame = zstandard.ZstdCompressor(**kw).compress(data)
            assert syszstd.decompress(frame, len(data)) == data
            d = syszstd.SysZstdDecompressor()
            got = b"".join(d.decompress(frame[i:i + 65521])
                           for i in range(0, len(frame), 65521))
            assert got == data and d.finished
    params = zstandard.ZstdCompressionParameters.from_level(
        19, window_log=28, enable_ldm=True)
    big = cases[2]
    frame = zstandard.ZstdCompressor(compression_params=params).compress(big)
    assert syszstd.decompress(frame, len(big)) == big
    with pytest.raises(RuntimeError, match="size mismatch"):
        syszstd.decompress(frame, len(big) - 1)
    with pytest.raises(RuntimeError, match="size mismatch"):
        syszstd.decompress(frame, len(big) + 1)


def test_main_path_without_zstandard(tmp_path):
    """tnaf/untnaf (host and --device) import and round-trip with the
    zstandard package blocked: libzstd is the default engine's only
    entropy library."""
    import subprocess
    import sys

    src = tmp_path / "x.fa"
    rng = np.random.default_rng(6)
    seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=300_000)
    src.write_bytes(b">r1 c\n" + b"\n".join(
        seq[i:i + 60].tobytes() for i in range(0, seq.size, 60)) + b"\n")
    code = f"""
import sys
sys.modules["zstandard"] = None
from naf_tpu.cli import tnaf, untnaf
for dev in ([], ["--device"]):
    assert tnaf.main(dev + [{str(src)!r}, "-o", {str(tmp_path / "x.naf")!r}]) == 0
    assert untnaf.main(dev + [{str(tmp_path / "x.naf")!r}, "-o", {str(tmp_path / "y.fa")!r}]) == 0
    assert open({str(tmp_path / "y.fa")!r}, "rb").read() == open({str(src)!r}, "rb").read()
assert sys.modules["zstandard"] is None
print("ok")
"""
    from pathlib import Path

    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       cwd=str(Path(__file__).resolve().parent.parent),
                       timeout=600)
    assert r.returncode == 0 and r.stdout.strip() == b"ok", r.stderr[-2000:]


def test_missing_libzstd_names_native_engine(tmp_path, monkeypatch, capsys):
    """Without libzstd the default engine fails with a message naming
    --engine native; it does not switch engines silently."""
    from naf_tpu.cli import tnaf, untnaf
    from naf_tpu.codec import syszstd

    src = tmp_path / "x.fa"
    src.write_bytes(b">r1\n" + b"ACGT" * 50_000 + b"\n")
    out = tmp_path / "x.naf"
    assert tnaf.main(["--engine", "native", str(src), "-o", str(out)]) == 0
    monkeypatch.setattr(syszstd, "load", lambda: None)
    with pytest.raises(SystemExit) as e:
        tnaf.main([str(src), "-o", str(tmp_path / "z.naf")])
    assert e.value.code == 1
    assert "--engine native" in capsys.readouterr().err
    assert not (tmp_path / "z.naf").exists()
    with pytest.raises(SystemExit):
        untnaf.main([str(out), "-o", str(tmp_path / "y.fa")])
    assert "--engine native" in capsys.readouterr().err
    from naf_tpu.codec import set_decode_engine

    try:
        assert untnaf.main(["--engine", "native", str(out), "-o",
                            str(tmp_path / "y.fa")]) == 0
    finally:
        set_decode_engine("zstd")
    assert (tmp_path / "y.fa").read_bytes() == src.read_bytes()


def test_syszstd_load_is_thread_safe(monkeypatch):
    """Section compressors open libzstd from a thread pool: the first
    concurrent callers must all get the library, never a half-set memo."""
    import threading

    from naf_tpu.codec import syszstd

    monkeypatch.setattr(syszstd, "_lib", None)
    monkeypatch.setattr(syszstd, "_loaded", False)
    barrier = threading.Barrier(8)
    got = []

    def worker():
        barrier.wait()
        got.append(syszstd.load())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is not None for g in got)
