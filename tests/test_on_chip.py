"""On-card tests: the device path compiled for a GPU, checked against the
host path.

Marked ``chip``; the ``gpu`` fixture skips them unless JAX's default device
is a GPU, which needs the suite launched with NAF_TPU_REAL_DEVICE=1
(conftest pins everything else to the CPU):

    NAF_TPU_REAL_DEVICE=1 python -m pytest -m chip tests/test_on_chip.py

``python chip_smoke.py`` runs them as one of its phases.  Every test sets
NAF_TPU_NO_FALLBACK=1, so a device fault fails it instead of being hidden
by the host fallback's identical bytes.
"""

import io

import numpy as np
import pytest

pytestmark = pytest.mark.chip


@pytest.fixture
def gpu(monkeypatch):
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("no GPU: on-card test")
    monkeypatch.setenv("NAF_TPU_NO_FALLBACK", "1")
    return jax


def _fasta(rng, n_rec, lo, hi, alphabet=b"ACGTacgtNn"):
    rows = []
    for i in range(n_rec):
        rows.append(b">rec%d note\n" % i)
        seq = rng.choice(np.frombuffer(alphabet, np.uint8),
                         size=int(rng.integers(lo, hi)))
        rows.append(seq.tobytes() + b"\n")
    return b"".join(rows)


def test_device_function_returns_gpu(gpu):
    from naf_tpu.parallel.mesh import block_mesh, devices

    assert all(d.platform == "gpu" for d in devices())
    assert block_mesh(1).devices.flat[0].platform == "gpu"


def test_scan_block_on_gpu(gpu):
    """The device classify at 2^22 bytes matches the host parser."""
    import jax.numpy as jnp

    from naf_tpu.format import constants as C
    from naf_tpu.ops import scan as S
    from naf_tpu.pipeline import parser as P_

    rng = np.random.default_rng(2)
    data = _fasta(rng, 2000, 100, 4000, b"ACGTacgtNnZz")[: 1 << 22]
    data = data[: data.rindex(b"\n") + 1]
    body = np.frombuffer(data, np.uint8)[1:]
    s = S.scan_fasta_block(jnp.asarray(body), jnp.asarray(np.uint8(ord(">"))))
    host = P_.parse_fasta(data, C.SEQ_TYPE_DNA)
    stream = np.asarray(s["stream_val"])[np.asarray(s["stream_keep"])]
    assert stream.tobytes() == host.seq.tobytes()
    assert int(S.longest_line_block(s["seq_keep"], s["is_eol"])) \
        == host.longest_line


def test_compact_on_gpu(gpu):
    import jax.numpy as jnp

    from naf_tpu.ops import scan as S

    rng = np.random.default_rng(5)
    n = 1 << 24
    keep = rng.random(n) < 0.985
    vals = rng.integers(0, 256, n, dtype=np.uint8)
    out, cnt = S.compact(jnp.asarray(keep), jnp.asarray(vals))
    want = vals[keep]
    assert int(cnt) == want.size
    out = np.asarray(out)
    assert np.array_equal(out[:want.size], want)
    assert not out[want.size:].any()


def test_sharded_encode_fasta_on_gpu(gpu):
    """A masked single-record FASTA: the same archive as the host."""
    from naf_tpu.parallel.mesh import block_mesh
    from naf_tpu.parallel.pipeline import encode_sharded
    from naf_tpu.pipeline.encoder import EncodeOptions, encode

    rng = np.random.default_rng(8)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=2_000_000)
    seq[100_000:400_000] |= 32
    data = b">chrA\n" + b"\n".join(
        seq[j:j + 80].tobytes() for j in range(0, seq.size, 80)) + b"\n"
    blob, _ = encode_sharded(data, EncodeOptions(level=1), mesh=block_mesh(1))
    host, _ = encode(data, EncodeOptions(level=1))
    assert blob == host


def test_fastq_sharded_encode_on_gpu(gpu):
    from naf_tpu.parallel.mesh import block_mesh
    from naf_tpu.parallel.pipeline import encode_sharded
    from naf_tpu.pipeline.encoder import EncodeOptions, encode

    rng = np.random.default_rng(10)
    out = []
    for i in range(4000):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=100)
        if i % 3 == 0:
            seq[20:70] |= 32
        qual = rng.integers(35, 74, size=100, dtype=np.uint8)
        out.append(b"@read%05d/1\n%s\n+\n%s\n"
                   % (i, seq.tobytes(), qual.tobytes()))
    data = b"".join(out)
    blob, _ = encode_sharded(data, EncodeOptions(level=1), mesh=block_mesh(1))
    host, _ = encode(data, EncodeOptions(level=1))
    assert blob == host


def test_chunked_device_encode_on_gpu(gpu):
    """The streaming DeviceScanEngine runs every chunk on the card and
    matches the in-memory encoder byte-for-byte."""
    from naf_tpu.parallel.mesh import block_mesh
    from naf_tpu.parallel.stream import DeviceScanEngine
    from naf_tpu.pipeline.encoder import EncodeOptions, encode
    from naf_tpu.pipeline.stream import encode_stream

    rng = np.random.default_rng(4)
    data = _fasta(rng, 60, 100, 900)
    ref, _ = encode(data, EncodeOptions())
    eng = DeviceScanEngine(mesh=block_mesh(1))
    buf = io.BytesIO()
    encode_stream(io.BytesIO(data), buf, EncodeOptions(),
                  chunk_size=8192, engine=eng)
    assert buf.getvalue() == ref
    assert eng.device_chunks > 0 and eng.fault_chunks == 0


def test_device_decode_on_gpu(gpu):
    """Ragged records: the batched gather render."""
    from naf_tpu.parallel.mesh import block_mesh
    from naf_tpu.pipeline.decoder import Decoder, DecodeOptions
    from naf_tpu.pipeline.encoder import EncodeOptions, encode

    rng = np.random.default_rng(3)
    data = _fasta(rng, 200, 10, 4000)
    blob, _ = encode(data, EncodeOptions(level=1))
    host = Decoder(io.BytesIO(blob), DecodeOptions()).fasta()
    dev = Decoder(io.BytesIO(blob), DecodeOptions()).fasta_device(
        mesh=block_mesh(1))
    assert dev == host == data


def test_regular_render_fastq_on_gpu(gpu):
    """Uniform-group FASTQ decode (reshape/concat render)."""
    from naf_tpu.parallel.mesh import block_mesh
    from naf_tpu.pipeline.decoder import Decoder, DecodeOptions
    from naf_tpu.pipeline.encoder import EncodeOptions, encode

    rng = np.random.default_rng(9)
    out = []
    for i in range(2000):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=100)
        qual = rng.integers(35, 74, size=100, dtype=np.uint8)
        out.append(b"@read%04d/1\n%s\n+\n%s\n"
                   % (i, seq.tobytes(), qual.tobytes()))
    data = b"".join(out)
    blob, _ = encode(data, EncodeOptions(level=1))
    host = Decoder(io.BytesIO(blob), DecodeOptions()).fastq()
    dev = Decoder(io.BytesIO(blob), DecodeOptions()).fastq_device(
        mesh=block_mesh(1))
    assert dev == host == data


def test_regular_render_fasta_masked_on_gpu(gpu):
    """One chromosome-like masked record: unpack + mask parity + layout."""
    from naf_tpu.parallel import decode as DV
    from naf_tpu.parallel.mesh import block_mesh
    from naf_tpu.pipeline.decoder import Decoder, DecodeOptions
    from naf_tpu.pipeline.encoder import EncodeOptions, encode

    rng = np.random.default_rng(11)
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=3_000_001)
    for s in rng.integers(0, 2_990_000, size=300):
        seq[s:s + 5000] |= 32
    data = b">chrM x\n" + b"\n".join(
        seq[j:j + 60].tobytes() for j in range(0, seq.size, 60)) + b"\n"
    blob, _ = encode(data, EncodeOptions(level=1))
    d = Decoder(io.BytesIO(blob), DecodeOptions())
    plan, raw = d._fasta_plan(d.masking)
    assert DV.regular_session(plan, raw, None, mesh=block_mesh(1)) \
        is not None
    dev = Decoder(io.BytesIO(blob), DecodeOptions()).fasta_device(
        mesh=block_mesh(1))
    assert dev == data
