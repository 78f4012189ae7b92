"""Multi-device block pipeline tests (8 virtual CPU devices, see conftest)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from naf_tpu.format import constants as C
from naf_tpu.ops import scan as S
from naf_tpu.parallel.block import make_blocks, make_blocks_fastq
from naf_tpu.parallel.mesh import block_mesh
from naf_tpu.parallel.pipeline import encode_sharded
from naf_tpu.pipeline import parser as P_
from naf_tpu.pipeline.decoder import Decoder, DecodeOptions
from naf_tpu.pipeline.encoder import EncodeOptions, encode


def _fasta(rng, n_rec=40, max_len=500):
    out = []
    for i in range(n_rec):
        out.append(b">rec%d some comment %d\n" % (i, i))
        ln = int(rng.integers(0, max_len))
        seq = rng.choice(np.frombuffer(b"ACGTacgtNn-", np.uint8), size=ln).tobytes()
        for j in range(0, ln, 70):
            out.append(seq[j:j + 70] + b"\n")
    return b"".join(out)


def _fastq(rng, n_rec=60, max_len=120):
    out = []
    for i in range(n_rec):
        ln = int(rng.integers(1, max_len))
        seq = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), size=ln).tobytes()
        qual = rng.integers(33, 74, size=ln, dtype=np.uint8).tobytes()
        com = b" c%d" % i if i % 3 else b""
        out.append(b"@read%d%s\n%s\n+\n%s\n" % (i, com, seq, qual))
    return b"".join(out)


def test_scan_block_matches_host_parser():
    rng = np.random.default_rng(0)
    data = _fasta(rng)
    host = P_.parse_fasta(data, C.SEQ_TYPE_DNA)
    body = np.frombuffer(data, np.uint8)[1:]   # after first '>'
    s = S.scan_fasta_block(jnp.asarray(body), jnp.asarray(np.uint8(ord(">"))))
    stream = np.asarray(s["stream_val"])[np.asarray(s["stream_keep"])]
    assert stream.tobytes() == host.seq.tobytes()
    assert int(np.asarray(s["rec_start"]).sum()) + 1 == host.n_sequences
    longest = int(S.longest_line_block(s["seq_keep"], s["is_eol"]))
    assert longest == host.longest_line


def test_scan_fastq_block_matches_host_parser():
    rng = np.random.default_rng(9)
    data = _fastq(rng, n_rec=25)
    host = P_.parse_fastq(data, C.SEQ_TYPE_DNA)
    body = np.frombuffer(data, np.uint8)[1:]   # after first '@'
    s = S.scan_fastq_block(jnp.asarray(body), jnp.asarray(np.uint8(ord("@"))))
    stream = np.asarray(s["stream_val"])[np.asarray(s["stream_keep"])]
    assert stream.tobytes() == host.seq.tobytes()
    qual = np.asarray(s["qual_val"])[np.asarray(s["qual_keep"])]
    assert qual.tobytes() == host.qual.tobytes()
    assert int(np.asarray(s["rec_start"]).sum()) + 1 == host.n_sequences


@pytest.mark.parametrize("n_rec", [1, 7, 40])
def test_sharded_encode_matches_host(n_rec):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    rng = np.random.default_rng(n_rec)
    data = _fasta(rng, n_rec=n_rec)
    host_blob, host_stats = encode(data, EncodeOptions(level=1))
    dev_blob, dev_stats = encode_sharded(data, EncodeOptions(level=1),
                                         mesh=block_mesh(8))
    assert dev_blob == host_blob
    assert dev_stats.n_sequences == host_stats.n_sequences
    assert dev_stats.longest_line == host_stats.longest_line


def test_sharded_encode_giant_record_spans_blocks():
    """Sequence parallelism: one record cut at line starts across devices."""
    rng = np.random.default_rng(42)
    seq = rng.choice(np.frombuffer(b"ACGTacgtNn", np.uint8), size=120_000)
    lines = [seq[i:i + 61].tobytes() for i in range(0, seq.size, 61)]
    data = b">chr1 giant\n" + b"\n".join(lines) + b"\n"
    host_blob, _ = encode(data, EncodeOptions(level=1))
    dev_blob, _ = encode_sharded(data, EncodeOptions(level=1),
                                 mesh=block_mesh(8))
    assert dev_blob == host_blob
    # the blocks really did split the record
    body = np.frombuffer(data, np.uint8)[1:]
    blocks = make_blocks(body, 8)
    assert blocks.starts_in_seq[1:].all()


def test_sharded_encode_fastq_matches_host():
    rng = np.random.default_rng(3)
    data = _fastq(rng, n_rec=80)
    for no_mask in (False, True):
        opts = EncodeOptions(level=1, no_mask=no_mask)
        host_blob, host_stats = encode(data, opts)
        dev_blob, dev_stats = encode_sharded(data, opts, mesh=block_mesh(8))
        assert dev_blob == host_blob
        assert dev_stats.n_sequences == host_stats.n_sequences
    # FASTQ decode intentionally loses lowercase masking (unnaf.c:443)
    out = Decoder(io.BytesIO(dev_blob), DecodeOptions()).fastq()
    assert out.upper() == data.upper()


def test_sharded_encode_unexpected_chars_match():
    """Replacement + histogram parity (device hists are u32 hi/lo psums)."""
    data = (b">r1 ok\nACGT@home\nACGT\n"
            b">r2\nNNNN!!\nacgt\n" * 5)
    host_blob, host_stats = encode(data, EncodeOptions(level=1))
    dev_blob, dev_stats = encode_sharded(data, EncodeOptions(level=1),
                                         mesh=block_mesh(8))
    assert dev_blob == host_blob
    assert np.array_equal(dev_stats.unexpected_seq, host_stats.unexpected_seq)


def test_make_blocks_line_aligned():
    rng = np.random.default_rng(5)
    data = _fasta(rng, n_rec=20)
    body = np.frombuffer(data, np.uint8)[1:]
    blocks = make_blocks(body, 8)
    assert blocks.data.shape[0] == 8
    assert blocks.prev[0] == ord(">")
    # every later block's prev byte is an EOL (cut at a line start)
    assert all(C.IS_EOL[p] for p in blocks.prev[1:])


def test_make_blocks_fastq_grid_detection():
    rng = np.random.default_rng(6)
    good = _fastq(rng, n_rec=16)
    body = np.frombuffer(good, np.uint8)[1:]
    mb = make_blocks_fastq(body, 4)
    assert mb is not None
    _, n_rec = mb
    assert n_rec == 16
    # irregular: an empty line
    bad = good + b"\n"
    assert make_blocks_fastq(np.frombuffer(bad, np.uint8)[1:], 4) is None


def test_fastq_mismatch_falls_back_to_host_error():
    data = b"@a\nACGT\n+\n!!!\n"     # qual len 3 != seq len 4
    with pytest.raises(P_.InputError, match="quality length"):
        encode_sharded(data, EncodeOptions(level=1), mesh=block_mesh(4))


def test_encode_sharded_decodes_with_reference(ref_bin):
    from naf_tpu.parallel.mesh import block_mesh

    rng = np.random.default_rng(5)
    data = _fasta(rng, n_rec=25, max_len=300)
    blob, _ = encode_sharded(data, mesh=block_mesh(4))
    from conftest import run_ref
    q = run_ref([ref_bin["unnaf"], "-c"], blob)
    assert q.returncode == 0
    ours = Decoder(io.BytesIO(blob), DecodeOptions()).fasta()
    assert q.stdout == ours


def test_encode_sharded_fastq_decodes_with_reference(ref_bin):
    rng = np.random.default_rng(8)
    data = _fastq(rng, n_rec=30)
    blob, _ = encode_sharded(data, mesh=block_mesh(4))
    from conftest import run_ref
    q = run_ref([ref_bin["unnaf"], "-c"], blob)
    assert q.returncode == 0
    # FASTQ decode loses lowercase masking in both implementations
    ours = Decoder(io.BytesIO(blob), DecodeOptions()).fastq()
    assert q.stdout == ours


def test_pass2_transfer_is_payload_shaped():
    """Device->host traffic ~ payload bytes, not per-input-byte metadata.

    Uses realistic soft-masking (runs, like genomes) — per-char random case
    would make the mask RLE itself payload-sized, which pass 2 ships as i32
    runs (4x the eventual u8 units but still O(runs), never O(bytes)).
    """
    rng = np.random.default_rng(11)
    out = []
    for i in range(64):
        ln = int(rng.integers(500, 4000))
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=ln)
        for s in rng.integers(0, max(1, ln - 200), size=max(1, ln // 1000)):
            seq[s:s + 200] |= 32          # soft-mask runs
        body = seq.tobytes()
        lines = [body[j:j + 70] for j in range(0, ln, 70)]
        out.append(b">rec%d c\n" % i + b"\n".join(lines) + b"\n")
    data = b"".join(out)
    body_n = len(data) - 1
    from naf_tpu.parallel import pipeline as PL

    # reproduce the caps encode_sharded would choose
    import naf_tpu.parallel.block as B
    mesh = block_mesh(8)
    blocks = B.make_blocks(np.frombuffer(data, np.uint8)[1:], 8)
    import jax as _jax
    from naf_tpu.parallel.mesh import block_sharding
    sh = block_sharding(mesh)
    st = B.stats_blocks_sharded(
        _jax.device_put(jnp.asarray(blocks.data), sh),
        _jax.device_put(jnp.asarray(blocks.prev), sh),
        _jax.device_put(jnp.asarray(blocks.starts_in_seq), sh),
        seq_type=C.SEQ_TYPE_DNA, fastq=False, mesh=mesh)
    (counts, odd, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
     first_lower, longest) = [np.asarray(o) for o in st[:9]]
    caps = B.emit_caps(B.PassStats(counts, id_bytes, com_bytes, qual_bytes,
                                   n_rec, n_runs, first_lower, longest, []),
                       fastq=False, text_like=False)
    xfer = PL.device_to_host_bytes(8, caps)
    # v1 shipped >4 bytes per input byte; the packed payload alone is ~0.5
    assert xfer < 1.5 * body_n, (xfer, body_n)


# ---------------------------------------------------------------------------
# Device encode for protein/text/strict/well-formed (full input space)
# ---------------------------------------------------------------------------

def _typed_fasta(rng, seq_type, n_rec=20, max_len=600):
    alpha = {
        C.SEQ_TYPE_DNA: b"ACGTacgtNn",
        C.SEQ_TYPE_RNA: b"ACGUacguNn",
        C.SEQ_TYPE_PROTEIN: b"ACDEFGHIKLMNPQRSTVWYacdefghiklm*-",
        C.SEQ_TYPE_TEXT: b"abcXYZ019{}#>~%$",
    }[seq_type]
    rows = []
    for i in range(n_rec):
        com = b" com %d" % i if i % 2 else b""
        rows.append(b">s%d%s\n" % (i, com))
        seq = rng.choice(np.frombuffer(alpha, np.uint8),
                         size=int(rng.integers(1, max_len)))
        rows.append(seq.tobytes() + b"\n")
    return b"".join(rows)


@pytest.mark.parametrize("seq_type", [C.SEQ_TYPE_PROTEIN, C.SEQ_TYPE_TEXT])
def test_sharded_encode_protein_text(seq_type, monkeypatch):
    monkeypatch.setenv("NAF_TPU_NO_FALLBACK", "1")
    rng = np.random.default_rng(seq_type + 70)
    data = _typed_fasta(rng, seq_type)
    for no_mask in (False, True):
        opts = EncodeOptions(level=1, seq_type=seq_type, no_mask=no_mask)
        host_blob, host_stats = encode(data, opts)
        dev_blob, dev_stats = encode_sharded(data, opts, mesh=block_mesh(8))
        assert dev_blob == host_blob, (seq_type, no_mask)
        assert dev_stats.n_sequences == host_stats.n_sequences


def test_sharded_encode_strict_clean_stays_on_device(monkeypatch):
    monkeypatch.setenv("NAF_TPU_NO_FALLBACK", "1")
    rng = np.random.default_rng(3)
    data = _fasta(rng, n_rec=12, max_len=400)
    opts = EncodeOptions(level=1, strict=True)
    host_blob, _ = encode(data, opts)
    dev_blob, _ = encode_sharded(data, opts, mesh=block_mesh(8))
    assert dev_blob == host_blob


def test_sharded_encode_strict_dirty_raises_exact_error():
    from naf_tpu.pipeline.parser import InputError

    data = b">a\nACGTZGGG\nACGT\n>b\nTTTT\n"
    opts = EncodeOptions(level=1, strict=True)
    with pytest.raises(InputError) as e_dev:
        encode_sharded(data, opts, mesh=block_mesh(8))
    with pytest.raises(InputError) as e_host:
        encode(data, opts)
    assert str(e_dev.value) == str(e_host.value)


def test_sharded_encode_well_formed(monkeypatch):
    monkeypatch.setenv("NAF_TPU_NO_FALLBACK", "1")
    rng = np.random.default_rng(9)
    data = _fasta(rng, n_rec=15, max_len=500)
    opts = EncodeOptions(level=1, well_formed=True)
    host_blob, _ = encode(data, opts)
    dev_blob, _ = encode_sharded(data, opts, mesh=block_mesh(8))
    assert dev_blob == host_blob


def test_sharded_encode_well_formed_unsafe_falls_back():
    # TAB inside the id: wf keeps it verbatim, robust ends the id there —
    # the device gate must route this to the host wf parser
    data = b">a\tweird\nACGT\n>b x\nGGGG\n"
    opts = EncodeOptions(level=1, well_formed=True)
    host_blob, _ = encode(data, opts)
    dev_blob, _ = encode_sharded(data, opts, mesh=block_mesh(8))
    assert dev_blob == host_blob
    # space inside a sequence line likewise diverges
    data2 = b">a\nAC GT\n>b\nGGGG\n"
    h2, _ = encode(data2, EncodeOptions(level=1, well_formed=True))
    d2, _ = encode_sharded(data2, EncodeOptions(level=1, well_formed=True),
                           mesh=block_mesh(8))
    assert d2 == h2


@pytest.mark.parametrize("seq_type", [C.SEQ_TYPE_PROTEIN, C.SEQ_TYPE_TEXT])
def test_sharded_protein_text_decodes_with_reference(seq_type, ref_bin):
    from conftest import run_ref

    rng = np.random.default_rng(seq_type)
    data = _typed_fasta(rng, seq_type, n_rec=10)
    flag = b"--protein" if seq_type == C.SEQ_TYPE_PROTEIN else b"--text"
    blob, _ = encode_sharded(data, EncodeOptions(level=1, seq_type=seq_type),
                             mesh=block_mesh(4))
    q = run_ref([ref_bin["unnaf"], "-c"], blob)
    assert q.returncode == 0, q.stderr
    assert q.stdout == Decoder(io.BytesIO(blob), DecodeOptions()).fasta()


def test_sharded_encode_fastq_crlf_matches_reference_error():
    """The reference REJECTS CRLF FASTQ (CR is EOL-class: "can't find '+'
    line") — the device path must fall back and raise the same error."""
    from naf_tpu.pipeline.parser import InputError

    data = b"@r1\r\nACGT\r\n+\r\n!!!!\r\n"
    with pytest.raises(InputError, match="can't find"):
        encode(data, EncodeOptions(level=1))
    with pytest.raises(InputError, match="can't find"):
        encode_sharded(data, EncodeOptions(level=1), mesh=block_mesh(4))


def test_make_blocks_fastq_rejects_cr_and_rare_eol():
    from naf_tpu.parallel.block import make_blocks_fastq

    crlf = np.frombuffer(b"r\r\nAC\r\n+\r\n!!\r\n", np.uint8)
    assert make_blocks_fastq(crlf, 2) is None
    vt = np.frombuffer(b"r\x0bx\nAC\n+\n!!\n", np.uint8)
    assert make_blocks_fastq(vt, 2) is None


def test_pass_helpers_match_tuple_api():
    """stats_pass/emit_pass (the host helpers the in-memory and streaming
    encoders share) return exactly the tuple-API outputs that the
    multihost path consumes."""
    import jax

    from naf_tpu.parallel.block import (
        emit_blocks_sharded, emit_caps, emit_pass, make_blocks, stats_pass,
        stats_blocks_sharded, upload_blocks)
    from naf_tpu.parallel.mesh import block_sharding

    rng = np.random.default_rng(17)
    data = _fasta(rng, n_rec=20, max_len=400)
    body = np.frombuffer(data, np.uint8)[1:]
    mesh = block_mesh(4)
    blocks = make_blocks(body, 4)
    sharding = block_sharding(mesh)
    bd = jax.device_put(jnp.asarray(blocks.data), sharding)
    pd = jax.device_put(jnp.asarray(blocks.prev), sharding)
    sd = jax.device_put(jnp.asarray(blocks.starts_in_seq), sharding)

    st = stats_blocks_sharded(bd, pd, sd, seq_type=0, fastq=False, mesh=mesh)
    dev = upload_blocks(blocks, mesh)
    ps = stats_pass(dev, mesh=mesh, seq_type=0, fastq=False)
    for i, got in enumerate((ps.counts, None, ps.id_bytes, ps.com_bytes,
                             ps.qual_bytes, ps.n_rec, ps.n_runs,
                             ps.first_lower, ps.longest)):
        if got is not None:
            assert np.array_equal(got, np.asarray(st[i]).astype(got.dtype)), i
    for k in range(8):
        assert np.array_equal(ps.hists[k], np.asarray(st[9 + k])[:1]), k

    caps = emit_caps(ps, fastq=False, text_like=False)
    em = emit_blocks_sharded(bd, pd, sd, st[1], seq_type=0, fastq=False,
                             mesh=mesh, **caps)
    em2 = emit_pass(dev, ps, caps, mesh=mesh, seq_type=0, fastq=False)
    for i in range(11):
        a, b = np.asarray(em[i]), np.asarray(em2[i])
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), i
