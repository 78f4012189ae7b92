"""Device-sharded decode (parallel/decode.py) vs the host decoder.

Byte-identity over the 8-virtual-device CPU mesh (see conftest), covering
masking, IUPAC codes, empty records, missing comments, RNA 'U' rendering,
protein/text raw streams, line-length overrides, and multi-batch rendering.
"""

import io

import numpy as np
import pytest

from naf_tpu.format import constants as C
from naf_tpu.parallel.mesh import block_mesh
from naf_tpu.pipeline.decoder import Decoder, DecodeOptions
from naf_tpu.pipeline.encoder import EncodeOptions, encode


def _mesh(n=8):
    return block_mesh(n)


def _fasta(rng, n_rec=30, max_len=400, alphabet=b"ACGTacgtNnRYKMbdhv-"):
    out = []
    for i in range(n_rec):
        if i % 5 == 1:
            out.append(b">empty%d\n" % i)          # empty record
            continue
        com = b" some comment" if i % 3 else b""
        out.append(b">rec%d%s\n" % (i, com))
        ln = int(rng.integers(1, max_len))
        seq = rng.choice(np.frombuffer(alphabet, np.uint8), size=ln).tobytes()
        for j in range(0, ln, 61):
            out.append(seq[j:j + 61] + b"\n")
    return b"".join(out)


def _fastq(rng, n_rec=50, max_len=150):
    out = []
    for i in range(n_rec):
        ln = int(rng.integers(1, max_len))
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=ln).tobytes()
        qual = rng.integers(33, 74, size=ln, dtype=np.uint8).tobytes()
        out.append(b"@read%d/%d\n%s\n+\n%s\n" % (i, i, seq, qual))
    return b"".join(out)


def _dec(blob, **opts):
    return Decoder(io.BytesIO(blob), DecodeOptions(**opts))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("no_mask", [False, True])
def test_fasta_device_matches_host(seed, no_mask):
    rng = np.random.default_rng(seed)
    data = _fasta(rng)
    blob, _ = encode(data, EncodeOptions(level=1, no_mask=no_mask))
    host = _dec(blob).fasta()
    dev = _dec(blob).fasta_device(mesh=_mesh())
    assert dev == host


def test_fasta_device_unmasked_and_line_length():
    rng = np.random.default_rng(2)
    data = _fasta(rng)
    blob, _ = encode(data, EncodeOptions(level=1))
    for ll in (None, 0, 7, 100):
        host = _dec(blob, line_length=ll).fasta()
        dev = _dec(blob, line_length=ll).fasta_device(mesh=_mesh())
        assert dev == host, f"line_length={ll}"
    # unmasked output
    host = _dec(blob).fasta(masking=False)
    dev = _dec(blob).fasta_device(masking=False, mesh=_mesh())
    assert dev == host


def test_fasta_device_multi_batch():
    """Tiny out_batch forces many batches with rebased indices."""
    rng = np.random.default_rng(3)
    data = _fasta(rng, n_rec=40)
    blob, _ = encode(data, EncodeOptions(level=1))
    host = _dec(blob).fasta()
    dev = _dec(blob).fasta_device(mesh=_mesh(), out_batch=1 << 10)
    assert dev == host


def test_fasta_device_single_giant_record():
    """One record much larger than a device chunk (sequence-parallel split)."""
    rng = np.random.default_rng(4)
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=200_000)
    lines = [seq[i:i + 80].tobytes() for i in range(0, seq.size, 80)]
    data = b">chr1 giant\n" + b"\n".join(lines) + b"\n"
    blob, _ = encode(data, EncodeOptions(level=1))
    host = _dec(blob).fasta()
    dev = _dec(blob).fasta_device(mesh=_mesh(), out_batch=1 << 15)
    assert dev == host


def test_fasta_device_rna():
    rng = np.random.default_rng(5)
    data = _fasta(rng, alphabet=b"ACGUacguNn")
    blob, _ = encode(data, EncodeOptions(level=1, seq_type=C.SEQ_TYPE_RNA))
    host = _dec(blob).fasta()
    dev = _dec(blob).fasta_device(mesh=_mesh())
    assert dev == host


@pytest.mark.parametrize("seq_type", [C.SEQ_TYPE_PROTEIN, C.SEQ_TYPE_TEXT])
@pytest.mark.parametrize("use_mask", [True, False])
def test_fasta_device_text_like(seq_type, use_mask):
    rng = np.random.default_rng(6)
    data = _fasta(rng, alphabet=b"ARNDCEQGHILKMFPSTWYVarndceqg")
    blob, _ = encode(data, EncodeOptions(level=1, seq_type=seq_type))
    host = _dec(blob, use_mask=use_mask).fasta()
    dev = _dec(blob, use_mask=use_mask).fasta_device(mesh=_mesh())
    assert dev == host


def test_fastq_device_matches_host():
    rng = np.random.default_rng(7)
    data = _fastq(rng)
    blob, _ = encode(data, EncodeOptions(level=1))
    host = _dec(blob).fastq()
    dev = _dec(blob).fastq_device(mesh=_mesh())
    assert dev == host
    # multi-batch
    dev2 = _dec(blob).fastq_device(mesh=_mesh(), out_batch=1 << 10)
    assert dev2 == host


def test_fastq_device_empty_reads():
    """Zero-length records (foreign archives; the reference parser rejects
    them on encode, but the decoder must handle such archives)."""
    from naf_tpu.format import constants as CC
    from naf_tpu.pipeline.encoder import EncodeStats, build_archive
    from naf_tpu.pipeline.parser import ParseResult

    res = ParseResult(
        n_sequences=3,
        ids_blob=b"a\0b\0c\0", comments_blob=b"x\0\0\0",
        seq=np.frombuffer(b"ACGTGG", np.uint8),
        qual=np.frombuffer(b"!!!!##", np.uint8),
        lengths=np.asarray([4, 0, 2], np.uint64), longest_line=4)
    stats = EncodeStats(n_sequences=3, longest_line=4, seq_size_original=6,
                        unexpected_id=np.zeros(257, np.uint64),
                        unexpected_comment=np.zeros(257, np.uint64),
                        unexpected_seq=np.zeros(257, np.uint64),
                        unexpected_qual=np.zeros(257, np.uint64),
                        in_format=CC.IN_FORMAT_FASTQ)
    blob, _ = build_archive(res, EncodeOptions(level=1, no_mask=True), stats)
    host = _dec(blob).fastq()
    dev = _dec(blob).fastq_device(mesh=_mesh())
    assert dev == host
    assert b"@b\n\n+\n\n" in host


def _alphabet_fasta() -> bytes:
    """Every byte value but LF in ids, comments and sequence lines (every
    byte class: EOL and space classes, IUPAC codes in both cases, digits,
    controls, 8-bit), plus an empty record."""
    rng = np.random.default_rng(12)
    every = np.frombuffer(bytes(b for b in range(1, 256) if b != 10), np.uint8)
    rows = [b">id" + bytes(range(33, 127)) + b" comment\t"
            + bytes(range(128, 256)) + b"\n", b">empty\n"]
    for k in range(3):
        seq = rng.permutation(every).tobytes()
        rows.append(b">r%d c%d\n" % (k, k))
        rows += [b"A" + seq[j:j + 59] + b"\n" for j in range(0, len(seq), 59)]
    rows.append(b">tail\nACGTRYKMSWBDHVNacgtrykmswbdhvn-\n")
    return b"".join(rows)


def test_device_decode_alphabet_fixture():
    """An every-byte-class FASTA round-trips identically through the host
    and device renders."""
    data = _alphabet_fasta()
    for seq_type in (C.SEQ_TYPE_DNA, C.SEQ_TYPE_TEXT):
        blob, _ = encode(data, EncodeOptions(level=1, seq_type=seq_type))
        host = _dec(blob).fasta()
        dev = _dec(blob).fasta_device(mesh=_mesh())
        assert dev == host, f"seq_type={seq_type}"


def test_untnaf_device_cli(tmp_path, capsysbinary):
    from naf_tpu.cli import untnaf as U

    rng = np.random.default_rng(8)
    data = _fasta(rng, n_rec=12)
    blob, _ = encode(data, EncodeOptions(level=1))
    p = tmp_path / "x.naf"
    p.write_bytes(blob)
    host = _dec(blob).fasta()
    rc = U.main(["--fasta", "--device", "-c", str(p)])
    assert rc == 0
    assert capsysbinary.readouterr().out == host


def test_render_overflow_guard_giant_record():
    """A record whose span exceeds the int32-rebased batch window must raise
    RenderOverflow (callers then fall back to the host renderer) instead of
    silently wrapping in int32 and emitting garbage."""
    from naf_tpu.parallel import decode as DV

    # metadata-only plan: one fake 3 GB record (no big allocations happen —
    # the guard fires before any device buffers are built)
    slens = np.asarray([100, 3 << 30, 50], np.int64)
    plan = DV.build_plan(
        mode=DV.MODE_FASTA, line_len=80, rna=False, packed=True, upper=False,
        slens=slens, ids_blob=b"a\0b\0c\0", comments_blob=None,
        name_sep=b" ", mask_spans=None)
    with pytest.raises(DV.RenderOverflow):
        DV.render_sharded(plan, np.zeros(8, np.uint8), None, mesh=_mesh())


def test_fasta_device_giant_record_falls_back(monkeypatch):
    """fasta_device returns host-identical bytes when render_sharded refuses
    (fault-path equivalence without allocating gigabytes: force the raise)."""
    from naf_tpu.parallel import decode as DV

    rng = np.random.default_rng(11)
    blob, _ = encode(_fasta(rng, n_rec=6), EncodeOptions(level=1))
    host = _dec(blob).fasta()

    def boom(*a, **k):
        raise DV.RenderOverflow("forced")

    monkeypatch.setattr(DV, "render_sharded", boom)
    assert _dec(blob).fasta_device(mesh=_mesh()) == host


def test_render_kernel_matches_reference_formulation():
    """The gather-minimal kernel is elementwise-identical to the reference
    per-byte-gather formulation across modes/wraps/masking."""
    import jax.numpy as jnp

    from naf_tpu.parallel import decode as D

    rng = np.random.default_rng(5)
    for trial in range(6):
        mode = D.MODE_FASTQ if trial % 3 == 2 else D.MODE_FASTA
        L = [0, 60, 7][trial % 3] if mode == D.MODE_FASTA else 0
        n_rec = int(rng.integers(1, 12))
        slens = rng.integers(0 if mode == D.MODE_FASTA else 1, 200,
                             n_rec).astype(np.int64)
        hls = rng.integers(2, 30, n_rec).astype(np.int64)
        if mode == D.MODE_FASTQ:
            outs = hls + 2 * slens + 4
        elif L > 0:
            outs = hls + slens + (slens + L - 1) // L + (slens > 0)
            outs = hls + slens + np.maximum((slens + L - 1) // L, 1)
        else:
            outs = hls + slens + 1
        E = np.cumsum(slens).astype(np.int32)
        O = np.cumsum(outs).astype(np.int32)
        H = np.cumsum(hls).astype(np.int32)
        hdr = rng.integers(65, 90, int(H[-1]), dtype=np.uint8)
        total_chars = int(E[-1])
        seq = rng.integers(0, 256, max(total_chars // 2 + 1, 1),
                           dtype=np.uint8)
        qual = rng.integers(33, 74, max(total_chars, 1), dtype=np.uint8)
        masking = mode == D.MODE_FASTA and trial % 2 == 0
        if masking:
            nb = int(rng.integers(1, 6)) * 2
            bounds = np.sort(rng.integers(0, max(total_chars, 1), nb)
                             ).astype(np.int32)
        else:
            bounds = np.full(2, 1 << 30, np.int32)
        Osz = int(O[-1])
        args = (jnp.asarray(seq), jnp.asarray(qual),
                jnp.asarray([0, 0, 0, 0], np.int32),
                jnp.asarray(E), jnp.asarray(O), jnp.asarray(H),
                jnp.asarray(hdr), jnp.asarray(bounds))
        new = D._make_kernel(Osz, mode, L, False, True, False,
                             masking)(*args)
        ref = D._make_kernel_ref(Osz, mode, L, False, True, False,
                                 masking)(*args)
        assert np.array_equal(np.asarray(new), np.asarray(ref)), (
            trial, mode, L, int((np.asarray(new) != np.asarray(ref)).sum()))
