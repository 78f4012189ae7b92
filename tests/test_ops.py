"""Unit tests for device ops: pack/unpack kernels, mask RLE, histograms."""

import numpy as np
import pytest

from naf_tpu.format import constants as C
from naf_tpu.ops.mask import (
    MaskEncoder, apply_mask_np, encode_run, expand_mask_np, mask_units_from_bytes,
    merge_units,
)
from naf_tpu.ops.pack import pack_4bit, pack_4bit_xla
from naf_tpu.ops.render import body_length, wrap_records_np
from naf_tpu.ops.unpack import unpack_4bit, unpack_4bit_xla

import jax.numpy as jnp


def ref_pack(seq: bytes) -> bytes:
    """Byte-at-a-time oracle for the 4-bit pack (encoders.c:30-69)."""
    codes = [int(C.NUC_CODE[c]) for c in seq]
    out = []
    for i in range(0, len(codes) - 1, 2):
        out.append(codes[i] | (codes[i + 1] << 4))
    if len(codes) % 2:
        out.append(codes[-1])
    return bytes(out)


def ref_unpack(packed: bytes, total: int, rna=False) -> bytes:
    lut = C.CODE_TO_NUC_RNA if rna else C.CODE_TO_NUC_DNA
    out = []
    for b in packed:
        out.append(lut[b & 15])
        out.append(lut[b >> 4])
    return bytes(out[:total])


@pytest.mark.parametrize("backend", ["xla", "numpy"])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 255, 256, 257, 1000, 4096])
def test_pack_xla_matches_oracle(n, backend):
    rng = np.random.default_rng(n)
    seq = rng.choice(np.frombuffer(b"ACGTNacgtn-RYKM", np.uint8), size=n)
    packed, carry = pack_4bit(seq, backend=backend)
    expect = ref_pack(seq.tobytes())
    if n % 2:
        assert carry == expect[-1]
        expect = expect[:-1]
    else:
        assert carry is None
    assert packed.tobytes() == expect


def test_pack_parity_carry_across_blocks():
    rng = np.random.default_rng(7)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=1001)
    # split at an odd boundary
    p1, c1 = pack_4bit(seq[:501], backend="xla")
    p2, c2 = pack_4bit(seq[501:], parity_nibble=c1, backend="xla")
    whole = ref_pack(seq.tobytes())
    got = p1.tobytes() + p2.tobytes()
    if c2 is not None:
        got += bytes([c2])
    assert got == whole


def test_pack_xla_every_byte_matches_numpy():
    """All 256 byte values (non-IUPAC bytes map to code 15)."""
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 256, size=2048, dtype=np.uint8)
    a = np.asarray(pack_4bit_xla(jnp.asarray(seq)))
    codes = C.NUC_CODE[:256][seq]
    assert np.array_equal(a, codes[0::2] | (codes[1::2] << 4))


@pytest.mark.parametrize("backend", ["xla", "numpy"])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 127, 128, 129, 1000])
@pytest.mark.parametrize("rna", [False, True])
def test_unpack_matches_oracle(n, rna, backend):
    rng = np.random.default_rng(n)
    packed = rng.integers(0, 256, size=n, dtype=np.uint8)
    total = 2 * n - (1 if n else 0)
    got = unpack_4bit(packed, total, rna=rna, backend=backend)
    assert got.tobytes() == ref_unpack(packed.tobytes(), total, rna)


@pytest.mark.parametrize("rna", [False, True])
def test_unpack_xla_every_byte_matches_numpy(rna):
    packed = np.arange(1024, dtype=np.uint32).astype(np.uint8)
    a = np.asarray(unpack_4bit_xla(jnp.asarray(packed), rna=rna))
    lut = C.CODES_TO_NUCS_RNA if rna else C.CODES_TO_NUCS_DNA
    assert np.array_equal(a, lut[packed].reshape(-1))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(11)
    seq = rng.choice(np.frombuffer(b"ACGTRYSWKMBDHVN-", np.uint8), size=999)
    packed, carry = pack_4bit(seq, backend="xla")
    stream = np.concatenate([packed, [carry]]).astype(np.uint8)
    got = unpack_4bit(stream, 999, backend="xla")
    assert np.array_equal(got, seq)   # uppercase canonical forms


# --- mask RLE ---------------------------------------------------------------

def ref_mask_units(seq: bytes) -> bytes:
    """Oracle for extract_mask/add_mask (encoders.c:98-146 + flush)."""
    units = []
    mask_on = False
    run = 0

    def emit(ln):
        while ln >= 255:
            units.append(255)
            ln -= 255
        units.append(ln)

    for c in seq:
        if (c >= 96) != mask_on:
            emit(run)
            run = 0
            mask_on = not mask_on
        run += 1
    if run > 0:
        emit(run)
    return bytes(units)


@pytest.mark.parametrize("seed", range(6))
def test_mask_units_match_oracle(seed):
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=rng.integers(0, 3000))
    assert mask_units_from_bytes(seq).tobytes() == ref_mask_units(seq.tobytes())


def test_mask_long_runs():
    seq = np.frombuffer(b"a" * 700 + b"A" * 300 + b"c" * 255, np.uint8)
    units = mask_units_from_bytes(seq)
    assert units.tobytes() == ref_mask_units(seq.tobytes())
    runs = merge_units(units)
    assert runs.tolist() == [0, 700, 300, 255]


def test_mask_streaming_blocks_equal_oneshot():
    rng = np.random.default_rng(42)
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=10000)
    enc = MaskEncoder()
    for i in range(0, 10000, 777):
        enc.update(seq[i:i + 777])
    assert enc.finish().tobytes() == mask_units_from_bytes(seq).tobytes()


def test_expand_mask_roundtrip():
    rng = np.random.default_rng(1)
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=4096)
    units = mask_units_from_bytes(seq)
    runs = merge_units(units)
    is_masked = expand_mask_np(runs, 4096)
    assert np.array_equal(is_masked, seq >= 96)
    upper = C.TOUPPER[seq]
    assert np.array_equal(apply_mask_np(upper, is_masked), seq)


def test_encode_run_exact_255():
    assert encode_run(255).tolist() == [255, 0]
    assert encode_run(254).tolist() == [254]
    assert encode_run(510).tolist() == [255, 255, 0]


# --- rendering ----------------------------------------------------------------

def test_wrap_records_basic():
    seq = np.frombuffer(b"AAAAABBBBBCC", np.uint8)
    out = wrap_records_np(seq, np.array([10, 2]), 5)
    assert out.tobytes() == b"AAAAA\nBBBBB\nCC\n"
    out0 = wrap_records_np(seq, np.array([10, 2]), 0)
    assert out0.tobytes() == b"AAAAABBBBB\nCC\n"


def test_wrap_exact_multiple_no_blank_line():
    seq = np.frombuffer(b"AAAAAAAAAA", np.uint8)
    out = wrap_records_np(seq, np.array([10]), 5)
    assert out.tobytes() == b"AAAAA\nAAAAA\n"


def test_wrap_empty_record():
    seq = np.frombuffer(b"AAA", np.uint8)
    out = wrap_records_np(seq, np.array([0, 3, 0]), 2)
    assert out.tobytes() == b"AA\nA\n"
    assert body_length(np.array([0, 3, 0]), 2).tolist() == [0, 5, 0]
