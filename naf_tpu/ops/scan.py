"""Device-side vectorized FASTA token scan.

The same array program as pipeline/parser.py (the host oracle), expressed in
jnp with static shapes so it jits and shards: record markers via a
prev-is-EOL test, region intervals via searchsorted over EOL/space positions
(using size=-bounded nonzero), per-byte classification via LUT gathers, and
compaction via cumsum + scatter.

This is the per-block data plane of the distributed pipeline
(naf_tpu/parallel/block.py): each device scans its own block (blocks are
split at record boundaries by the host reader), so no cross-device
communication is needed during the scan itself; only the tiny carry state
(nibble parity, mask-run, histograms) is exchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.jaxenv import setup_jax

setup_jax()   # persistent compile cache

from ..format import constants as C
from . import tables as T

_GT = ord(">")
_NEG = -(1 << 30)


def cumsum_i32(mask) -> jnp.ndarray:
    """Inclusive i32 prefix sum (of a boolean mask or an i32 vector)."""
    return jnp.cumsum(mask.astype(jnp.int32))


def maxscan_i32(v: jnp.ndarray) -> jnp.ndarray:
    """Inclusive i32 prefix max."""
    return jax.lax.cummax(v)


def _seg_start_bcast(rec_start, values, fallback):
    """Per byte: ``values`` at its record's marker; ``fallback`` before the
    first marker.  Works because marker values here (positions, prefix
    counts) are non-decreasing, so a masked max-scan picks the last one."""
    m = maxscan_i32(jnp.where(rec_start, values, _NEG))
    return jnp.where(m == _NEG, fallback, m)


def _hist_cond(mask, b):
    """i32[256] histogram of bytes ``b`` where ``mask`` — guarded by a cond
    so the overwhelmingly common clean case (no unexpected chars) skips the
    scatter-add entirely."""
    def compute(_):
        return jnp.zeros(256, jnp.int32).at[
            jnp.where(mask, b.astype(jnp.int32), 256)
        ].add(1, mode="drop")
    # the zero branch must match the compute branch's sharding variance
    # under shard_map: derive it from (varying) data at no cost
    zero = (b[:1].astype(jnp.int32) & 0) + jnp.zeros(256, jnp.int32)
    return jax.lax.cond(jnp.any(mask), compute, lambda _: zero, 0)


def _lut_bool(b: jnp.ndarray, tab) -> jnp.ndarray:
    """Boolean 256-entry LUT applied to bytes ``b``."""
    return jnp.take(jnp.asarray(tab, bool), b.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("seq_type",))
def scan_fasta_block(block: jnp.ndarray, prev_byte: jnp.ndarray,
                     seq_type: int = C.SEQ_TYPE_DNA,
                     starts_in_seq=False) -> dict:
    """Classify every byte of a FASTA block (bytes after any leading '>').

    block: u8[B]; prev_byte: u8[] — the byte preceding the block ('>' for the
    very first block, since scan starts right after the first marker).
    starts_in_seq: traced bool — bytes before the block's first '>' marker
    are sequence data (the block was cut at a line boundary inside a record,
    the sequence-parallel case) instead of record-0 header bytes.

    Returns per-byte arrays (all length B):
      rec_start  bool  — '>' markers starting a new record
      region     i32   — 0 none/marker, 1 id, 2 comment, 3 sequence
      stream_keep bool — byte contributes to the sequence stream
      stream_val u8    — its value (after replacement)
      seq_keep   bool  — byte counted in its record's length
      is_eol     bool
      id_keep/id_unex/com_keep/com_unex bool — header classification
    plus 'hist_id', 'hist_comment', 'hist_seq' i32[256] unexpected counts.
    """
    B = block.shape[0]
    b = block
    is_eol = _lut_bool(b, T.IS_EOL)
    is_space = _lut_bool(b, T.IS_SPACE)

    prev_is_eol = jnp.concatenate(
        [jnp.asarray(T.IS_EOL)[prev_byte.astype(jnp.int32)].reshape(1), is_eol[:-1]]
    )
    rec_start = (b == _GT) & prev_is_eol

    pos = jnp.arange(B, dtype=jnp.int32)

    # record id per byte (marker byte belongs to the record it starts)
    rec_id = cumsum_i32(rec_start)
    cum_eol = cumsum_i32(is_eol)
    cum_sp = cumsum_i32(is_space)

    # for each byte, the position of its record's marker ('-1' for record 0)
    # and the prefix counts AT that marker (segment broadcasts); record 0
    # behaves as if its marker sat just before byte 0
    rec_marker = _seg_start_bcast(rec_start, pos, -1)
    eol_at_m = _seg_start_bcast(rec_start, cum_eol, 0)
    sp_at_m = _seg_start_bcast(rec_start, cum_sp, 0)

    # region logic by counts: a byte is on its record's header line iff no
    # EOL lies strictly between the marker and it; in the id until the first
    # space-class byte after the marker (IS_SPACE contains IS_EOL, so the
    # id always ends within the header line); in the comment after it
    i32 = jnp.int32
    cnt_eol_excl = cum_eol - is_eol.astype(i32) - eol_at_m  # EOLs in (m, i)
    cnt_sp_excl = cum_sp - is_space.astype(i32) - sp_at_m   # spaces in (m, i)
    in_header_line = cnt_eol_excl == 0
    after_marker = pos > rec_marker
    in_id = in_header_line & after_marker & (cnt_sp_excl == 0) & ~is_space
    in_comment = in_header_line & after_marker & (cnt_sp_excl >= 1) & ~is_eol
    in_seq = ~in_header_line
    # sequence-parallel cut: bytes before the first in-block marker belong to
    # the previous block's open record's sequence, not to a record-0 header
    pre = (rec_marker < 0) & jnp.asarray(starts_in_seq)
    in_id = in_id & ~pre
    in_comment = in_comment & ~pre
    in_seq = in_seq | pre
    region = jnp.where(in_id, 1, jnp.where(in_comment, 2, jnp.where(in_seq, 3, 0)))
    region = jnp.where(rec_start, 0, region)

    unex_text = _lut_bool(b, T.IS_UNEXPECTED_TEXT)
    unex_com = _lut_bool(b, T.IS_UNEXPECTED_COMMENT)
    unex_seq_b = _lut_bool(b, T.UNEXPECTED_BY_TYPE[seq_type])
    if seq_type == C.SEQ_TYPE_TEXT:
        keep_gt = b == _GT
        unex_seq_b = unex_seq_b & ~keep_gt
    else:
        unex_seq_b = unex_seq_b

    id_unex = in_id & unex_text
    id_keep = in_id & ~unex_text
    com_unex = in_comment & unex_com
    com_keep = in_comment

    seq_keep = in_seq & ~is_space
    seq_unex = seq_keep & unex_seq_b
    repl = jnp.uint8(C.REPLACEMENT_SEQ[seq_type])
    seq_val = jnp.where(seq_unex, repl, b)

    stream_keep = seq_keep | id_unex
    stream_val = jnp.where(id_unex, jnp.uint8(C.REPLACEMENT_NAME), seq_val)

    def hist(mask):
        return _hist_cond(mask, b)

    return dict(
        rec_start=rec_start,
        rec_id=rec_id,
        region=region,
        stream_keep=stream_keep,
        stream_val=stream_val,
        seq_keep=seq_keep,
        is_eol=is_eol,
        id_keep=id_keep,
        id_unex=id_unex,
        com_keep=com_keep,
        com_unex=com_unex,
        com_val=jnp.where(com_unex, jnp.uint8(C.REPLACEMENT_NAME), b),
        hist_id=hist(id_unex),
        hist_comment=hist(com_unex),
        hist_seq=hist(seq_unex),
    )


@functools.partial(jax.jit, static_argnames=("seq_type",))
def scan_fastq_block(block: jnp.ndarray, prev_byte: jnp.ndarray,
                     seq_type: int = C.SEQ_TYPE_DNA) -> dict:
    """Classify every byte of a regular-grid FASTQ block.

    Preconditions (validated by the host reader, parallel/block.py
    make_blocks_fastq): LF-only line ends, non-empty lines, strict 4-line
    records ('@header', seq, '+', qual), blocks cut at record starts, '\\n'
    padding.  block: u8[B]; prev_byte: u8[] ('@' for the very first block —
    its record-0 header starts at byte 0 with the marker stripped; an EOL
    otherwise).

    Parity target: the robust FASTQ parser (ennaf/src/process.c:477-544 and
    pipeline/parser.py _parse_fastq_lines): id to first space-class byte,
    comment to EOL, spaces dropped from seq/qual, unexpected chars replaced
    (seq by type table, qual by '!'), the FIRST byte of each quality line
    kept verbatim, unexpected id chars inject '?' into the sequence stream.
    """
    B = block.shape[0]
    b = block
    is_eol = b == jnp.uint8(ord("\n"))
    is_space = _lut_bool(b, T.IS_SPACE)

    prev_is_eol = jnp.concatenate(
        [jnp.asarray(T.IS_EOL)[prev_byte.astype(jnp.int32)].reshape(1),
         is_eol[:-1]]
    )
    cum_eol = cumsum_i32(is_eol)
    # byte's own line index (EOL byte belongs to the line it terminates)
    line_id = cum_eol - is_eol.astype(jnp.int32)
    lane = line_id % 4          # 0 header, 1 seq, 2 '+', 3 qual

    rec_start = (b == jnp.uint8(ord("@"))) & prev_is_eol & (lane == 0)

    pos = jnp.arange(B, dtype=jnp.int32)
    cum_sp = cumsum_i32(is_space)
    rec_marker = _seg_start_bcast(rec_start, pos, -1)
    eol_at_m = _seg_start_bcast(rec_start, cum_eol, 0)
    sp_at_m = _seg_start_bcast(rec_start, cum_sp, 0)

    # count-based header-line intervals (same scheme as the FASTA scan)
    i32 = jnp.int32
    cnt_eol_excl = cum_eol - is_eol.astype(i32) - eol_at_m
    cnt_sp_excl = cum_sp - is_space.astype(i32) - sp_at_m
    in_header_line = cnt_eol_excl == 0
    after_marker = pos > rec_marker

    # header membership excludes the whole EOL class: a CR in a CRLF grid
    # ends the comment exactly like the host parser (lane math stays on LF
    # alone, so the CR never advances the 4-line cycle)
    is_eolc = _lut_bool(b, T.IS_EOL)
    in_hdr = (lane == 0) & ~rec_start & ~is_eolc
    in_id = (in_hdr & in_header_line & after_marker
             & (cnt_sp_excl == 0) & ~is_space)
    in_comment = in_hdr & in_header_line & after_marker & (cnt_sp_excl >= 1)

    unex_text = _lut_bool(b, T.IS_UNEXPECTED_TEXT)
    unex_com = _lut_bool(b, T.IS_UNEXPECTED_COMMENT)
    unex_seq_b = _lut_bool(b, T.UNEXPECTED_BY_TYPE[seq_type])
    unex_qual_b = _lut_bool(b, T.IS_UNEXPECTED_QUAL)

    id_unex = in_id & unex_text
    id_keep = in_id & ~unex_text
    com_unex = in_comment & unex_com
    com_keep = in_comment

    in_seq = (lane == 1) & ~is_eol
    seq_keep = in_seq & ~is_space
    seq_unex = seq_keep & unex_seq_b
    repl = jnp.uint8(C.REPLACEMENT_SEQ[seq_type])
    seq_val = jnp.where(seq_unex, repl, b)

    qual_first = (lane == 3) & prev_is_eol & ~is_eol
    qual_rest = (lane == 3) & ~is_eol & ~qual_first
    qual_unex = qual_rest & ~is_space & unex_qual_b
    qual_keep = (qual_rest & ~is_space) | qual_first
    qual_val = jnp.where(qual_unex, jnp.uint8(C.REPLACEMENT_QUAL), b)

    stream_keep = seq_keep | id_unex
    stream_val = jnp.where(id_unex, jnp.uint8(C.REPLACEMENT_NAME), seq_val)

    def hist(mask):
        return _hist_cond(mask, b)

    return dict(
        rec_start=rec_start,
        stream_keep=stream_keep,
        stream_val=stream_val,
        seq_keep=seq_keep,
        is_eol=is_eol,
        id_keep=id_keep,
        id_unex=id_unex,
        com_keep=com_keep,
        com_unex=com_unex,
        com_val=jnp.where(com_unex, jnp.uint8(C.REPLACEMENT_NAME), b),
        qual_keep=qual_keep,
        qual_unex=qual_unex,
        qual_val=qual_val,
        hist_id=hist(id_unex),
        hist_comment=hist(com_unex),
        hist_seq=hist(seq_unex),
        hist_qual=hist(qual_unex),
    )


@jax.jit
def compact(mask: jnp.ndarray, values: jnp.ndarray):
    """Stable compaction: kept values move to the front; returns (out, count).

    out has the same (static) length as values; positions >= count are zero.
    A prefix count gives each kept value its output index; dropped
    positions, zeroed, fill [count, B) in order.  The scatter is thus a
    permutation: every index is in range and unique.
    """
    B = values.shape[0]
    cum = cumsum_i32(mask)
    cnt = cum[-1] if B else jnp.int32(0)
    out_idx = jnp.where(mask, cum - 1,
                        cnt + jnp.arange(B, dtype=jnp.int32) - cum)
    out = jnp.zeros_like(values).at[out_idx].set(
        jnp.where(mask, values, jnp.zeros_like(values)),
        mode="promise_in_bounds", unique_indices=True)
    return out, cnt


@jax.jit
def pack_even(seq_padded: jnp.ndarray) -> jnp.ndarray:
    """Pack a compacted (padded) char block at even alignment: u8[B] -> u8[B/2].

    Boundary nibbles across blocks are fixed up by the caller using the
    per-block counts (see parallel/block.py).
    """
    codes = jnp.take(T.NUC_CODE, seq_padded.astype(jnp.int32))
    return codes[0::2] | (codes[1::2] << 4)


@jax.jit
def longest_line_block(seq_keep: jnp.ndarray, is_eol: jnp.ndarray) -> jnp.ndarray:
    """Max kept-chars between EOLs within the block (line-length reduce).

    Scan formulation: kept-count at each EOL minus kept-count at the
    previous EOL, plus the trailing open line.
    """
    B = seq_keep.shape[0]
    if B == 0:
        return jnp.int32(0)
    cum = cumsum_i32(seq_keep)                   # inclusive kept count
    A = maxscan_i32(jnp.where(is_eol, cum, _NEG))   # cum @ last EOL
    Aprev = jnp.concatenate([jnp.full((1,), _NEG, jnp.int32), A[:-1]])
    base = jnp.where(Aprev == _NEG, 0, Aprev)
    line_at_eol = jnp.where(is_eol, cum - base, 0)
    tail = cum[-1] - jnp.where(A[-1] == _NEG, 0, A[-1])
    return jnp.maximum(jnp.max(line_at_eol), tail)
