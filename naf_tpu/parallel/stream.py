"""Chunked (bounded-memory) device encode: the sharded pipeline as a
streaming scan engine.

``DeviceScanEngine.scan`` speaks the exact carry protocol of ``native.scan``
(the feed loop in pipeline/stream.py): pack-carry nibble, mask_on/mask_run
RLE tail, length/line carries, F_CONT_SEQ / F_ALLOW_PARTIAL semantics.
``encode_stream(..., engine=DeviceScanEngine())`` therefore produces archives
byte-identical to the host path while every chunk's per-byte work (classify,
compact, pack, mask RLE) runs on the device mesh; awkward pieces (protein/
text modes, mid-line resumes, irregular FASTQ grids, quality-length errors)
silently delegate to the native scanner piece by piece — both engines share
the same associative carry algebra, so they interleave freely within one
stream.

This closes the "``tnaf --device`` reads the whole input into RAM" gap: the
device path now encodes arbitrarily large inputs at O(chunk) host memory,
matching the reference's streaming envelope (ennaf/src/process.c:430-544,
1 MB parse buffers) while keeping the payload-shaped device traffic of
parallel/block.py (compacted payloads only).

Shape discipline: chunk columns and emit capacities are sticky
(monotonically growing power-of-two buckets per engine instance), so a long
stream compiles the stats/emit programs a handful of times, not per chunk.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import native
from ..format import constants as C
from ..ops.mask import runs_to_units
from .block import (
    _bucket, blob_from_lens, emit_caps, emit_pass, make_blocks,
    make_blocks_fastq, stats_pass, stitch_lengths, stitch_runs,
    upload_blocks,
)

_GT = ord(">")
_AT = ord("@")
_LF = ord("\n")


def _merge_hist(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """u32 (lo16, hi16) psum halves -> u64[257] histogram."""
    h = np.zeros(257, np.uint64)
    h[:256] = (hi.astype(np.uint64) << 16) + lo.astype(np.uint64)
    return h


class _Chars:
    """Size-only stand-in for NativeScan.seq (the device path never needs
    the expanded char stream on host — only its length)."""

    __slots__ = ("size",)

    def __init__(self, n: int):
        self.size = n


def _stitch_packed_stream(packed_rows: np.ndarray, counts: np.ndarray,
                          first_codes: np.ndarray,
                          pack_carry: Optional[int]) -> np.ndarray:
    """Per-block even-aligned payloads -> chunk nibble stream with carry.

    Same boundary algebra as block.stitch_packed, but the stream starts at
    the global parity implied by ``pack_carry`` (a pending low nibble means
    the global char count so far is odd) and a trailing half byte is emitted
    as a final byte — the feed loop (pipeline/stream.py feed_common) strips
    it back off via its own parity count, exactly as it does for
    ``native.scan``'s packed output.
    """
    pieces: list[np.ndarray] = []
    parity = 1 if pack_carry is not None else 0
    pending = pack_carry
    for d in range(counts.shape[0]):
        cnt = int(counts[d])
        if cnt == 0:
            continue
        if parity % 2 == 1:
            pieces.append(np.asarray(
                [pending | (int(first_codes[d]) << 4)], dtype=np.uint8))
            pending = None
            packed_chars = cnt - 1
        else:
            packed_chars = cnt
        nbytes = packed_chars // 2
        pieces.append(np.ascontiguousarray(packed_rows[d][:nbytes]))
        if packed_chars % 2:
            pending = int(packed_rows[d][nbytes]) & 0x0F
        parity += cnt
    if pending is not None:
        pieces.append(np.asarray([pending], dtype=np.uint8))
    if not pieces:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(pieces)


def _merge_mask(runs: np.ndarray, state_first: bool, mask_on: bool,
                mask_run: int) -> tuple[np.ndarray, bool, int]:
    """Chunk mask runs + carried open run -> (completed units, new tail).

    Mirrors the native scanner's F_NO_MASK_FLUSH contract (and
    ops.mask.MaskEncoder): the carried run merges with the chunk's first run
    when cases agree, otherwise it completes (a 0-length completion at
    stream start yields the reference's leading-0 unit,
    ennaf/src/encoders.c:98-123); the chunk's last run is held open.
    """
    if runs.size == 0:
        return np.zeros(0, np.uint8), mask_on, mask_run
    runs = runs.astype(np.int64, copy=True)
    if bool(state_first) == bool(mask_on):
        runs[0] += mask_run
    else:
        runs = np.concatenate([np.asarray([mask_run], np.int64), runs])
    units = runs_to_units(runs[:-1])
    tail_on = bool(mask_on) ^ ((runs.size - 1) % 2 == 1)
    return units, tail_on, int(runs[-1])


class DeviceScanEngine:
    """Sharded-mesh scan engine, plug-compatible with ``native.scan``.

    One instance per stream (or longer — jit caches and capacity buckets are
    per-instance state).  Construct with an explicit mesh, or let it span
    every visible device.
    """

    #: pipeline/stream.py trims giant-record pieces to line starts for us,
    #: so device blocks never resume mid-line (lines never straddle blocks).
    line_aligned = True

    def __init__(self, mesh=None, n_blocks: Optional[int] = None):
        if mesh is None:
            from .mesh import block_mesh

            mesh = block_mesh(n_blocks)
        self.mesh = mesh
        self.D = int(mesh.devices.size)
        self._cols = 0                    # sticky [D, cols] block width
        self._caps: dict = {}             # sticky emit capacities
        self.device_chunks = 0            # observability: chunks on device
        self.native_chunks = 0            # ... and delegated to native
        self.fault_chunks = 0             # ... requeued after device faults

    # -- public: the native.scan-compatible entry point ---------------------

    def scan(self, data, *, fastq: bool, seq_type: int, strict: bool,
             well_formed: bool, do_mask: bool, do_upper: bool,
             marker_pos: int, threads: int = 0, flags: int = 0,
             prev_eol: bool = False, mask_on: bool = False,
             mask_run: int = 0, len_carry: int = 0, line_carry: int = 0,
             pack_carry: Optional[int] = None,
             scratch: Optional[dict] = None) -> "native.NativeScan":
        def delegate():
            self.native_chunks += 1
            return native.scan(
                data, fastq=fastq, seq_type=seq_type, strict=strict,
                well_formed=well_formed, do_mask=do_mask, do_upper=do_upper,
                marker_pos=marker_pos, threads=threads, flags=flags,
                prev_eol=prev_eol, mask_on=mask_on, mask_run=mask_run,
                len_carry=len_carry, line_carry=line_carry,
                pack_carry=pack_carry, scratch=scratch)

        if (strict or well_formed or do_upper
                or seq_type > C.SEQ_TYPE_RNA):
            return delegate()           # host modes: not device-shaped
        cont = bool(flags & native.F_CONT_SEQ)
        if cont and (not prev_eol or line_carry):
            return delegate()           # mid-line resume (giant single line)

        body = np.frombuffer(data, np.uint8)[marker_pos + 1:]
        try:
            if fastq:
                out = self._scan_fastq(
                    body, allow_partial=bool(flags & native.F_ALLOW_PARTIAL),
                    seq_type=seq_type, do_mask=do_mask, mask_on=mask_on,
                    mask_run=mask_run, pack_carry=pack_carry)
            else:
                out = self._scan_fasta(
                    body, cont=cont, seq_type=seq_type, do_mask=do_mask,
                    len_carry=len_carry, mask_on=mask_on, mask_run=mask_run,
                    pack_carry=pack_carry)
        except Exception as e:
            # per-block retry (SURVEY §5 failure detection): a device fault
            # on this chunk requeues it to the host scanner — the carry
            # algebra is shared, so the archive stays byte-identical and
            # later chunks can return to the device.  NAF_TPU_NO_FALLBACK=1
            # re-raises, as the in-memory encoder does.
            import os
            import warnings

            if os.environ.get("NAF_TPU_NO_FALLBACK") == "1":
                raise
            warnings.warn(
                f"naf_tpu: device scan failed ({type(e).__name__}: {e}); "
                "chunk requeued to host scanner")
            self.fault_chunks += 1
            return delegate()
        if out is None:
            return delegate()
        self.device_chunks += 1
        return out

    # -- device passes -------------------------------------------------------

    def _passes(self, blocks, *, fastq: bool, seq_type: int,
                parity_odd_in: bool):
        # sticky shapes: the block width and every emit capacity only grow,
        # so a long stream compiles each pass a handful of times
        self._cols = max(_bucket(blocks.data.shape[1], align=256), self._cols)
        dev = upload_blocks(blocks, self.mesh, cols=self._cols)
        st = stats_pass(dev, mesh=self.mesh, seq_type=seq_type, fastq=fastq)
        caps = emit_caps(st, fastq=fastq, text_like=False)
        for k, v in caps.items():
            caps[k] = max(v, self._caps.get(k, 0))
        self._caps.update(caps)
        em_np = emit_pass(dev, st, caps, mesh=self.mesh, seq_type=seq_type,
                          fastq=fastq, parity_odd_in=parity_odd_in)
        return (st.counts, st.id_bytes, st.com_bytes, st.qual_bytes,
                st.n_rec, st.n_runs, st.first_lower, st.longest, st.hists,
                em_np)

    # -- stitching into a NativeScan-shaped result ----------------------------

    def _build(self, res, *, fastq: bool, cont: bool, do_mask: bool,
               len_carry: int, mask_on: bool, mask_run: int,
               pack_carry: Optional[int], consumed: int):
        (counts, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
         first_lower, longest, hists, em_np) = res
        (packed, first_codes, _cnt2, id_vals, com_vals, qual_vals,
         seq_lens, id_lens, com_lens, qual_lens, run_lens) = em_np
        D = self.D

        def trim(arr2d):
            return [arr2d[k, : int(n_rec[k]) + 1] for k in range(D)]

        g_seq_lens = stitch_lengths(trim(seq_lens)).astype(np.uint64)
        if cont and g_seq_lens.size:
            g_seq_lens[0] += np.uint64(len_carry)
        g_id_lens = stitch_lengths(trim(id_lens))
        g_com_lens = stitch_lengths(trim(com_lens))

        if fastq:
            g_qual_lens = stitch_lengths(trim(qual_lens)).astype(np.uint64)
            if not np.array_equal(g_qual_lens, g_seq_lens):
                return None     # native path raises the reference error text

        if cont:
            # segment 0 continues the previous piece's open record: its id/
            # comment (0 bytes) were emitted with that record's header piece
            g_id_lens = g_id_lens[1:]
            g_com_lens = g_com_lens[1:]

        out = native.NativeScan()
        out.seq = _Chars(int(counts.sum()))
        out.packed = _stitch_packed_stream(packed, counts, first_codes,
                                           pack_carry)
        out.ids_blob = blob_from_lens(
            np.concatenate([id_vals[k, : int(id_bytes[k])]
                            for k in range(D)]), g_id_lens)
        out.comments_blob = blob_from_lens(
            np.concatenate([com_vals[k, : int(com_bytes[k])]
                            for k in range(D)]), g_com_lens)
        out.lengths = g_seq_lens
        out.n_sequences = int(g_seq_lens.size)
        if fastq:
            out.qual = np.concatenate(
                [qual_vals[k, : int(qual_bytes[k])] for k in range(D)])
            out.longest_line = int(g_seq_lens.max(initial=0))
        else:
            out.qual = np.zeros(0, np.uint8)
            out.longest_line = int(longest[0])

        if do_mask:
            runs, state_first = stitch_runs(
                [run_lens[k, : int(n_runs[k])] for k in range(D)],
                [bool(first_lower[k]) for k in range(D)])
            units, tail_on, tail_run = _merge_mask(
                runs, state_first, mask_on, mask_run)
        else:
            units, tail_on, tail_run = np.zeros(0, np.uint8), mask_on, mask_run
        out.mask_units = units
        out.mask_tail_on = tail_on
        out.mask_tail_run = tail_run

        out.unexpected_id = _merge_hist(hists[0][0], hists[1][0])
        out.unexpected_comment = _merge_hist(hists[2][0], hists[3][0])
        out.unexpected_seq = _merge_hist(hists[4][0], hists[5][0])
        out.unexpected_qual = _merge_hist(hists[6][0], hists[7][0])

        out.end_state = 2       # line-aligned pieces always end in-sequence
        out.end_line_len = 0
        out.consumed = consumed
        return out

    # -- format-specific front halves -----------------------------------------

    def _scan_fasta(self, body: np.ndarray, *, cont: bool, seq_type: int,
                    do_mask: bool, len_carry: int, mask_on: bool,
                    mask_run: int, pack_carry: Optional[int]):
        if body.size and not C.IS_EOL[body[-1]]:
            # piece ends mid-line: the open line's length must carry
            # (end_line_len), which only the native scanner reports
            return None
        blocks = make_blocks(body, self.D,
                             prev0=(_LF if cont else _GT), sis0=cont)
        res = self._passes(blocks, fastq=False, seq_type=seq_type,
                           parity_odd_in=pack_carry is not None)
        return self._build(res, fastq=False, cont=cont, do_mask=do_mask,
                           len_carry=len_carry, mask_on=mask_on,
                           mask_run=mask_run, pack_carry=pack_carry,
                           consumed=int(body.size))

    def _scan_fastq(self, body: np.ndarray, *, allow_partial: bool,
                    seq_type: int, do_mask: bool, mask_on: bool,
                    mask_run: int, pack_carry: Optional[int]):
        if body.size == 0:
            return None
        if allow_partial:
            eols = np.flatnonzero(body == _LF)
            n_complete = eols.size // 4
            if n_complete == 0:
                return None     # no full record yet: native reports consumed
            consumed = int(eols[4 * n_complete - 1]) + 1
            sub = body[:consumed]
        else:
            consumed = int(body.size)
            sub = body
        mb = make_blocks_fastq(sub, self.D)
        if mb is None:
            return None         # irregular grid: robust native parser
        blocks, _n_rec = mb
        res = self._passes(blocks, fastq=True, seq_type=seq_type,
                           parity_odd_in=pack_carry is not None)
        return self._build(res, fastq=True, cont=False, do_mask=do_mask,
                           len_carry=0, mask_on=mask_on, mask_run=mask_run,
                           pack_carry=pack_carry, consumed=consumed)
