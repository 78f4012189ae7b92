"""End-to-end sharded encode: bytes -> device mesh -> NAF archive.

This is the BASELINE north star: data-parallel sharded block compression
over a ``jax.sharding.Mesh``, merged into a spec-conformant archive that the
reference ``unnaf`` decodes.  Produces *byte-identical* archives to the host
pipeline (``naf_tpu.pipeline.encoder.encode``) because the two share
``build_archive``.

Division of labor (see parallel/block.py):
  * device pass 1: per-block scan + O(1) stats; psum/pmax/all_gather
    collectives across the mesh;
  * device pass 2: compacted section payloads (packed 4-bit seq, id/comment
    bytes, per-record lengths, mask runs, FASTQ quality) — device->host
    traffic ~= payload bytes, never per-input-byte metadata;
  * host: line/record-aligned block splitting, O(blocks + records + runs)
    carry stitching, zstd section framing, container write.

FASTA nucleotide inputs shard even when one giant record spans every device
(blocks cut at line starts — the sequence-parallel case).  FASTQ shards on
the regular 4-line grid; irregular inputs and protein/text/strict/
well-formed modes take the host path (same archive bytes either way).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..format import constants as C
from ..pipeline import parser as P
from ..pipeline.encoder import EncodeOptions, EncodeStats, build_archive
from .block import (
    blob_from_lens, emit_caps, emit_pass, make_blocks, make_blocks_fastq,
    stats_pass, stitch_lengths, stitch_packed, stitch_runs, upload_blocks,
)


def _wf_device_safe(body: np.ndarray, fastq: bool) -> bool:
    """True when --well-formed parsing provably equals robust parsing.

    The wf fast path (ennaf/src/process.c:314-355, tables.c:46-69) treats
    only LF and ' ' as whitespace and skips char validation.  Robust
    classification produces identical bytes iff the input contains no
    TAB/VT/FF/CR and no ' ' outside header lines (spaces ON header lines
    behave identically: the first ends the id, the rest are comment bytes
    under both tables).  Char validation differences surface as nonzero
    unexpected-char histograms and are caught after pass 1.
    """
    if body.size == 0:
        return True
    if np.any((body == 9) | (body == 11) | (body == 12) | (body == 13)):
        return False
    sp = np.flatnonzero(body == 32)
    if sp.size == 0:
        return True
    eol = np.flatnonzero(body == 10)
    line_id = np.searchsorted(eol, sp)        # line index of each space
    if fastq:
        return bool(np.all(line_id % 4 == 0))
    starts = np.concatenate([[0], eol + 1])   # start byte of each line
    first = body[np.minimum(starts[line_id], body.size - 1)]
    # line 0 is record 0's header (its '>' was stripped by the caller)
    return bool(np.all((line_id == 0) | (first == ord(">"))))


def _merge_hist(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """u32 (lo16, hi16) psum halves -> u64[257] histogram."""
    h = np.zeros(257, np.uint64)
    h[:256] = (hi.astype(np.uint64) << 16) + lo.astype(np.uint64)
    return h


def encode_sharded(data: bytes, opts: Optional[EncodeOptions] = None, *,
                   mesh=None, n_blocks: Optional[int] = None
                   ) -> tuple[bytes, EncodeStats]:
    """Sharded FASTA/FASTQ encode over a device mesh.

    Nucleotide inputs run the device pipeline; protein/text, strict and
    well-formed modes, and irregular FASTQ take the host path — same
    archive bytes either way.
    """
    from .mesh import block_mesh

    opts = opts or EncodeOptions()
    from ..pipeline.encoder import encode as host_encode

    fmt, marker = P.detect_format(data)
    if (opts.in_format != C.IN_FORMAT_UNKNOWN and fmt != C.IN_FORMAT_UNKNOWN
            and opts.in_format != fmt):
        raise P.InputError(
            "input format is different from format specified in the command line")

    device_path = fmt in (C.IN_FORMAT_FASTA, C.IN_FORMAT_FASTQ)
    if not device_path:
        return host_encode(data, opts)

    fastq = fmt == C.IN_FORMAT_FASTQ
    body = np.frombuffer(data, np.uint8)[marker + 1:]

    # --well-formed parses with the reduced space table (LF/' ' only,
    # tables.c:46-69) and skips replacement: on inputs where that regime
    # actually holds — no TAB/VT/FF/CR anywhere, no ' ' inside sequence or
    # quality lines — the robust classification the device runs is
    # byte-identical, so the archive is too.  Inputs outside the regime
    # (where wf semantics diverge byte-for-byte) take the host wf parser.
    if opts.well_formed and not _wf_device_safe(body, fastq):
        return host_encode(data, opts)

    if mesh is None:
        mesh = block_mesh(n_blocks)
    D = mesh.devices.size

    if fastq:
        mb = make_blocks_fastq(body, D)
        if mb is None:                      # irregular grid -> host parser
            return host_encode(data, opts)
        blocks, _ = mb
    else:
        blocks = make_blocks(body, D)

    text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
    try:
        dev = upload_blocks(blocks, mesh)
        st = stats_pass(dev, mesh=mesh, seq_type=opts.seq_type, fastq=fastq)
        # --strict dies at the FIRST unexpected char with its exact
        # position-dependent message (process.c:121-129): pass-1 histograms
        # prove cleanliness for free; any hit re-parses on the host, which
        # raises the reference-exact error text
        if opts.strict and any(int(h.sum()) for h in st.hists):
            return host_encode(data, opts)
        em_np = emit_pass(dev, st, emit_caps(st, fastq=fastq,
                                             text_like=text_like),
                          mesh=mesh, seq_type=opts.seq_type, fastq=fastq,
                          text_like=text_like)
    except P.InputError:
        raise                               # user-facing parse errors
    except Exception as e:
        # failure detection (SURVEY §5): a device fault mid-encode requeues
        # the work to the host pipeline instead of aborting — the archive is
        # byte-identical either way, so retry is free correctness-wise.
        # NAF_TPU_NO_FALLBACK=1 re-raises instead (CI/debug: a silent retry
        # would otherwise hide real device-path regressions behind a
        # still-correct archive)
        import os
        import warnings

        if os.environ.get("NAF_TPU_NO_FALLBACK") == "1":
            raise
        warnings.warn(
            f"naf_tpu: device encode failed ({type(e).__name__}: {e}); "
            "falling back to the host pipeline")
        return host_encode(data, opts)

    return _stitch_and_build(
        D, fmt, opts, st.counts, st.id_bytes, st.com_bytes, st.qual_bytes,
        st.n_rec, st.n_runs, st.first_lower, st.longest, st.hists, em_np,
        fallback=lambda: host_encode(data, opts))


def _stitch_and_build(D, fmt, opts, counts, id_bytes, com_bytes, qual_bytes,
                      n_rec, n_runs, first_lower, longest, hists, em_np,
                      fallback, prebuilt=None):
    """Host carry stitching (O(blocks + records + runs)) + container.

    ``prebuilt`` injects ready SEQ/QUAL sections (multi-host extended path:
    payloads were compressed on their owning hosts; em_np then carries
    zero-width packed/qual arrays).
    """
    fastq = fmt == C.IN_FORMAT_FASTQ
    (packed, first_codes, cnt2, id_vals, com_vals, qual_vals,
     seq_lens, id_lens, com_lens, qual_lens, run_lens) = em_np

    def trim(arr2d):
        return [arr2d[k, : int(n_rec[k]) + 1] for k in range(D)]

    g_seq_lens = stitch_lengths(trim(seq_lens))
    g_id_lens = stitch_lengths(trim(id_lens))
    g_com_lens = stitch_lengths(trim(com_lens))
    n_records = int(n_rec.sum()) + 1
    assert g_seq_lens.size == n_records

    if fastq:
        g_qual_lens = stitch_lengths(trim(qual_lens))
        if not np.array_equal(g_qual_lens, g_seq_lens):
            # exact error text (record index, counts) comes from the host
            # parser, which scans sequentially like the reference
            return fallback()

    res = P.ParseResult()
    res.n_sequences = n_records
    res.ids_blob = blob_from_lens(
        np.concatenate([id_vals[k, : int(id_bytes[k])] for k in range(D)]),
        g_id_lens)
    res.comments_blob = blob_from_lens(
        np.concatenate([com_vals[k, : int(com_bytes[k])] for k in range(D)]),
        g_com_lens)
    res.lengths = g_seq_lens.astype(np.uint64)
    res.longest_line = int(longest[0])

    total_chars = int(counts.sum())
    text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
    if text_like:
        # protein/text archives store raw bytes: per-block compacted char
        # streams concatenate directly (no nibble parity); build_archive
        # upper-cases under --no-mask
        res.seq = (np.concatenate(
            [packed[k, : int(counts[k])] for k in range(D)])
            if total_chars else np.zeros(0, np.uint8)).astype(np.uint8)
        res.packed = None
    else:
        res.seq = np.zeros(total_chars, np.uint8)    # only .size is used
        if prebuilt is None:
            res.packed = stitch_packed(packed, counts, first_codes)
        else:
            res.packed = np.zeros(0, np.uint8)   # payload arrives prebuilt

    store_mask = not opts.no_mask and not text_like
    if store_mask:
        from ..ops.mask import runs_to_units

        runs, state_first = stitch_runs(
            [run_lens[k, : int(n_runs[k])] for k in range(D)],
            [bool(first_lower[k]) for k in range(D)])
        if state_first and runs.size:
            runs = np.concatenate([[0], runs])   # leading masked run
        res.mask_units = runs_to_units(runs)

    if fastq and prebuilt is None:
        res.qual = np.concatenate(
            [qual_vals[k, : int(qual_bytes[k])] for k in range(D)])
    elif fastq:
        res.qual = np.zeros(int(counts.sum()), np.uint8)   # size only

    res.unexpected_id = _merge_hist(hists[0][0], hists[1][0])
    res.unexpected_comment = _merge_hist(hists[2][0], hists[3][0])
    res.unexpected_seq = _merge_hist(hists[4][0], hists[5][0])
    res.unexpected_qual = _merge_hist(hists[6][0], hists[7][0])

    stats = EncodeStats(
        n_sequences=res.n_sequences, longest_line=res.longest_line,
        seq_size_original=total_chars,
        unexpected_id=res.unexpected_id,
        unexpected_comment=res.unexpected_comment,
        unexpected_seq=res.unexpected_seq,
        unexpected_qual=res.unexpected_qual,
        in_format=fmt,
    )
    return build_archive(res, opts, stats, prebuilt=prebuilt)


def device_to_host_bytes(D: int, caps: dict) -> int:
    """Accounting helper for tests/bench: bytes shipped device->host by
    pass 2 (payloads only; pass 1 is O(1) scalars + histograms)."""
    per_block = (caps["p_cap"] + caps["id_cap"] + caps["com_cap"]
                 + caps["q_cap"] + 4 * 4 * caps["r_cap"] + 4 * caps["m_cap"])
    return D * per_block
