"""Multi-host (multi-process) sharded encode.

Runs the same two-pass device block-encode as ``pipeline.encode_sharded``,
but over a *global* mesh spanning every process started under
``jax.distributed.initialize`` (one process per card or host, or multi-process CPU in
tests).  Each process feeds only the block shards its addressable devices
own; the collectives inside pass 1 (psum histograms, pmax line length,
all_gather counts) run across processes; pass 2's *compacted* per-block payloads
are gathered with ``multihost_utils.process_allgather`` — O(payload)
traffic, never per-input-byte metadata — and stitched with the same carry
algebra as the single-process path, so the archive is byte-identical to
``encoder.encode`` on one host.

For production-scale archives, ``encode_multihost_extended`` goes further:
every host zstd-compresses its own devices' packed/quality bytes into
extended-format frames locally and only the COMPRESSED frames cross the
host network (O(compressed) traffic; SURVEY §2.4).  Frame boundaries are
host-local, so the archive differs from the single-host blocked layout in
framing only — the decoded bytes are identical and every process returns
the same archive.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..format import constants as C
from ..pipeline import parser as P
from ..pipeline.encoder import EncodeOptions, EncodeStats


def _count(traffic: Optional[dict], nbytes: int) -> None:
    if traffic is not None:
        traffic["gathered_bytes"] = traffic.get("gathered_bytes", 0) + nbytes


def _gather_rows(garr, D: int, traffic: Optional[dict] = None):
    """Gather a [D, ...] global array's rows to every process, in order.

    Robust to uneven/multi-row/reordered shards: every shard travels with
    its explicit (start, length) span, and full coverage is asserted.
    """
    from jax.experimental import multihost_utils

    shards = sorted(garr.addressable_shards, key=lambda s: s.index[0].start)
    starts = [int(s.index[0].start) for s in shards]
    lens = [int(s.data.shape[0]) for s in shards]
    local = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
    spans = np.asarray([starts, lens])                     # (2, n_shards)
    all_spans = multihost_utils.process_allgather(spans)   # (P, 2, n_shards)
    all_val = multihost_utils.process_allgather(local)     # (P, rows, ...)
    _count(traffic, all_spans.nbytes + all_val.nbytes)
    out = np.empty((D,) + local.shape[1:], local.dtype)
    seen = np.zeros(D, bool)
    for p in range(all_spans.shape[0]):
        off = 0
        for start, ln in zip(all_spans[p, 0], all_spans[p, 1]):
            start, ln = int(start), int(ln)
            out[start:start + ln] = all_val[p, off:off + ln]
            seen[start:start + ln] = True
            off += ln
    assert seen.all(), "gather missed block rows"
    return out


def _allgather_bytes(buf: np.ndarray, traffic: Optional[dict] = None
                     ) -> list[np.ndarray]:
    """Gather one variable-length u8 payload per process, in process order."""
    from jax.experimental import multihost_utils

    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    lens = multihost_utils.process_allgather(np.int64(buf.size))
    lens = np.atleast_1d(lens)
    cap = max(int(lens.max()), 1)
    padded = np.zeros(cap, np.uint8)
    padded[:buf.size] = buf
    allv = np.atleast_2d(multihost_utils.process_allgather(padded))
    _count(traffic, allv.nbytes + lens.nbytes)
    return [allv[p, :int(lens[p])] for p in range(lens.size)]


def _local_row(garr) -> np.ndarray:
    """One locally addressable row of a [D, ...] array whose rows are known
    to be replicas (psum outputs) — shape (1, ...), no cross-host traffic."""
    s = min(garr.addressable_shards, key=lambda sh: sh.index[0].start)
    return np.asarray(s.data[0:1])


class _HostFallback(Exception):
    """Input regime the device passes can't cover bit-exactly; every
    process re-encodes on the host (input bytes are identical everywhere,
    so the archives are too — no collectives needed)."""


def _run_passes(data: bytes, opts: EncodeOptions, traffic: Optional[dict],
                *, allow_text: bool = False):
    """Shared two-pass body: returns everything both archive builders need.

    The big pass-2 payload rows (packed seq, FASTQ quality) come back as
    the GLOBAL jax arrays so each caller decides whether to gather them
    (plain path) or compress its local shards in place (extended path).
    """
    import jax

    from .block import make_blocks, make_blocks_fastq
    from .mesh import block_mesh, block_sharding
    from . import pipeline as PL

    fmt, marker = P.detect_format(data)
    text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
    if text_like and not allow_text:
        # the compressed-traffic paths stitch packed-nibble byte ranges;
        # raw-byte sections take the host (identical on every process)
        raise _HostFallback("text/protein over compressed-traffic path")

    fastq = fmt == C.IN_FORMAT_FASTQ
    body = np.frombuffer(data, np.uint8)[marker + 1:]
    if opts.well_formed and not PL._wf_device_safe(body, fastq):
        raise _HostFallback("wf-divergent input")

    mesh = block_mesh()
    D = mesh.devices.size
    sharding = block_sharding(mesh)

    if fastq:
        mb = make_blocks_fastq(body, D)
        if mb is None:
            raise _HostFallback("irregular FASTQ grid")
        blocks, _ = mb
    else:
        blocks = make_blocks(body, D)

    def to_global(arr):
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])

    blocks_d = to_global(blocks.data)
    prev_d = to_global(blocks.prev)
    sis_d = to_global(blocks.starts_in_seq)

    from .block import (
        PassStats, emit_blocks_sharded, emit_caps, stats_blocks_sharded)

    st = stats_blocks_sharded(blocks_d, prev_d, sis_d,
                              seq_type=opts.seq_type, fastq=fastq, mesh=mesh)
    st_np = [_gather_rows(o, D, traffic) for o in st[:9]]
    (counts, odd, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
     first_lower, longest) = st_np
    # the histogram rows are psum results — replicated content, so any
    # locally addressable row IS the global total; nothing to gather
    hists = [_local_row(o) for o in st[9:]]

    # --strict: pass-1 histograms prove cleanliness; any unexpected char
    # re-parses on the host for the reference-exact error (or archive)
    if opts.strict and any(int(h.sum()) for h in hists):
        raise _HostFallback("strict input has unexpected chars")

    caps = emit_caps(PassStats(counts, id_bytes, com_bytes, qual_bytes,
                               n_rec, n_runs, first_lower, longest, hists),
                     fastq=fastq, text_like=text_like)

    em = emit_blocks_sharded(
        blocks_d, prev_d, sis_d, st[1],
        seq_type=opts.seq_type, fastq=fastq, mesh=mesh,
        pack_nibbles=not text_like, **caps)

    return (D, fmt, counts, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
            first_lower, longest, hists, em)


def _fallback(msg: str):
    def f():
        raise P.InputError(msg)
    return f


def encode_multihost(data: bytes, opts: Optional[EncodeOptions] = None
                     ) -> tuple[bytes, EncodeStats]:
    """Collective: every process calls with the same input bytes.

    Returns the archive (identical on every process, byte-identical to the
    single-host ``encoder.encode``).
    """
    from ..pipeline.encoder import encode as host_encode
    from . import pipeline as PL

    opts = opts or EncodeOptions()
    try:
        (D, fmt, counts, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
         first_lower, longest, hists, em) = _run_passes(data, opts, None,
                                                        allow_text=True)
    except _HostFallback:
        return host_encode(data, opts)
    em_np = [_gather_rows(o, D) for o in em]

    return PL._stitch_and_build(
        D, fmt, opts, counts, id_bytes, com_bytes, qual_bytes, n_rec,
        n_runs, first_lower, longest, hists, em_np,
        fallback=_fallback("quality/sequence length mismatch"))


def _local_runs(garr) -> list[tuple[int, int, list]]:
    """This process's shards as maximal contiguous block runs.

    Returns [(k0, k1, rows)] where rows[i] is block k0+i's payload row.
    """
    shards = sorted(garr.addressable_shards, key=lambda s: s.index[0].start)
    runs: list[tuple[int, int, list]] = []
    for s in shards:
        start = int(s.index[0].start)
        rows = [np.asarray(s.data[i]) for i in range(s.data.shape[0])]
        if runs and runs[-1][1] == start:
            k0, _, acc = runs[-1]
            acc.extend(rows)
            runs[-1] = (k0, start + len(rows), acc)
        else:
            runs.append((start, start + len(rows), rows))
    return runs


def _gather_framed(local_runs: list[tuple[int, list[int], list[bytes]]],
                   traffic: Optional[dict]) -> tuple[bytes, int]:
    """Gather per-host (k0, raw_lens, frames) runs; assemble the blocked
    section payload (VLE index + frames in block order).

    Only compressed frames + O(frames) integers travel.  Returns
    (payload, total_raw_bytes).
    """
    from ..codec import blocked_payload

    metas, blobs = [], []
    for k0, raw_lens, frames in local_runs:
        metas.append([k0, len(frames)])
        metas.extend([r, len(f)] for r, f in zip(raw_lens, frames))
        blobs.extend(frames)
    meta = np.asarray([x for m in metas for x in m], np.int64)
    blob = (np.frombuffer(b"".join(blobs), np.uint8)
            if blobs else np.zeros(0, np.uint8))

    all_meta = _allgather_bytes(meta.view(np.uint8), traffic)
    all_blob = _allgather_bytes(blob, traffic)

    entries = []           # (k0, raw_lens, frames)
    for pm, pb in zip(all_meta, all_blob):
        m = pm.view(np.int64)
        off = i = 0
        while i < m.size:
            k0, nf = int(m[i]), int(m[i + 1])
            i += 2
            raws, frames = [], []
            for _ in range(nf):
                r, c = int(m[i]), int(m[i + 1])
                i += 2
                frames.append(pb[off:off + c].tobytes())
                raws.append(r)
                off += c
            entries.append((k0, raws, frames))
    entries.sort(key=lambda e: e[0])

    raw_lens = [r for _, raws, _ in entries for r in raws]
    frames = [f for _, _, fs in entries for f in fs]
    if not frames:
        raw_lens, frames = [0], [_empty_frame()]
    return blocked_payload(raw_lens, frames), sum(raw_lens)


def _empty_frame() -> bytes:
    from ..codec import compress_section

    return compress_section(b"")


def _gather_parts(local_parts, traffic: Optional[dict]):
    """Gather per-host (k0, part_size, chain) triples from every process.

    Returns (part_sizes, chains) in global block order.  Only compressed
    chains + O(parts) integers travel.
    """
    metas, blobs = [], []
    for k0, psize, chain in local_parts:
        metas.extend((int(k0), int(psize), len(chain)))
        blobs.append(chain)
    meta = np.asarray(metas, np.int64)
    blob = (np.frombuffer(b"".join(blobs), np.uint8)
            if blobs else np.zeros(0, np.uint8))
    all_meta = _allgather_bytes(meta.view(np.uint8), traffic)
    all_blob = _allgather_bytes(blob, traffic)
    entries = []
    for pm, pb in zip(all_meta, all_blob):
        m = pm.view(np.int64)
        off = 0
        for i in range(0, m.size, 3):
            k0, ps, cl = int(m[i]), int(m[i + 1]), int(m[i + 2])
            entries.append((k0, ps, pb[off:off + cl].tobytes()))
            off += cl
    entries.sort(key=lambda e: e[0])
    return [e[1] for e in entries], [e[2] for e in entries]


def encode_multihost_parts(data: bytes,
                           opts: Optional[EncodeOptions] = None,
                           traffic: Optional[dict] = None
                           ) -> tuple[bytes, EncodeStats]:
    """O(compressed)-traffic multi-host encode into the PLAIN format.

    SURVEY §2.4's single-frame block stitching: every host compresses its
    own devices' packed-sequence (and FASTQ quality) byte ranges into
    history-free zstd block chains (``naf_zstd_compress_part``); only the
    chains plus O(blocks + records) metadata are allgathered, and every
    host stitches them into ONE standard zstd frame per section
    (``stitch_section_frame``) — so the archive stays decodable by the
    reference ``unnaf``, which injects a single frame magic per section
    (/root/reference/unnaf/src/input.c:278) and cannot handle multi-frame
    sections.  Unlike ``encode_multihost`` the archive is not byte-
    identical to the single-host one (frame internals differ with the
    shard layout); the DECODED bytes are identical, and traffic is
    O(compressed) like the extended path but without the tnaf-only
    format bit.
    """
    from ..codec.zstd_backend import (compress_part_native,
                                      stitch_section_frame)
    from ..format.container import Section
    from . import pipeline as PL
    from .block import stitch_packed_range

    opts = opts or EncodeOptions()
    try:
        (D, fmt, counts, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
         first_lower, longest, hists, em) = _run_passes(data, opts, traffic)
    except _HostFallback:
        from ..pipeline.encoder import encode as host_encode

        return host_encode(data, opts)
    fastq = fmt == C.IN_FORMAT_FASTQ

    first_codes = _gather_rows(em[1], D, traffic)
    em_np = [None] * len(em)
    for i, o in enumerate(em):
        if i == 0 or (i == 5 and fastq):
            em_np[i] = np.zeros((D, 0), np.uint8)
        else:
            em_np[i] = _gather_rows(o, D, traffic)
    em_np[1] = first_codes

    seq_local = []
    for k0, k1, rows in _local_runs(em[0]):
        byts = stitch_packed_range(
            {k0 + i: r for i, r in enumerate(rows)}, counts, first_codes,
            k0, k1)
        if byts.size == 0:
            continue
        chain = compress_part_native(byts.tobytes(), level=opts.level,
                                     window_log=opts.long_window_log)
        seq_local.append((k0, byts.size, chain))
    sizes, chains = _gather_parts(seq_local, traffic)
    total_chars = int(counts.sum())
    assert sum(sizes) == (total_chars + 1) // 2, \
        f"part bytes {sum(sizes)} != packed size {(total_chars + 1) // 2}"
    seq_payload = stitch_section_frame(chains, sizes, opts.level,
                                       opts.long_window_log)
    prebuilt = {"sequence": Section(uncompressed_size=total_chars,
                                    payload=seq_payload)}

    if fastq:
        qual_local = []
        for k0, k1, rows in _local_runs(em[5]):
            byts = np.concatenate(
                [rows[i][: int(qual_bytes[k0 + i])]
                 for i in range(k1 - k0)]) if rows else np.zeros(0, np.uint8)
            if byts.size == 0:
                continue
            chain = compress_part_native(byts.tobytes(), level=opts.level)
            qual_local.append((k0, byts.size, chain))
        qsizes, qchains = _gather_parts(qual_local, traffic)
        total_qual = int(qual_bytes.sum())
        assert sum(qsizes) == total_qual, (sum(qsizes), total_qual)
        prebuilt["quality"] = Section(
            uncompressed_size=total_qual,
            payload=stitch_section_frame(qchains, qsizes, opts.level))

    return PL._stitch_and_build(
        D, fmt, opts, counts, id_bytes, com_bytes, qual_bytes, n_rec,
        n_runs, first_lower, longest, hists, em_np,
        fallback=_fallback("quality/sequence length mismatch"),
        prebuilt=prebuilt)


def encode_multihost_extended(data: bytes,
                              opts: Optional[EncodeOptions] = None,
                              traffic: Optional[dict] = None
                              ) -> tuple[bytes, EncodeStats]:
    """O(compressed)-traffic multi-host encode into the extended format.

    Every host compresses its OWN devices' packed-sequence (and FASTQ
    quality) bytes into independent extended-format frames; only the
    compressed frames plus O(blocks + records) metadata are allgathered.
    The plain path (``encode_multihost``) ships the uncompressed payloads —
    fine for small inputs, not for large multi-host runs.  Pass ``traffic={}`` to receive
    the total gathered byte count (asserted ≈ compressed size in
    tests/test_multihost.py).
    """
    from dataclasses import replace

    from ..codec import compress_frames
    from ..format.container import Section
    from . import pipeline as PL
    from .block import stitch_packed_range

    opts = replace(opts or EncodeOptions(), extended=True)
    try:
        (D, fmt, counts, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
         first_lower, longest, hists, em) = _run_passes(data, opts, traffic)
    except _HostFallback:
        from ..pipeline.encoder import encode as host_encode

        return host_encode(data, opts)
    fastq = fmt == C.IN_FORMAT_FASTQ

    # small rows travel; the packed/quality payload rows (em[0], em[5])
    # stay on their owning hosts and leave compressed
    first_codes = _gather_rows(em[1], D, traffic)
    em_np = [None] * len(em)
    for i, o in enumerate(em):
        if i == 0 or (i == 5 and fastq):
            em_np[i] = np.zeros((D, 0), np.uint8)
        else:
            em_np[i] = _gather_rows(o, D, traffic)
    em_np[1] = first_codes

    def frames_of(byts: np.ndarray):
        return compress_frames(
            byts, level=opts.level, window_log=opts.long_window_log,
            threads=opts.threads, block_bytes=opts.block_bytes,
            engine=opts.engine)

    seq_runs = []
    for k0, k1, rows in _local_runs(em[0]):
        byts = stitch_packed_range(
            {k0 + i: r for i, r in enumerate(rows)}, counts, first_codes,
            k0, k1)
        if byts.size == 0 and counts[k0:k1].sum() == 0:
            continue
        raw_lens, frames = frames_of(byts)
        seq_runs.append((k0, raw_lens, frames))
    seq_payload, seq_raw = _gather_framed(seq_runs, traffic)
    total_chars = int(counts.sum())
    assert seq_raw == (total_chars + 1) // 2, \
        f"framed SEQ bytes {seq_raw} != packed size {(total_chars + 1) // 2}"
    prebuilt = {"sequence": Section(uncompressed_size=total_chars,
                                    payload=seq_payload)}

    if fastq:
        qual_runs = []
        for k0, k1, rows in _local_runs(em[5]):
            byts = np.concatenate(
                [rows[i][: int(qual_bytes[k0 + i])]
                 for i in range(k1 - k0)]) if rows else np.zeros(0, np.uint8)
            if byts.size == 0 and qual_bytes[k0:k1].sum() == 0:
                continue
            raw_lens, frames = frames_of(byts)
            qual_runs.append((k0, raw_lens, frames))
        qual_payload, qual_raw = _gather_framed(qual_runs, traffic)
        total_qual = int(qual_bytes.sum())
        assert qual_raw == total_qual, \
            f"framed QUAL bytes {qual_raw} != {total_qual}"
        prebuilt["quality"] = Section(uncompressed_size=total_qual,
                                      payload=qual_payload)

    return PL._stitch_and_build(
        D, fmt, opts, counts, id_bytes, com_bytes, qual_bytes, n_rec,
        n_runs, first_lower, longest, hists, em_np,
        fallback=_fallback("quality/sequence length mismatch"),
        prebuilt=prebuilt)
