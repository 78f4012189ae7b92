"""zstd section codec (host side).

Each NAF section is one zstd frame stored minus its 4-byte frame magic
(compressor parity: ennaf/src/compressor.c:150-173; decoder re-injects it,
unnaf/src/utils.c:144-150).

Design notes:
  * the default engine is the system libzstd (codec/syszstd.py), the
    library the reference links; ``--engine native`` uses the built-in
    engine (native/naf_zstd.cpp) instead;
  * compression of independent sections, and of job-split input within a
    section, runs on host CPU threads (``threads=N`` maps to zstd's internal
    job splitting, which still emits a single reference-decodable frame);
  * the device pipeline hands this layer already-packed section bytes
    (4-bit codes, RLE mask units, length units) as numpy buffers;
  * an extended multi-frame mode for tnaf<->tnaf parallel decode is gated
    behind the reserved extended-format flag (spec §2.4) in later rounds.
"""

from __future__ import annotations

from typing import Iterator, Optional

import os

from . import syszstd
from ..format.constants import ZSTD_FRAME_MAGIC

#: zstd window-log hard bounds (matches ZSTD_WINDOWLOG_MIN/MAX used by ennaf).
WINDOWLOG_MIN = 10
WINDOWLOG_MAX = 31

MIN_CLEVEL = -131072
MAX_CLEVEL = 22


class SectionCompressor:
    """Streaming single-frame compressor for one section.

    Feed with `write(data)` calls; `finish()` returns the magic-stripped frame.
    Mirrors the reference's per-section ZSTD_CStream usage
    (ennaf/src/compressor.c:119-147) but keeps output in RAM.
    """

    #: Fixed feed granularity in multithreaded mode.  zstd's MT path emits a
    #: slightly different (equally valid) frame when the whole input arrives
    #: in a single compress() call versus chunked; feeding in exact 4 MB
    #: units makes the frame a pure function of (options, payload bytes), so
    #: in-memory, streaming, and sharded encodes stay byte-identical
    #: regardless of caller chunking.
    _STAGE = 4 << 20

    def __init__(self, level: int = 1, window_log: int = 0, threads: int = 0):
        self._chunks: list[bytes] = []
        self._pending = 0           # == sum(len(c) for c in self._chunks)
        self._uncompressed = 0
        self._level = level
        self._window_log = window_log
        self._threads = threads
        self._obj = None            # created on the first _STAGE of input
        self._finished = False
        self._mt = threads != 0
        self._buf = bytearray()     # MT: sub-_STAGE staging remainder
        # Payloads below one _STAGE never build a streaming context at all:
        # raw pieces buffer here and finish() compresses them ONE-SHOT with
        # a pledged source size, which lets zstd right-size its window and
        # match-finder tables.  At level 22 this turns a ~0.3 s context
        # build into microseconds for tiny sections and is ~1.7x faster on
        # megabyte payloads, at the cost of a 1-8 byte content-size header.
        # Deterministic across callers: the cutover is a pure function of
        # (options, payload size), so in-memory / streaming / sharded
        # encodes still emit identical frames.
        self._raw: list | None = []
        self._raw_n = 0

    @property
    def uncompressed_size(self) -> int:
        return self._uncompressed

    def _emit(self, out: bytes) -> None:
        if out:
            self._chunks.append(out)
            self._pending += len(out)

    def write(self, data) -> None:
        mv = memoryview(data)
        if mv.nbytes == 0:
            return
        self._uncompressed += mv.nbytes
        if self._raw is not None:
            if self._raw_n + mv.nbytes < self._STAGE:
                # small pieces are copied (callers hand zero-copy scratch
                # views that they reuse as soon as write() returns)
                self._raw.append(bytes(mv))
                self._raw_n += mv.nbytes
                return
            pieces, self._raw = self._raw, None
            self._obj = syszstd.SysZstdCompressor(
                self._level, window_log=self._window_log,
                threads=self._threads)
            for p in pieces:
                self._feed(memoryview(p))
        self._feed(mv)

    def _feed(self, mv: memoryview) -> None:
        if not self._mt:
            self._emit(self._obj.compress(mv))
            return
        stage = self._STAGE
        if self._buf:
            take = min(stage - len(self._buf), mv.nbytes)
            self._buf += mv[:take]
            mv = mv[take:]
            if len(self._buf) == stage:
                self._emit(self._obj.compress(self._buf))
                self._buf = bytearray()
        off = 0
        n = mv.nbytes
        while n - off >= stage:                 # large writes feed zero-copy
            self._emit(self._obj.compress(mv[off:off + stage]))
            off += stage
        if off < n:
            self._buf += mv[off:]

    def _finish_oneshot(self) -> bytes:
        """Whole payload buffered: one-shot frame with pledged source size."""
        payload = b"".join(self._raw)
        self._raw = None
        if self._window_log:
            # honor --long but never size tables beyond the payload
            wl = min(self._window_log,
                     max(WINDOWLOG_MIN, max(len(payload), 1).bit_length()))
        else:
            wl = 0
        return syszstd.compress_oneshot(payload, self._level, window_log=wl)

    def finish(self) -> bytes:
        """End the frame and return payload with the 4-byte magic stripped."""
        assert not self._finished
        self._finished = True
        if self._raw is not None:
            frame = self._finish_oneshot()
            if len(frame) < 4 or frame[:4] != ZSTD_FRAME_MAGIC:
                raise RuntimeError("compression failed")
            return frame[4:]
        if self._buf:
            self._emit(self._obj.compress(self._buf))
            self._buf = bytearray()
        tail = self._obj.flush_finish()
        if tail:
            self._chunks.append(tail)
        frame = b"".join(self._chunks)
        self._chunks = []
        self._pending = 0
        if len(frame) < 4 or frame[:4] != ZSTD_FRAME_MAGIC:
            raise RuntimeError("compression failed")
        return frame[4:]


def compress_section(data, level: int = 1, window_log: int = 0, threads: int = 0) -> bytes:
    c = SectionCompressor(level=level, window_log=window_log, threads=threads)
    c.write(data)
    return c.finish()


_DECODE_ENGINE = "zstd"


def set_decode_engine(name: str) -> None:
    """Select the decode-side entropy engine: 'zstd' (library, default) or
    'native' (the from-scratch RFC 8878 decoder in native/naf_zstd.cpp —
    the decode half of SURVEY §2.3.1's only third-party dependency,
    reference parity unnaf/src/input.c:260-292)."""
    global _DECODE_ENGINE
    if name not in ("zstd", "native"):
        raise ValueError(f"unknown decode engine {name!r}")
    _DECODE_ENGINE = name


def decode_engine() -> str:
    return _DECODE_ENGINE


def decompress_section_native(payload: bytes, uncompressed_size: int) -> bytes:
    """One-shot decode with the native from-scratch zstd decoder."""
    import ctypes as ct

    import numpy as np

    from .. import native as _native

    lib = _native._load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    if not hasattr(lib, "_naf_zstd_dec_ready"):
        lib.naf_zstd_decompress.restype = ct.c_uint64
        lib.naf_zstd_decompress.argtypes = [
            ct.c_void_p, ct.c_uint64, ct.c_void_p, ct.c_uint64]
        lib._naf_zstd_dec_ready = True
    frame = ZSTD_FRAME_MAGIC + payload
    src = np.frombuffer(frame, np.uint8)
    # +32 slack: the decoder's wide match copies overshoot the logical cap
    # by up to 15 bytes (overwritten or ignored; never returned)
    out = np.empty(max(uncompressed_size, 1) + 32, np.uint8)
    w = lib.naf_zstd_decompress(
        src.ctypes.data_as(ct.c_void_p), src.size,
        out.ctypes.data_as(ct.c_void_p), uncompressed_size)
    if w == (1 << 64) - 1:
        raise RuntimeError("native decode: corrupt zstd stream")
    if w != uncompressed_size:
        raise RuntimeError("section decompression size mismatch")
    return out[:w].tobytes()


def decompress_section(payload: bytes, uncompressed_size: int) -> bytes:
    """One-shot decode of a magic-stripped section payload."""
    if _DECODE_ENGINE == "native":
        return decompress_section_native(payload, uncompressed_size)
    return syszstd.decompress(ZSTD_FRAME_MAGIC + payload, uncompressed_size)


class SectionDecompressor:
    """Streaming decoder for a magic-stripped section payload.

    `feed()` compressed chunks (the first must be prefixed implicitly with the
    zstd magic, handled here); iterate decompressed chunks.

    With the native decode engine selected AND both totals supplied, input
    is buffered and decoded one-shot when the last compressed byte arrives
    (the native decoder has no incremental entry point yet); callers that
    loop "feed until csize consumed" work unchanged, at the cost of section-
    sized memory on this opt-in path.
    """

    def __init__(self, total_in: Optional[int] = None,
                 total_out: Optional[int] = None,
                 force_library: bool = False):
        """``force_library`` bypasses the native one-shot path — callers
        that stop at an output prefix (--range) need the library's
        incremental decode, which yields bytes per fed chunk."""
        self._done = False
        self._native = (not force_library and _DECODE_ENGINE == "native"
                        and total_in is not None and total_out is not None)
        if self._native:
            self._total_in = total_in
            self._total_out = total_out
            self._got = 0
            self._parts: list = []
            return
        self._obj = syszstd.SysZstdDecompressor()
        self._first = True

    def feed(self, chunk: bytes) -> bytes:
        if self._done:
            # single-shot contract: a feed after the final chunk would hand
            # a lone fragment to the native decoder and fail confusingly
            raise RuntimeError("section decompressor exhausted")
        if self._native:
            self._parts.append(chunk)
            self._got += len(chunk)
            if self._got >= self._total_in:
                payload = b"".join(self._parts)
                self._parts = []
                self._done = True
                return decompress_section_native(payload, self._total_out)
            return b""
        if self._first:
            chunk = ZSTD_FRAME_MAGIC + chunk
            self._first = False
        return self._obj.decompress(chunk)


def iter_decompress(payload: bytes, chunk_size: int = 1 << 20) -> Iterator[bytes]:
    """Yield decompressed chunks of a magic-stripped section payload."""
    d = SectionDecompressor()
    for off in range(0, len(payload), chunk_size):
        out = d.feed(payload[off:off + chunk_size])
        if out:
            yield out


# ---------------------------------------------------------------------------
# Extended-format blocked sections (tnaf extension, container flag bit 7)
# ---------------------------------------------------------------------------
#
# Payload layout inside the standard section envelope:
#     VLE(n_blocks)  { VLE(raw_len) VLE(comp_len) } x n  frames...
# Each frame is an independent magic-stripped zstd frame, so blocks
# compress AND decompress in parallel (the plain format's single frame
# serializes decompression).  The reference decoder cannot read these
# archives; the header's reserved bit 0x80 marks them (NAF spec §2.4).

def compress_frames(data, level: int = 1, window_log: int = 0,
                    threads: int = 0, block_bytes: int = 4 << 20,
                    engine: str = "zstd") -> tuple[list[int], list[bytes]]:
    """`data` -> (per-frame raw lengths, independent magic-stripped frames).

    The building block shared by the single-host blocked section writer and
    the multi-host extended path (each host frames only its own byte range).
    """
    from concurrent.futures import ThreadPoolExecutor

    mv = memoryview(data)
    n = mv.nbytes
    blocks = [mv[i:i + block_bytes] for i in range(0, n, block_bytes)] or [mv[:0]]
    if engine == "device":
        def one(b):
            return compress_section_device(b, level=level,
                                           window_log=window_log)
    elif engine == "native":
        def one(b):
            return compress_section_native(b, level=level,
                                           window_log=window_log)
    else:
        def one(b):
            return compress_section(b, level=level, window_log=window_log)
    workers = max(1, min(threads or (os.cpu_count() or 1), len(blocks)))
    if workers > 1:
        with ThreadPoolExecutor(workers) as ex:
            frames = list(ex.map(one, blocks))
    else:
        frames = [one(b) for b in blocks]
    return [b.nbytes for b in blocks], frames


def blocked_payload(raw_lens: list[int], frames: list[bytes]) -> bytes:
    """Assemble the blocked-section envelope: VLE index + frames."""
    from ..format.vle import encode_vle

    out = [encode_vle(len(frames))]
    for r, f in zip(raw_lens, frames):
        out.append(encode_vle(r))
        out.append(encode_vle(len(f)))
    out.extend(frames)
    return b"".join(out)


def compress_section_blocked(data, level: int = 1, window_log: int = 0,
                             threads: int = 0,
                             block_bytes: int = 4 << 20,
                             engine: str = "zstd") -> bytes:
    """Compress `data` as independently-framed blocks with an index."""
    raw_lens, frames = compress_frames(
        data, level=level, window_log=window_log, threads=threads,
        block_bytes=block_bytes, engine=engine)
    return blocked_payload(raw_lens, frames)


def parse_blocked_index(payload: bytes):
    """Returns (entries [(raw_len, comp_len)], data_offset)."""
    from ..format.vle import decode_vle

    n, off = decode_vle(payload, 0)
    entries = []
    for _ in range(n):
        r, off = decode_vle(payload, off)
        c, off = decode_vle(payload, off)
        entries.append((r, c))
    return entries, off


def decompress_section_blocked(payload: bytes, uncompressed_size: int,
                               threads: int = 0) -> bytes:
    """Parallel decode of a blocked section payload."""
    from concurrent.futures import ThreadPoolExecutor

    entries, off = parse_blocked_index(payload)
    pieces = []
    for r, c in entries:
        pieces.append((payload[off:off + c], r))
        off += c
    workers = max(1, min(threads or (os.cpu_count() or 1), len(pieces)))
    if workers > 1:
        with ThreadPoolExecutor(workers) as ex:
            outs = list(ex.map(lambda p: decompress_section(*p), pieces))
    else:
        outs = [decompress_section(*p) for p in pieces]
    out = b"".join(outs)
    if len(out) != uncompressed_size:
        raise RuntimeError("blocked section decompression size mismatch")
    return out


# ---------------------------------------------------------------------------
# Native entropy engine (naf_tpu/native/naf_zstd.cpp): the framework's own
# RFC 8878 encoder — greedy LZ77 + Huffman literals + predefined-FSE
# sequences.  Emits standard zstd frames, so archives stay decodable by the
# reference unnaf and by this package's decoder alike.
# ---------------------------------------------------------------------------

def compress_section_native(data, level: int = 1, window_log: int = 0) -> bytes:
    """Compress one section with the native engine; magic-stripped frame.

    ``level`` follows the zstd scale (-131072..22; parity target
    ennaf/src/ennaf.c:216-245); ``window_log`` mirrors ``--long N``
    (compressor.c:7-21): > 0 widens the match window and enables the
    long-distance table.
    """
    import numpy as np

    from .. import native as _native

    lib = _native._load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    if not hasattr(lib, "_naf_zstd_ready"):
        import ctypes as ct

        lib.naf_zstd_compress_ex.restype = ct.c_uint64
        lib.naf_zstd_compress_ex.argtypes = [
            ct.c_void_p, ct.c_uint64, ct.c_void_p, ct.c_uint64,
            ct.c_int32, ct.c_int32]
        lib._naf_zstd_ready = True
    mv = memoryview(data)
    src = np.frombuffer(mv, np.uint8) if mv.nbytes else None
    cap = mv.nbytes + mv.nbytes // 4 + 4096
    dst = np.empty(cap, np.uint8)
    import ctypes as ct

    w = lib.naf_zstd_compress_ex(
        src.ctypes.data_as(ct.c_void_p) if src is not None else None,
        mv.nbytes, dst.ctypes.data_as(ct.c_void_p), cap,
        int(level), int(window_log))
    if w == 0:
        raise RuntimeError("native engine buffer overflow")
    frame = dst[:w].tobytes()
    if frame[:4] != ZSTD_FRAME_MAGIC:
        raise RuntimeError("native engine produced an invalid frame")
    return frame[4:]


def _part_lib():
    """Native lib with the part-compression ABI bound (idempotent)."""
    import ctypes as ct

    from .. import native as _native

    lib = _native._load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    if not hasattr(lib, "_naf_zstd_part_ready"):
        lib.naf_zstd_compress_part.restype = ct.c_uint64
        lib.naf_zstd_compress_part.argtypes = [
            ct.c_void_p, ct.c_uint64, ct.c_void_p, ct.c_uint64,
            ct.c_int32, ct.c_int32]
        lib.naf_zstd_window_log_for.restype = ct.c_int32
        lib.naf_zstd_window_log_for.argtypes = [ct.c_int32, ct.c_int32]
        lib._naf_zstd_part_ready = True
    return lib


def compress_part_native(data, level: int = 1, window_log: int = 0) -> bytes:
    """One PART of a stitched single frame: a bare zstd block chain.

    No frame header, no last-block bit, fresh (invalid) rep-offset state —
    the chain decodes identically after any predecessor, so independent
    parts compressed on different threads/hosts stitch into ONE valid
    frame (``stitch_section_frame``).  Empty input -> empty chain.
    """
    import ctypes as ct

    import numpy as np

    lib = _part_lib()
    mv = memoryview(data)
    if mv.nbytes == 0:
        return b""
    src = np.frombuffer(mv, np.uint8)
    cap = mv.nbytes + mv.nbytes // 4 + 4096
    dst = np.empty(cap, np.uint8)
    w = lib.naf_zstd_compress_part(
        src.ctypes.data_as(ct.c_void_p), mv.nbytes,
        dst.ctypes.data_as(ct.c_void_p), cap, int(level), int(window_log))
    if w == 0:
        raise RuntimeError("native engine buffer overflow")
    return dst[:w].tobytes()


def _window_descriptor(window: int) -> int:
    """Smallest zstd Window_Descriptor byte covering ``window`` bytes."""
    for exp in range(0, 32):
        base = 1 << (10 + exp)
        for mantissa in range(8):
            if base + (base >> 3) * mantissa >= window:
                return (exp << 3) | mantissa
    return (21 << 3)                      # 2 GB — unreachable in practice


def stitch_section_frame(chains, part_sizes, level: int = 1,
                         window_log: int = 0) -> bytes:
    """Per-part block chains -> ONE magic-stripped zstd frame.

    ``chains[i]`` is ``compress_part_native(parts[i])``; ``part_sizes[i]``
    the part's uncompressed length.  The frame = header (window sized to
    the largest possible offset: min(max part, the level's match window))
    + concatenated chains + an empty raw last block.  This is SURVEY
    §2.4's single-frame block stitching: the reference decoder injects
    exactly one frame magic per section (unnaf/src/input.c:278), so the
    only parallel-compression layout it can decode is independent blocks
    inside one frame.
    """
    lib = _part_lib()
    total = sum(int(s) for s in part_sizes)
    max_part = max((int(s) for s in part_sizes), default=0)
    wlog = int(lib.naf_zstd_window_log_for(int(level), int(window_log)))
    window = min(max_part, 1 << wlog) if max_part else 1024
    out = bytearray()
    out.append(0xC0)                      # FCS_Flag=3 (8B), no flags
    out.append(_window_descriptor(window))
    out += int(total).to_bytes(8, "little")
    for ch in chains:
        out += ch
    out += b"\x01\x00\x00"                # empty raw block, last-bit set
    return bytes(out)


def compress_section_parts(parts, level: int = 1, window_log: int = 0,
                           threads: int = 0) -> bytes:
    """Thread-parallel single-frame compression of independent parts.

    Returns a magic-stripped frame decodable by the reference ``unnaf``,
    our library path, and the native decoder alike.  ``threads`` caps the
    pool (0 = cpu count); the ctypes calls release the GIL, so parts
    genuinely compress in parallel.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    parts = [memoryview(p) for p in parts]
    sizes = [p.nbytes for p in parts]
    n_workers = min(len(parts) or 1, threads or os.cpu_count() or 1)
    if n_workers > 1:
        with ThreadPoolExecutor(n_workers) as ex:
            chains = list(ex.map(
                lambda p: compress_part_native(p, level, window_log), parts))
    else:
        chains = [compress_part_native(p, level, window_log) for p in parts]
    return stitch_section_frame(chains, sizes, level, window_log)


def _device_chain_depth(level: int) -> int:
    """`-#` -> candidate chain depth proposed per position (the device
    analog of cfg_for's chain-log ladder, naf_zstd.cpp:852)."""
    if level <= 2:
        return 2
    if level <= 12:
        return 4
    if level <= 18:
        return 8
    return 16


def compress_section_device(data, level: int = 1, window_log: int = 0,
                            k: int = 0) -> bytes:
    """Device-scored match candidates + host bitstream packing.

    The JAX kernel (ops.matchfind) computes the top-k match-candidate chain
    per position in parallel (gather + hash + device sort); the native
    serializer verifies, extends, scores (incl. repeat offsets) and packs
    them into a standard zstd frame.  This is the device/host split of
    SURVEY §7 step 6 running end to end; reachable as ``tnaf --engine
    device``.

    Memory is bounded: candidates are generated per 4 MB span over a
    sliding history window (O(span + history) device bytes regardless of
    section size) and serialized incrementally into one frame
    (``naf_zstd_compress_cand_stream``).  ``level`` selects the chain depth
    (parity: ennaf -#); ``window_log`` widens the history AND adds a
    long-distance anchor pass (parity: ennaf --long,
    ennaf/src/compressor.c:7-21).
    """
    import ctypes as ct

    import numpy as np

    from .. import native as _native
    from ..ops.matchfind import (
        SPAN, find_ldm_candidates, find_match_candidates_windowed)

    mv = memoryview(data)
    if mv.nbytes >= 1 << 31:
        # the device candidate ABI carries int32 absolute positions
        # (ops/matchfind.py); >= 2 GiB sections would wrap negative and
        # silently drop every candidate — the native engine covers this
        # regime at full fidelity instead
        return compress_section_native(data, level=level,
                                       window_log=window_log)
    k = k or _device_chain_depth(level)
    lib = _native._load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    if not hasattr(lib, "_naf_zstd_cand_stream_ready"):
        lib.naf_zstd_compress_cand_stream.restype = ct.c_uint64
        lib.naf_zstd_compress_cand_stream.argtypes = [
            ct.c_void_p, ct.c_uint64, ct.c_uint64, ct.c_uint64,
            ct.c_void_p, ct.c_int32, ct.c_void_p,
            ct.c_void_p, ct.c_uint64]
        lib._naf_zstd_cand_stream_ready = True
    arr = np.frombuffer(memoryview(data), np.uint8)
    n = arr.size
    cap = n + n // 4 + 4096
    dst = np.empty(cap, np.uint8)
    rep = np.array([1, 4, 8], np.uint32)
    hist = SPAN
    if window_log:
        hist = max(hist, min(1 << window_log, 64 << 20))
    w = 0
    if n == 0:
        w = lib.naf_zstd_compress_cand_stream(
            None, 0, 0, 0, None, k, rep.ctypes.data_as(ct.c_void_p),
            dst.ctypes.data_as(ct.c_void_p), cap)
        if w == 0:
            raise RuntimeError("device engine buffer overflow")
    for lo in range(0, n, SPAN):
        hi = min(lo + SPAN, n)
        cand = find_match_candidates_windowed(arr, k, lo, hi, hist=hist)
        if window_log:
            ldm = find_ldm_candidates(
                arr, lo, hi, hist=min(1 << window_log, 128 << 20))
            cand = np.concatenate([cand, ldm[:, None]], axis=1)
        cand = np.ascontiguousarray(cand)
        wrote = lib.naf_zstd_compress_cand_stream(
            arr.ctypes.data_as(ct.c_void_p), n, lo, hi,
            cand.ctypes.data_as(ct.c_void_p), cand.shape[1],
            rep.ctypes.data_as(ct.c_void_p),
            ct.c_void_p(dst.ctypes.data + w), cap - w)
        if wrote == 0:
            raise RuntimeError("device engine buffer overflow")
        w += wrote
    frame = dst[:w].tobytes()
    if frame[:4] != ZSTD_FRAME_MAGIC:
        raise RuntimeError("device engine produced an invalid frame")
    return frame[4:]


# ---------------------------------------------------------------------------
# Temp-file spill (parity: ennaf/src/compressor.c:51-61 — compressed section
# output beyond a RAM threshold goes to a temp file and is streamed back
# during container assembly)
# ---------------------------------------------------------------------------

class SpilledPayload:
    """Magic-stripped section bytes living in a temp file."""

    def __init__(self, path: str, size: int, keep: bool):
        self.path = path
        self._size = size
        self._keep = keep

    def __len__(self) -> int:
        return self._size

    def copy_into(self, out) -> None:
        with open(self.path, "rb") as f:
            f.seek(4)                      # skip the stored frame magic
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        if not self._keep:
            try:
                os.unlink(self.path)
            except OSError:
                pass


#: In-RAM budget per compressed section before spilling to the temp dir.
#: The reference always spills beyond its 2 MB buffers (compressor.c:51-61);
#: holding up to 256 MB of *compressed* bytes avoids the extra
#: write+read+unlink round trip for typical inputs (override: NAF_TPU_SPILL_MB).
_SPILL_THRESHOLD = int(os.environ.get("NAF_TPU_SPILL_MB", "256")) << 20


class SpillingSectionCompressor(SectionCompressor):
    """SectionCompressor that spills compressed output beyond a threshold.

    Temp file naming mirrors the reference (`<prefix>.<section>` in the
    temp dir, `--keep-temp-files` keeps them; files.c:69-103).
    """

    def __init__(self, level: int = 1, window_log: int = 0, threads: int = 0,
                 *, temp_dir: str, name: str, section: str,
                 threshold: int = _SPILL_THRESHOLD, keep: bool = False):
        super().__init__(level, window_log, threads)
        self._path = os.path.join(temp_dir, f"{name}.{section}")
        self._threshold = threshold
        self._keep = keep
        self._file = None
        self._spilled = 0

    def _maybe_spill(self) -> None:
        if self._file is None and self._spilled + self._pending < self._threshold:
            return
        if self._file is None:
            self._file = open(self._path, "wb")
        for c in self._chunks:
            self._file.write(c)
            self._spilled += len(c)
        self._chunks.clear()
        self._pending = 0

    def write(self, data) -> None:
        super().write(data)
        self._maybe_spill()

    def finish(self):
        """bytes when everything stayed in RAM, else a SpilledPayload."""
        assert not self._finished
        self._finished = True
        if self._raw is not None:           # sub-_STAGE payload: never spills
            frame = self._finish_oneshot()
            if len(frame) < 4 or frame[:4] != ZSTD_FRAME_MAGIC:
                raise RuntimeError("compression failed")
            return frame[4:]
        if self._buf:                       # drain MT staging remainder
            self._emit(self._obj.compress(self._buf))
            self._buf = bytearray()
        tail = self._obj.flush_finish()
        if tail:
            self._chunks.append(tail)
        if self._file is None:
            frame = b"".join(self._chunks)
            self._chunks = []
            self._pending = 0
            if len(frame) < 4 or frame[:4] != ZSTD_FRAME_MAGIC:
                raise RuntimeError("compression failed")
            return frame[4:]
        for c in self._chunks:
            self._file.write(c)
            self._spilled += len(c)
        self._chunks = []
        self._pending = 0
        self._file.close()
        self._file = None
        # strip the 4-byte magic by rewriting the head in place
        with open(self._path, "r+b") as f:
            head = f.read(4)
            if head != ZSTD_FRAME_MAGIC:
                raise RuntimeError("compression failed")
        return SpilledPayload(self._path, self._spilled - 4, self._keep)
