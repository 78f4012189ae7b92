"""ctypes binding to the SYSTEM libzstd: section compression and
decompression.

The reference binaries link the system libzstd, so binding the same library
keeps ratio parity with them at every level, and replicates ennaf's exact
call shape (ennaf/src/compressor.c:7-21: setParameter(LDM, windowLog) then
level, streamed).  It is also the only entropy library the default engine
needs: no Python zstd package is imported on the main path.

``load()`` returns None when no system libzstd is available; ``require()``
raises ``LibzstdMissing`` then, whose message names the self-contained
``--engine native`` alternative.
"""

from __future__ import annotations

import ctypes as ct
import ctypes.util
import threading
from typing import Optional

# stable public ZSTD_cParameter / ZSTD_EndDirective enum values
_C_LEVEL = 100
_C_WINDOWLOG = 101
_C_ENABLE_LDM = 160
_C_CONTENTSIZE = 200
_C_NBWORKERS = 400
_E_CONTINUE = 0
_E_END = 2
_D_WINDOWLOG_MAX = 100
_WINDOWLOG_MAX = 31

_lib = None
_loaded = False
_lock = threading.Lock()


def load():
    """The system libzstd handle, or None (memoized; section compressors
    call this from several threads at once)."""
    global _lib, _loaded
    with _lock:
        if not _loaded:
            _lib = _open()
            _loaded = True
    return _lib


def _open():
    path = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ct.CDLL(path)
        lib.ZSTD_versionNumber.restype = ct.c_uint
        if lib.ZSTD_versionNumber() < 10400:   # needs ZSTD_compressStream2
            return None
        lib.ZSTD_createCCtx.restype = ct.c_void_p
        lib.ZSTD_freeCCtx.argtypes = [ct.c_void_p]
        lib.ZSTD_CCtx_setParameter.restype = ct.c_size_t
        lib.ZSTD_CCtx_setParameter.argtypes = [ct.c_void_p, ct.c_int, ct.c_int]
        lib.ZSTD_CCtx_setPledgedSrcSize.restype = ct.c_size_t
        lib.ZSTD_CCtx_setPledgedSrcSize.argtypes = [ct.c_void_p, ct.c_ulonglong]
        lib.ZSTD_compressStream2.restype = ct.c_size_t
        lib.ZSTD_compressStream2.argtypes = [ct.c_void_p, ct.c_void_p,
                                             ct.c_void_p, ct.c_int]
        lib.ZSTD_isError.restype = ct.c_uint
        lib.ZSTD_isError.argtypes = [ct.c_size_t]
        lib.ZSTD_CStreamOutSize.restype = ct.c_size_t
        lib.ZSTD_createDCtx.restype = ct.c_void_p
        lib.ZSTD_freeDCtx.argtypes = [ct.c_void_p]
        lib.ZSTD_DCtx_setParameter.restype = ct.c_size_t
        lib.ZSTD_DCtx_setParameter.argtypes = [ct.c_void_p, ct.c_int, ct.c_int]
        lib.ZSTD_decompressStream.restype = ct.c_size_t
        lib.ZSTD_decompressStream.argtypes = [ct.c_void_p, ct.c_void_p,
                                              ct.c_void_p]
        lib.ZSTD_DStreamOutSize.restype = ct.c_size_t
    except OSError:
        return None
    return lib


class LibzstdMissing(RuntimeError):
    """No usable system libzstd (>= 1.4) for the default 'zstd' engine."""


def require():
    """The system libzstd handle; raises LibzstdMissing when absent."""
    handle = load()
    if handle is None:
        raise LibzstdMissing(
            "system libzstd (>= 1.4) not found; install it, or use "
            "--engine native (the built-in zstd engine)")
    return handle


class _Buf(ct.Structure):          # ZSTD_outBuffer / ZSTD_inBuffer layout
    _fields_ = [("dst", ct.c_void_p), ("size", ct.c_size_t),
                ("pos", ct.c_size_t)]


class SysZstdCompressor:
    """Streaming single-frame compressor over the system libzstd.

    The surface SectionCompressor uses: ``compress(data) -> bytes`` and
    ``flush_finish() -> bytes``.
    ``pledged_size`` turns on one-shot-style window/table right-sizing and
    a content-size header (used by the buffered small-section path).
    """

    def __init__(self, level: int, window_log: int = 0, threads: int = 0,
                 pledged_size: Optional[int] = None):
        self._lib = lib = require()
        self._cctx = lib.ZSTD_createCCtx()
        if not self._cctx:
            raise MemoryError("ZSTD_createCCtx failed")

        def setp(param, value):
            r = lib.ZSTD_CCtx_setParameter(self._cctx, param, value)
            if lib.ZSTD_isError(r):
                raise RuntimeError(f"ZSTD_CCtx_setParameter({param}) failed")

        # ennaf order: LDM + windowLog first, then level (compressor.c:7-21)
        if window_log:
            setp(_C_ENABLE_LDM, 1)
            setp(_C_WINDOWLOG, window_log)
        setp(_C_LEVEL, level)
        if threads:
            setp(_C_NBWORKERS, threads)
        if pledged_size is not None:
            r = lib.ZSTD_CCtx_setPledgedSrcSize(self._cctx, pledged_size)
            if lib.ZSTD_isError(r):
                raise RuntimeError("ZSTD_CCtx_setPledgedSrcSize failed")
        else:
            setp(_C_CONTENTSIZE, 0)    # streaming: no content-size header
        self._out_cap = max(int(lib.ZSTD_CStreamOutSize()), 1 << 17)
        self._outbuf = ct.create_string_buffer(self._out_cap)

    def __del__(self):
        cctx = getattr(self, "_cctx", None)
        if cctx:
            self._lib.ZSTD_freeCCtx(cctx)
            self._cctx = None

    def _pump(self, src, n: int, end_op: int) -> bytes:
        lib = self._lib
        inb = _Buf(ct.cast(src, ct.c_void_p), n, 0)
        chunks = []
        while True:
            outb = _Buf(ct.cast(self._outbuf, ct.c_void_p), self._out_cap, 0)
            r = lib.ZSTD_compressStream2(self._cctx, ct.byref(outb),
                                         ct.byref(inb), end_op)
            if lib.ZSTD_isError(r):
                raise RuntimeError("ZSTD_compressStream2 failed")
            if outb.pos:
                chunks.append(self._outbuf.raw[:outb.pos])
            if end_op == _E_END:
                if r == 0:
                    break
            elif inb.pos == inb.size:
                break
        return b"".join(chunks)

    def compress(self, data) -> bytes:
        mv = memoryview(data)
        if mv.nbytes == 0:
            return b""
        if mv.format != "B":
            mv = mv.cast("B")
        if not mv.readonly:                      # numpy scratch: zero-copy
            arr = (ct.c_char * mv.nbytes).from_buffer(mv)
            return self._pump(arr, mv.nbytes, _E_CONTINUE)
        if isinstance(data, bytes):              # bytes object: zero-copy
            return self._pump(ct.c_char_p(data), mv.nbytes, _E_CONTINUE)
        return self._pump(ct.c_char_p(bytes(mv)), mv.nbytes, _E_CONTINUE)

    def flush_finish(self) -> bytes:
        return self._pump(ct.c_char_p(b""), 0, _E_END)


def compress_oneshot(payload: bytes, level: int, window_log: int = 0) -> bytes:
    """One frame with pledged source size (window right-sized by libzstd)."""
    c = SysZstdCompressor(level, window_log=window_log,
                          pledged_size=len(payload))
    head = c.compress(payload)
    return head + c.flush_finish()


class SysZstdDecompressor:
    """Streaming decoder of one zstd frame (windows up to 2^31 bytes, the
    largest ``--long`` the encoder writes).  ``decompress(chunk)`` returns
    the bytes decoded so far from the fed input."""

    def __init__(self):
        handle = require()
        self._lib = handle
        self._dctx = handle.ZSTD_createDCtx()
        if not self._dctx:
            raise MemoryError("ZSTD_createDCtx failed")
        r = handle.ZSTD_DCtx_setParameter(self._dctx, _D_WINDOWLOG_MAX,
                                          _WINDOWLOG_MAX)
        if handle.ZSTD_isError(r):
            raise RuntimeError("ZSTD_DCtx_setParameter(windowLogMax) failed")
        self._out_cap = max(int(handle.ZSTD_DStreamOutSize()), 1 << 17)
        self._outbuf = ct.create_string_buffer(self._out_cap)
        self.finished = False

    def __del__(self):
        dctx = getattr(self, "_dctx", None)
        if dctx:
            self._lib.ZSTD_freeDCtx(dctx)
            self._dctx = None

    def decompress(self, data) -> bytes:
        data = bytes(data)
        inb = _Buf(ct.cast(ct.c_char_p(data), ct.c_void_p), len(data), 0)
        chunks = []
        while True:
            outb = _Buf(ct.cast(self._outbuf, ct.c_void_p), self._out_cap, 0)
            r = self._lib.ZSTD_decompressStream(self._dctx, ct.byref(outb),
                                                ct.byref(inb))
            if self._lib.ZSTD_isError(r):
                raise RuntimeError("corrupt zstd stream")
            if outb.pos:
                chunks.append(self._outbuf.raw[:outb.pos])
            if r == 0:
                self.finished = True
                break
            if inb.pos == inb.size and outb.pos < self._out_cap:
                break
        return b"".join(chunks)


def decompress(frame: bytes, size: int) -> bytes:
    """Decode one complete frame whose decoded size is known to be ``size``
    (NAF stores every section's original size)."""
    handle = require()
    dctx = handle.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        r = handle.ZSTD_DCtx_setParameter(dctx, _D_WINDOWLOG_MAX,
                                          _WINDOWLOG_MAX)
        if handle.ZSTD_isError(r):
            raise RuntimeError("ZSTD_DCtx_setParameter(windowLogMax) failed")
        # one spare byte: a frame that decodes to more than ``size`` fills
        # it instead of stopping silently at the cap
        out = ct.create_string_buffer(size + 1)
        src = bytes(frame)
        inb = _Buf(ct.cast(ct.c_char_p(src), ct.c_void_p), len(src), 0)
        outb = _Buf(ct.cast(out, ct.c_void_p), size + 1, 0)
        while True:
            r = handle.ZSTD_decompressStream(dctx, ct.byref(outb),
                                             ct.byref(inb))
            if handle.ZSTD_isError(r):
                raise RuntimeError("corrupt zstd stream")
            if r == 0 or outb.pos > size or inb.pos == inb.size:
                break
        if r != 0 or outb.pos != size:
            raise RuntimeError("section decompression size mismatch")
        return out.raw[:size]
    finally:
        handle.ZSTD_freeDCtx(dctx)
