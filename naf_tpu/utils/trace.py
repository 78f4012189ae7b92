"""Lightweight stage tracing / profiling.

The reference has only ``--verbose`` progress messages (SURVEY §5); this
subsystem adds:

  * ``NAF_TPU_TRACE=1``   — per-stage wall times + byte counts to stderr
    (scan, section zstd, section unzstd, render, container, and the
    ``device-*`` stages with the platform they ran on); a ``--device`` CLI
    run closes with one ``device`` line: platform, compile seconds and
    peak device memory;
  * ``NAF_TPU_PROFILE=dir`` — wraps a ``--device`` CLI run in a JAX
    profiler trace (produces a TensorBoard/Perfetto trace in `dir`).

Usage::

    with trace_span("scan", bytes=len(piece)):
        ...

Zero overhead when disabled (module-level flag check).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

ENABLED = bool(os.environ.get("NAF_TPU_TRACE"))
_PROFILE_DIR = os.environ.get("NAF_TPU_PROFILE")

_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


def _emit(stage: str, text: str) -> None:
    print(f"[naf-trace] {stage:<16} {text}", file=sys.stderr)


@contextlib.contextmanager
def trace_span(stage: str, **fields):
    """Time a pipeline stage; prints '[naf-trace] stage 12.3ms k=v' when on."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = (time.perf_counter() - t0) * 1e3
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        mbs = ""
        if "bytes" in fields and dt > 0:
            mbs = f" ({fields['bytes'] / dt / 1048.576:.0f} MB/s)"
        _emit(stage, f"{dt:9.2f} ms{mbs} {extra}")


def trace_note(stage: str, **fields) -> None:
    """One '[naf-trace] stage k=v ...' line (counters, not timings)."""
    if ENABLED:
        _emit(stage, " ".join(f"{k}={v}" for k, v in fields.items()))


@contextlib.contextmanager
def device_session():
    """Wrap a CLI's ``--device`` work: a JAX profiler trace when
    NAF_TPU_PROFILE is set; with NAF_TPU_TRACE, a closing ``device`` line
    with the summed XLA compile seconds and the peak device memory."""
    import jax

    compile_s = [0.0]
    if ENABLED:
        def on_event(event, duration, **_kw):
            if event == _COMPILE_EVENT:
                compile_s[0] += duration

        jax.monitoring.register_event_duration_secs_listener(on_event)
    if _PROFILE_DIR:
        jax.profiler.start_trace(_PROFILE_DIR)
    try:
        yield
    finally:
        if _PROFILE_DIR:
            jax.profiler.stop_trace()
        if ENABLED:
            d = jax.devices()[0]
            peak = (d.memory_stats() or {}).get("peak_bytes_in_use")
            trace_note("device", platform=d.platform,
                       kind=repr(d.device_kind), compile_s=compile_s[0],
                       peak_bytes_in_use=peak)
