"""Device-sharded decode: NAF sections -> rendered FASTA/FASTQ bytes.

Data-parallel redesign of the reference's streaming renderers
(unnaf/src/output.c:433-512 hot loop, output.c:608-674 print_fasta,
output-fastq.c:100-149 print_fastq): instead of a per-record state machine,
rendering is a *pure function from output byte position to source byte*:

    out[p] = header_blob[...]            if p falls in a record's header
           = code_to_char(packed nibble) if p is a sequence char
             (+32 when its char index lies inside a masked span)
           = qual[...]                   if p is a quality char (FASTQ)
           = '\n' / '+'                  at the computed wrap positions

All the structure lookups are searchsorted gathers over per-record prefix
sums (record out-ends, char-ends, header-ends), so the whole output stream
renders as one embarrassingly-parallel gather program: the output range is
cut into equal chunks, one per device in the mesh, each device renders its
chunk from its slice of the packed stream plus small replicated metadata.
No collectives are needed at all — decode is pure fan-out.

Large archives render in bounded batches (records and char/out offsets are
rebased per batch, keeping every device-side index within int32 and the
replicated metadata small); batch and chunk sizes are bucketed to keep the
number of distinct compiled shapes O(log n).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils.lazy import LazyModule

jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")

from ..format import constants as C
from ..ops.render import body_length
from ..utils.trace import trace_span

MODE_FASTA = 0
MODE_FASTQ = 1


class RenderOverflow(Exception):
    """A single record's output/char/header span exceeds the int32-rebased
    device batch window; the caller should use the host renderer instead."""

#: output bytes rendered per device batch step (before the D-way split).
OUT_BATCH = int(__import__("os").environ.get("NAF_TPU_DECODE_BATCH_MB", "256")) << 20


def _bucket(n: int, align: int = 128) -> int:
    m = align
    while m < n:
        m *= 2
    return m


# ---------------------------------------------------------------------------
# Host-side metadata
# ---------------------------------------------------------------------------

@dataclass
class RenderPlan:
    """Per-archive render metadata (host numpy, O(n_records))."""

    mode: int
    line_len: int
    rna: bool
    packed: bool            # nucleotide 4-bit stream (else raw text bytes)
    upper: bool             # uppercase raw text (mask ignored)
    slens: np.ndarray       # i64[N] sequence length per record
    E: np.ndarray           # i64[N] cumsum char ends
    O: np.ndarray           # i64[N] cumsum output ends (header+body)
    H: np.ndarray           # i64[N] cumsum header-blob ends
    hdr: np.ndarray         # u8[sum hdr lens] concatenated header lines
    bounds: np.ndarray      # i64[2M] flattened masked-span bounds (sorted)
    total_out: int


def build_plan(*, mode: int, line_len: int, rna: bool, packed: bool,
               upper: bool, slens: np.ndarray,
               ids_blob: Optional[bytes], comments_blob: Optional[bytes],
               name_sep: bytes, mask_spans=None) -> RenderPlan:
    """Precompute the prefix sums + header blob driving the gather program."""
    from ..ops.assemble import Column, const_column, ragged_concat, split_blob

    slens = np.asarray(slens, dtype=np.int64)
    n = slens.size
    E = np.cumsum(slens)

    lead = b"@" if mode == MODE_FASTQ else b">"
    cols = [const_column(lead, n)]
    if ids_blob is not None and comments_blob is not None:
        idc = split_blob(ids_blob, n)
        com = split_blob(comments_blob, n, "names")
        cols += [idc, const_column(name_sep, n, present=com.length > 0), com]
    elif ids_blob is not None:
        cols.append(split_blob(ids_blob, n))
    elif comments_blob is not None:
        cols.append(split_blob(comments_blob, n, "names"))
    cols.append(const_column(b"\n", n))
    hdr = ragged_concat(cols, n)
    hlens = np.zeros(n, np.int64)
    for c in cols:
        hlens += np.broadcast_to(np.asarray(c.length, np.int64), (n,))
    H = np.cumsum(hlens)

    if mode == MODE_FASTQ:
        blens = 2 * slens + 4
    else:
        blens = body_length(slens, line_len).astype(np.int64)
    O = np.cumsum(hlens + blens)

    if mask_spans is not None and mask_spans[0].size:
        starts, ends = mask_spans
        bounds = np.empty(2 * starts.size, np.int64)
        bounds[0::2] = starts
        bounds[1::2] = ends
    else:
        bounds = np.zeros(0, np.int64)

    return RenderPlan(mode=mode, line_len=line_len, rna=rna, packed=packed,
                      upper=upper, slens=slens, E=E, O=O, H=H, hdr=hdr,
                      bounds=bounds, total_out=int(O[-1]) if n else 0)


def _next_seq_char(plan: RenderPlan, p: int) -> int:
    """Char index of the first sequence-char gather at out position >= p."""
    if p >= plan.total_out:
        return int(plan.E[-1]) if plan.E.size else 0
    r = int(np.searchsorted(plan.O, p, side="right"))
    rec_out = int(plan.O[r - 1]) if r > 0 else 0
    e_prev = int(plan.E[r - 1]) if r > 0 else 0
    sl = int(plan.slens[r])
    q = p - rec_out
    hl = int(plan.H[r] - (plan.H[r - 1] if r > 0 else 0))
    if q <= hl:
        return e_prev
    u = q - hl
    if plan.mode == MODE_FASTQ:
        return e_prev + min(u, sl) if u <= sl else int(plan.E[r])
    L = plan.line_len
    src = u - u // (L + 1) if L > 0 else u
    return e_prev + min(src, sl)


def _next_qual_char(plan: RenderPlan, p: int) -> int:
    """Char index of the first quality gather at out position >= p (FASTQ)."""
    if p >= plan.total_out:
        return int(plan.E[-1]) if plan.E.size else 0
    r = int(np.searchsorted(plan.O, p, side="right"))
    rec_out = int(plan.O[r - 1]) if r > 0 else 0
    e_prev = int(plan.E[r - 1]) if r > 0 else 0
    sl = int(plan.slens[r])
    q = p - rec_out
    hl = int(plan.H[r] - (plan.H[r - 1] if r > 0 else 0))
    u = q - hl
    if u <= sl + 3:
        return e_prev
    return e_prev + min(u - sl - 3, sl)


# ---------------------------------------------------------------------------
# Device kernel
# ---------------------------------------------------------------------------

def _code_to_char_i32(codes, rna: bool):
    chars = C.CODE_TO_NUC_RNA if rna else C.CODE_TO_NUC_DNA
    out = jnp.full_like(codes, int(chars[15]))
    for code in range(15):
        out = jnp.where(codes == code, int(chars[code]), out)
    return out


def _make_kernel(Osz: int, mode: int, line_len: int, rna: bool, packed: bool,
                 upper: bool, masking: bool):
    """Kernel: render output positions [o0, o0+Osz).  i32 batch-rebased math.

    seq: u8[S] packed nibbles (or raw text bytes); qual: u8[Q] or u8[1];
    scalars: i32[4] = (o0 out start, c0 seq-char base, q0 qual-char base, -);
    E/O/H: i32[R] rebased prefix sums; hdr: u8[Hn]; bounds: i32[2M].

    Gather-minimal formulation: the reference version (_make_kernel_ref)
    does ~8 per-output-byte gathers/searchsorteds.  Here every per-record/
    metadata lookup becomes a SMALL scatter from the table side plus a
    segment-broadcast max-scan (the record prefix sums are non-decreasing),
    header bytes scatter from the hdr blob side, and mask parity comes from
    toggle scatters + a prefix sum.  Only the sequence-nibble (and FASTQ
    quality) data gathers remain per-byte.
    """
    from ..ops import scan as S

    L = line_len
    _NEG = -(1 << 30)

    def _bcast(seed, sidx, valid, vals, n):
        """Segment-broadcast: vals at record-start positions (non-
        decreasing), `seed` before the first in-chunk start."""
        arr = jnp.full(n, _NEG, jnp.int32).at[0].set(seed)
        arr = arr.at[jnp.where(valid, sidx, n)].max(vals, mode="drop")
        return S.maxscan_i32(arr)

    def kernel(seq, qual, scalars, E, O, H, hdr, bounds):
        o0, c0, q0 = scalars[0], scalars[1], scalars[2]
        R = E.shape[0]
        pos = o0 + jnp.arange(Osz, dtype=jnp.int32)
        starts = jnp.concatenate([jnp.zeros(1, jnp.int32), O[:-1]])
        Eprev = jnp.concatenate([jnp.zeros(1, jnp.int32), E[:-1]])
        Hprev = jnp.concatenate([jnp.zeros(1, jnp.int32), H[:-1]])

        # incoming record (covers chunk start) — all r_cap-small ops
        r0 = jnp.clip(jnp.sum((starts <= o0).astype(jnp.int32)) - 1, 0,
                      R - 1)
        sidx = starts - o0
        valid = (sidx >= 0) & (sidx < Osz)

        o_prev = _bcast(starts[r0], sidx, valid, starts, Osz) - o0
        e_prev = _bcast(Eprev[r0], sidx, valid, Eprev, Osz)
        h_prev = _bcast(Hprev[r0], sidx, valid, Hprev, Osz)
        E_r = _bcast(E[r0], sidx, valid, E, Osz)
        H_r = _bcast(H[r0], sidx, valid, H, Osz)

        q = pos - o0 - o_prev
        hl = H_r - h_prev
        sl = E_r - e_prev
        in_hdr = q < hl
        u = q - hl

        # header bytes scatter from the blob side (hn-small): hdr byte k
        # lands at its record's out start + offset
        hn = hdr.shape[0]
        k = jnp.arange(hn, dtype=jnp.int32)
        rk = jnp.searchsorted(H, k, side="right").astype(jnp.int32)
        rk = jnp.minimum(rk, R - 1)
        hk_prev = jnp.where(rk > 0, H[jnp.maximum(rk - 1, 0)], 0)
        out_pos = jnp.where(rk < R, starts[rk], 1 << 30) + (k - hk_prev) - o0
        out_pos = jnp.where((out_pos >= 0) & (out_pos < Osz), out_pos, Osz)
        hdr_at = jnp.zeros(Osz, jnp.uint8).at[out_pos].set(hdr, mode="drop")

        def char_at(idx):
            if packed:
                kk = idx - c0
                byte = seq[jnp.clip(kk >> 1, 0, seq.shape[0] - 1)]
                nib = jnp.where((kk & 1) == 1, byte >> 4,
                                byte & 15).astype(jnp.int32)
                ch = _code_to_char_i32(nib, rna)
            else:
                kk = idx - c0
                ch = seq[jnp.clip(kk, 0, seq.shape[0] - 1)].astype(jnp.int32)
                if upper:
                    is_lo = (ch >= ord("a")) & (ch <= ord("z"))
                    ch = jnp.where(is_lo, ch - 32, ch)
            if masking:
                # mask parity by toggle scatter (M-small): each bound's
                # char index maps to its out position; chars after it flip
                b = bounds
                rb = jnp.searchsorted(E, b, side="right").astype(jnp.int32)
                rb = jnp.minimum(rb, R - 1)
                eb = jnp.where(rb > 0, E[jnp.maximum(rb - 1, 0)], 0)
                hb = H[rb] - jnp.where(rb > 0, H[jnp.maximum(rb - 1, 0)], 0)
                c_in = b - eb
                if mode == MODE_FASTQ:
                    body_off = c_in
                else:
                    body_off = c_in + (c_in // L if L > 0 else 0)
                tpos = jnp.where(rb < R, starts[rb], 1 << 30) \
                    + hb + body_off - o0
                base_par = jnp.sum(((tpos < 0) & (b < (1 << 29))
                                    ).astype(jnp.int32))
                tpos = jnp.where((tpos >= 0) & (tpos < Osz), tpos, Osz)
                tog = jnp.zeros(Osz, jnp.int32).at[tpos].add(
                    1, mode="drop")
                parity = (S.cumsum_i32(tog) + base_par) & 1
                ch = ch + 32 * parity
            return ch

        if mode == MODE_FASTQ:
            in_seq = u < sl
            in_qual = (u >= sl + 3) & (u < 2 * sl + 3)
            seq_ch = char_at(e_prev + jnp.clip(u, 0, sl))
            qk = e_prev + jnp.clip(u - sl - 3, 0, sl) - q0
            qual_ch = qual[jnp.clip(qk, 0, qual.shape[0] - 1)].astype(
                jnp.int32)
            sep_ch = jnp.where(u == sl + 1, ord("+"), ord("\n"))
            body = jnp.where(in_seq, seq_ch,
                             jnp.where(in_qual, qual_ch, sep_ch))
        else:
            if L > 0:
                blen = jnp.where(sl > 0, sl + (sl + L - 1) // L, 0)
                is_nl = (((u + 1) % (L + 1)) == 0) | (u == blen - 1)
                src = u - u // (L + 1)
            else:
                is_nl = u == sl
                src = u
            ch = char_at(e_prev + jnp.clip(src, 0, sl))
            body = jnp.where(is_nl, ord("\n"), ch)

        out = jnp.where(in_hdr, hdr_at.astype(jnp.int32), body)
        return out.astype(jnp.uint8)

    return kernel


def _make_kernel_ref(Osz: int, mode: int, line_len: int, rna: bool,
                     packed: bool, upper: bool, masking: bool):
    """Reference formulation (per-byte gathers/searchsorteds) — the oracle
    the gather-minimal kernel is tested against."""
    L = line_len

    def kernel(seq, qual, scalars, E, O, H, hdr, bounds):
        o0, c0, q0 = scalars[0], scalars[1], scalars[2]
        R = E.shape[0]
        pos = o0 + jnp.arange(Osz, dtype=jnp.int32)
        r = jnp.searchsorted(O, pos, side="right").astype(jnp.int32)
        r = jnp.minimum(r, R - 1)
        rprev = jnp.maximum(r - 1, 0)
        o_prev = jnp.where(r > 0, O[rprev], 0)
        e_prev = jnp.where(r > 0, E[rprev], 0)
        h_prev = jnp.where(r > 0, H[rprev], 0)
        q = pos - o_prev
        hl = H[r] - h_prev
        sl = E[r] - e_prev
        in_hdr = q < hl
        hn = hdr.shape[0]
        hdr_byte = hdr[jnp.clip(h_prev + q, 0, max(hn - 1, 0))]
        u = q - hl

        def char_at(idx):
            if packed:
                k = idx - c0
                byte = seq[jnp.clip(k >> 1, 0, seq.shape[0] - 1)]
                nib = jnp.where((k & 1) == 1, byte >> 4, byte & 15).astype(jnp.int32)
                ch = _code_to_char_i32(nib, rna)
            else:
                k = idx - c0
                ch = seq[jnp.clip(k, 0, seq.shape[0] - 1)].astype(jnp.int32)
                if upper:
                    is_lo = (ch >= ord("a")) & (ch <= ord("z"))
                    ch = jnp.where(is_lo, ch - 32, ch)
            if masking:
                m = jnp.searchsorted(bounds, idx, side="right").astype(jnp.int32)
                ch = ch + 32 * (m & 1)
            return ch

        if mode == MODE_FASTQ:
            in_seq = u < sl
            in_qual = (u >= sl + 3) & (u < 2 * sl + 3)
            seq_ch = char_at(e_prev + jnp.clip(u, 0, sl))
            qk = e_prev + jnp.clip(u - sl - 3, 0, sl) - q0
            qual_ch = qual[jnp.clip(qk, 0, qual.shape[0] - 1)].astype(jnp.int32)
            # the '\n+\n' separator: u == sl -> '\n', sl+1 -> '+', sl+2 -> '\n'
            sep_ch = jnp.where(u == sl + 1, ord("+"), ord("\n"))
            body = jnp.where(in_seq, seq_ch,
                             jnp.where(in_qual, qual_ch, sep_ch))
        else:
            if L > 0:
                blen = jnp.where(sl > 0, sl + (sl + L - 1) // L, 0)
                is_nl = (((u + 1) % (L + 1)) == 0) | (u == blen - 1)
                src = u - u // (L + 1)
            else:
                is_nl = u == sl
                src = u
            ch = char_at(e_prev + jnp.clip(src, 0, sl))
            body = jnp.where(is_nl, ord("\n"), ch)

        out = jnp.where(in_hdr, hdr_byte.astype(jnp.int32), body)
        return out.astype(jnp.uint8)

    return kernel


@functools.lru_cache(maxsize=64)
def _compiled_step(mesh, Osz: int, mode: int, line_len: int, rna: bool,
                   packed: bool, upper: bool, masking: bool):
    """jit(shard_map(kernel)) for one shape/option bucket."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .mesh import BLOCK_AXIS

    kernel = _make_kernel(Osz, mode, line_len, rna, packed, upper, masking)

    def render_gather(seq, qual, scalars, E, O, H, hdr, bounds):
        return kernel(seq[0], qual[0], scalars[0], E, O, H, hdr, bounds)[None]

    fn = shard_map(
        render_gather, mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS),
                  P(), P(), P(), P(), P()),
        out_specs=P(BLOCK_AXIS),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Uniform-record-group fast path
# ---------------------------------------------------------------------------
#
# Rendering is an EXPANSION, and when record shapes repeat it degenerates to
# pure layout ops: a group of records with identical (header_len, seq_len)
# renders as reshape+concat — chars (n, sl) -> full lines (n, k, L) + a
# newline column + tail, prefixed by headers (n, hl).  Uniform groups cover
# the production regimes (fixed-length FASTQ reads, single chr-scale FASTA
# records, equal-length multi-FASTA); ragged archives keep the gather path
# below.  Reshapes/concats run at copy speed — no per-byte gathers.

_REG_MAX_GROUPS = int(__import__("os").environ.get(
    "NAF_TPU_DECODE_REG_GROUPS", "24"))


@functools.lru_cache(maxsize=128)
def _regular_group_step(mode: int, hl: int, sl: int, L: int, nrec: int):
    """jit: render `nrec` records of identical shape -> u8[nrec*(hl+blen)]."""
    import jax
    import jax.numpy as jnp

    def render_group(chars, hdr, qual, c0, h0):
        hd = jax.lax.dynamic_slice(hdr, (h0,), (nrec * hl,)).reshape(
            nrec, hl)
        nl = jnp.full((nrec, 1), 0x0A, jnp.uint8)
        if sl > 0:
            ch = jax.lax.dynamic_slice(chars, (c0,), (nrec * sl,)).reshape(
                nrec, sl)
        else:
            ch = jnp.zeros((nrec, 0), jnp.uint8)
        if mode == MODE_FASTQ:
            q = (jax.lax.dynamic_slice(qual, (c0,), (nrec * sl,)).reshape(
                nrec, sl) if sl > 0 else ch)
            sep = jnp.tile(jnp.asarray(np.frombuffer(b"\n+\n", np.uint8)),
                           (nrec, 1))
            out = jnp.concatenate([hd, ch, sep, q, nl], axis=1)
        else:
            parts = [hd]
            if sl > 0:
                if L > 0:
                    kf, tail = divmod(sl, L)
                    if kf:
                        full = ch[:, :kf * L].reshape(nrec, kf, L)
                        full = jnp.concatenate(
                            [full, jnp.full((nrec, kf, 1), 0x0A, jnp.uint8)],
                            axis=2).reshape(nrec, kf * (L + 1))
                        parts.append(full)
                    if tail:
                        parts.append(jnp.concatenate([ch[:, kf * L:], nl],
                                                     axis=1))
                else:
                    parts.append(jnp.concatenate([ch, nl], axis=1))
            out = jnp.concatenate(parts, axis=1)
        return out.reshape(-1)

    return jax.jit(render_group)


@functools.lru_cache(maxsize=32)
def _prep_chars_step(packed: bool, upper: bool, rna: bool, masking: bool):
    """jit: section bytes -> rendered char stream (unpack + mask case)."""
    import jax
    import jax.numpy as jnp

    from ..ops.unpack import unpack_4bit_xla

    def prep_chars(seq_bytes, bounds):
        if packed:
            chars = unpack_4bit_xla(seq_bytes, rna=rna)
        else:
            chars = seq_bytes
            if upper:
                ci = chars.astype(jnp.int32)
                is_lo = (ci >= ord("a")) & (ci <= ord("z"))
                chars = jnp.where(is_lo, ci - 32, ci).astype(jnp.uint8)
        if masking:
            chars = apply_mask_parity(chars, bounds)
        return chars

    return jax.jit(prep_chars)


def apply_mask_parity(chars, bounds):
    """Lower-case every char inside the masked spans: each bound toggles the
    mask state, so a char is masked when an odd number of bounds lie at or
    before it (out-of-range bounds are dropped)."""
    import jax.numpy as jnp

    from ..ops import scan as S

    tog = jnp.zeros(chars.shape[0], jnp.int32).at[bounds].add(1, mode="drop")
    parity = S.cumsum_i32(tog) & 1
    return (chars.astype(jnp.int32) + 32 * parity).astype(jnp.uint8)


def regular_session(plan: RenderPlan, seq_bytes: np.ndarray,
                    qual_bytes: Optional[np.ndarray], *, mesh):
    """Uniform-group render session, or None when the archive is too ragged.

    Single-device only (the gather path shards ragged work; a 1-chip mesh
    is the bench/production decode unit).  Returns a zero-arg callable
    producing the list of per-group device arrays — section inputs are
    uploaded once, so repeated calls time the device-resident render
    (bench), and the byte-level driver below fetches the result.  Group
    widths are exactly the plan's body lengths, asserted before any fetch.
    """
    import jax
    import jax.numpy as jnp

    if mesh is not None and int(mesh.devices.size) != 1:
        return None
    n = plan.slens.size
    if n == 0 or plan.total_out == 0:
        return None
    # the gather path renders in OUT_BATCH-bounded pieces; the regular
    # path materializes everything at once, so archives beyond the batch
    # budget keep the bounded-memory path
    if plan.total_out >= min(1 << 31, 2 * OUT_BATCH):
        return None
    hlens = np.diff(plan.H, prepend=np.int64(0))
    slens = plan.slens.astype(np.int64)
    if n > 1:
        change = np.flatnonzero((hlens[1:] != hlens[:-1])
                                | (slens[1:] != slens[:-1])) + 1
    else:
        change = np.zeros(0, np.int64)
    starts = np.concatenate([[0], change]).astype(np.int64)
    ends = np.append(starts[1:], n)
    if starts.size > _REG_MAX_GROUPS:
        return None

    L = plan.line_len
    blens = (2 * slens + 4 if plan.mode == MODE_FASTQ
             else body_length(slens, L))
    if int((hlens + blens).sum()) != plan.total_out:
        return None                       # spill/quirk archive: gather path

    masking = plan.bounds.size > 0
    sb = np.ascontiguousarray(seq_bytes, np.uint8)
    pad = (-sb.size) % 256
    if pad:
        sb = np.pad(sb, (0, pad))
    M = _bucket(max(plan.bounds.size, 2), 2)
    bounds = np.full(M, 1 << 30, np.int64)
    bounds[:plan.bounds.size] = plan.bounds
    prep = _prep_chars_step(plan.packed, plan.upper, plan.rna, masking)
    sb_d = jnp.asarray(sb)
    bounds_d = jnp.asarray(bounds.astype(np.int32))
    hdr_d = jnp.asarray(plan.hdr)
    if plan.mode == MODE_FASTQ and qual_bytes is not None:
        qual_d = jnp.asarray(np.ascontiguousarray(qual_bytes, np.uint8))
    else:
        qual_d = jnp.zeros(1, jnp.uint8)

    groups = []
    total = 0
    for r0, r1 in zip(starts, ends):
        hl = int(hlens[r0])
        sl = int(slens[r0])
        nrec = int(r1 - r0)
        c0 = int(plan.E[r0 - 1]) if r0 > 0 else 0
        h0 = int(plan.H[r0 - 1]) if r0 > 0 else 0
        groups.append((_regular_group_step(plan.mode, hl, sl, L, nrec),
                       c0, h0))
        total += nrec * (hl + int(blens[r0]))
    if total != plan.total_out:
        return None

    def run():
        chars = prep(sb_d, bounds_d)
        return [step(chars, hdr_d, qual_d, jnp.int32(c0), jnp.int32(h0))
                for step, c0, h0 in groups]

    return run


def render_regular(plan: RenderPlan, seq_bytes: np.ndarray,
                   qual_bytes: Optional[np.ndarray], *, mesh
                   ) -> Optional[bytes]:
    """Uniform-group render to bytes (see regular_session), or None."""
    if plan.total_out == 0:
        return b""
    run = regular_session(plan, seq_bytes, qual_bytes, mesh=mesh)
    if run is None:
        return None
    with trace_span("device-regular", bytes=plan.total_out,
                    platform=mesh.devices.flat[0].platform):
        return b"".join(np.asarray(o).tobytes() for o in run())


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def render_sharded(plan: RenderPlan, seq_bytes: np.ndarray,
                   qual_bytes: Optional[np.ndarray], *, mesh,
                   out_batch: int = 0) -> bytes:
    """Render the full output over the mesh in bounded batches."""
    import os as _os

    if _os.environ.get("NAF_TPU_NO_REGULAR") != "1":
        try:
            out = render_regular(plan, seq_bytes, qual_bytes, mesh=mesh)
            if out is not None:
                return out
        except Exception as e:
            # e.g. device OOM on a giant uniform group: the batched
            # gather path below is the bounded-memory fallback
            import warnings

            if _os.environ.get("NAF_TPU_NO_FALLBACK") == "1":
                raise
            warnings.warn(
                f"naf_tpu: uniform-group render failed ({type(e).__name__}: "
                f"{e}); falling back to the gather render")
    from .mesh import block_sharding, replicated

    D = int(mesh.devices.size)
    total_out = plan.total_out
    if total_out == 0:
        return b""
    out_batch = out_batch or OUT_BATCH
    # per-device chunk per batch step; every index in a batch must fit i32
    # AND stay below the pad_rec=1<<30 monotone sentinel.  A batch covers
    # [p0, p1) plus the records straddling its edges, so the largest rebased
    # prefix value is < out_batch + 2 * max_record_span: cap the batch and
    # refuse records whose own span breaks the bound (multi-GB single
    # records silently wrapped in int32 before; callers catch
    # RenderOverflow and render on the host).
    out_batch = min(out_batch, 1 << 28)
    max_span = 0
    for arr in (plan.O, plan.E, plan.H):
        if arr.size:
            d0 = np.diff(arr, prepend=np.int64(0))
            max_span = max(max_span, int(d0.max(initial=0)))
    if out_batch + 2 * max_span >= (1 << 30):
        raise RenderOverflow(
            f"record span {max_span} too large for device render batches")
    shard = block_sharding(mesh)
    repl = replicated(mesh)

    masking = plan.bounds.size > 0
    pieces: list[bytes] = []
    p0 = 0
    while p0 < total_out:
        p1 = min(p0 + out_batch, total_out)
        # records overlapping [p0, p1)
        r0 = int(np.searchsorted(plan.O, p0, side="right"))
        r1 = min(int(np.searchsorted(plan.O, p1 - 1, side="right")) + 1,
                 plan.O.size)
        out_base = int(plan.O[r0 - 1]) if r0 > 0 else 0
        char_base = int(plan.E[r0 - 1]) if r0 > 0 else 0
        hdr_base = int(plan.H[r0 - 1]) if r0 > 0 else 0

        Eb = (plan.E[r0:r1] - char_base).astype(np.int32)
        Ob = (plan.O[r0:r1] - out_base).astype(np.int32)
        Hb = (plan.H[r0:r1] - hdr_base).astype(np.int32)
        hdr_b = plan.hdr[hdr_base:int(plan.H[r1 - 1])]
        # mask bounds clipped+rebased; pad in pairs so parity is preserved
        char_hi = int(plan.E[r1 - 1])
        lo = int(np.searchsorted(plan.bounds[1::2], char_base, side="right"))
        hi = int(np.searchsorted(plan.bounds[0::2], char_hi, side="left"))
        b = np.clip(plan.bounds[2 * lo:2 * hi] - char_base,
                    0, char_hi - char_base).astype(np.int32)

        # device chunks of the batch out range
        chunk = -(-(p1 - p0) // D)
        chunk += chunk % 2
        Osz = _bucket(max(chunk, 2))
        o0s = np.minimum(p0 + np.arange(D, dtype=np.int64) * chunk, p1)
        o1s = np.minimum(o0s + chunk, p1)

        seq_lo = np.asarray([_next_seq_char(plan, int(a)) for a in o0s])
        seq_hi = np.asarray([_next_seq_char(plan, int(a)) for a in o1s])
        if plan.mode == MODE_FASTQ:
            q_lo = np.asarray([_next_qual_char(plan, int(a)) for a in o0s])
            q_hi = np.asarray([_next_qual_char(plan, int(a)) for a in o1s])
        else:
            q_lo = q_hi = np.zeros(D, np.int64)

        if plan.packed:
            b_lo = seq_lo // 2
            b_hi = (seq_hi + 1) // 2
        else:
            b_lo, b_hi = seq_lo, seq_hi
        S = _bucket(max(int((b_hi - b_lo).max(initial=0)), 1), 16)
        Q = _bucket(max(int((q_hi - q_lo).max(initial=0)), 1), 16)

        seq_sl = np.zeros((D, S), np.uint8)
        qual_sl = np.zeros((D, Q), np.uint8)
        scalars = np.zeros((D, 4), np.int32)   # (o0, c0, q0, pad)
        for d in range(D):
            sb = seq_bytes[int(b_lo[d]):int(b_hi[d])]
            seq_sl[d, :sb.size] = sb
            if qual_bytes is not None:
                qb = qual_bytes[int(q_lo[d]):int(q_hi[d])]
                qual_sl[d, :qb.size] = qb
            c0 = int(seq_lo[d])
            if plan.packed:
                c0 = int(b_lo[d]) * 2          # char of slice nibble 0
            scalars[d] = (int(o0s[d]) - out_base, c0 - char_base,
                          int(q_lo[d]) - char_base, 0)

        R = _bucket(max(r1 - r0, 1), 16)
        Hn = _bucket(max(hdr_b.size, 1), 16)
        M = _bucket(max(b.size, 2), 2)
        pad_rec = np.int32(1 << 30)
        Ep = np.full(R, pad_rec, np.int32); Ep[:Eb.size] = Eb
        Op = np.full(R, pad_rec, np.int32); Op[:Ob.size] = Ob
        Hp = np.full(R, pad_rec, np.int32); Hp[:Hb.size] = Hb
        # padded records must not change sl/hl of real ones: extend with
        # monotone sentinels (same value => zero-length padded records)
        hdr_p = np.zeros(Hn, np.uint8); hdr_p[:hdr_b.size] = hdr_b
        bp = np.full(M, pad_rec, np.int32); bp[:b.size] = b

        step = _compiled_step(mesh, Osz, plan.mode, plan.line_len, plan.rna,
                              plan.packed, plan.upper, masking)
        with trace_span("device-gather", bytes=p1 - p0,
                        platform=mesh.devices.flat[0].platform):
            out_np = np.asarray(step(
                *(jax.device_put(a, shard) for a in (seq_sl, qual_sl,
                                                     scalars)),
                *(jax.device_put(a, repl) for a in (Ep, Op, Hp, hdr_p, bp))))
        for d in range(D):
            ln = int(o1s[d] - o0s[d])
            if ln > 0:
                pieces.append(out_np[d, :ln].tobytes())
        p0 = p1
    return b"".join(pieces)
