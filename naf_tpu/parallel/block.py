"""Block-parallel encode over a device mesh (shard_map).

The distributed design (greenfield — the reference is single-threaded;
SURVEY.md §2.4).  Two passes over record/line-aligned byte blocks sharded
on the mesh's ``blocks`` axis:

  pass 1 (stats): every device scans its block (ops.scan) and returns only
    O(1) scalars — stream char count, id/comment/qual byte counts, record
    and mask-run counts — plus the cross-block reductions:
    an ``all_gather`` of char counts (nibble-parity prefix), ``psum`` of the
    four unexpected-char histograms (split into u32 hi/lo halves so u64
    totals cannot wrap), and ``pmax`` of the longest line.

  pass 2 (emit): with output capacities sized from pass-1 maxima (bucketed
    to powers of two to bound recompiles), every device re-scans and emits
    *compacted* payloads: 4-bit packed sequence, id/comment byte streams,
    per-record length vectors, mask-run lengths, and (FASTQ) the quality
    stream.  Device->host traffic is ~the section payload bytes — nothing
    per-input-byte ever returns to the host (the v1 design shipped [D, B]
    region/rec_start/is_lower arrays back and re-classified on host).

The host then stitches O(records + runs + blocks) carry state: nibble
parity at block edges, first/last mask-run merges, open-record length
accumulation.  Blocks are cut at line starts, so a single giant record
(chr1) shards across all devices — the sequence-parallel case — and
headers/lines never straddle blocks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..format import constants as C
from ..ops import scan as S
from ..utils.trace import trace_span
from .mesh import BLOCK_AXIS

_GT = ord(">")
_AT = ord("@")
_LF = ord("\n")


def _bucket(n: int, align: int = 16) -> int:
    m = align
    while m < n:
        m *= 2
    return m


# ---------------------------------------------------------------------------
# shared per-device scan + compaction
# ---------------------------------------------------------------------------

def _record_bounds(rec_start, r_cap: int):
    """i32[r_cap+1] record boundaries: [0, marker_1, ..., B, B, ...].

    Record r spans [bnd[r], bnd[r+1]); rows past the real record count
    collapse to empty ranges.  One compaction, shared by every per-record
    segment sum.
    """
    B = rec_start.shape[0]
    pos = jnp.arange(B, dtype=jnp.int32)
    starts, n_m = S.compact(rec_start, pos)
    j = jnp.arange(r_cap, dtype=jnp.int32)
    starts_r = jnp.where(j < n_m, _fit(starts, r_cap), B)
    return jnp.concatenate([jnp.zeros(1, jnp.int32), starts_r])


def _segment_sum_bounds(mask, bnd):
    """i32[r_cap]: per-record mask counts via one prefix count plus two
    r_cap-sized boundary gathers."""
    cum = S.cumsum_i32(mask)
    E = jnp.concatenate([jnp.zeros(1, jnp.int32), cum])   # E[i] = count < i
    return E[bnd[1:]] - E[bnd[:-1]]


def _fit(arr, cap: int):
    """Pad-or-slice a 1-D array to exactly `cap` elements (static shapes)."""
    n = arr.shape[0]
    if n >= cap:
        return arr[:cap]
    return jnp.concatenate([arr, jnp.zeros(cap - n, arr.dtype)])


def _run_stats_uncompacted(keep, val):
    """(first_lower, n_runs) of the kept stream WITHOUT compacting it.

    Pass 1 only needs the run count and the first byte's case; both derive
    from comparing each kept byte with its predecessor's case, found via a
    masked max-scan of (position*2 | lower) — no sort, no scatter.
    """
    B = keep.shape[0]
    lower = keep & (val >= 96)
    pos = jnp.arange(B, dtype=jnp.int32)
    enc = jnp.where(keep, pos * 2 + lower.astype(jnp.int32), S._NEG)
    m = S.maxscan_i32(enc)
    m_excl = jnp.concatenate([jnp.full((1,), S._NEG, jnp.int32), m[:-1]])
    has_prev = m_excl >= 0
    prev_lower = (m_excl & 1) == 1
    change = keep & has_prev & (lower != prev_lower)
    n_changes = jnp.sum(change.astype(jnp.int32))
    cum_keep = S.cumsum_i32(keep)
    cnt = cum_keep[-1]
    n_runs = jnp.where(cnt > 0, n_changes + 1, 0)
    first_lower = jnp.any(keep & (cum_keep == 1) & lower)
    return first_lower, n_runs


def _run_lengths(lower, count, m_cap: int):
    """i32[m_cap] run lengths of the compacted case vector."""
    B = lower.shape[0]
    idx = jnp.arange(B, dtype=jnp.int32)
    valid = idx < count
    prev = jnp.concatenate([lower[:1], lower[:-1]])
    change = valid & (idx > 0) & (lower != prev)
    pos_c, n_changes = S.compact(change, idx)
    # boundaries: [0, change_0, ..., change_{k-1}, count]
    bounds = jnp.zeros(m_cap + 1, jnp.int32)
    j = jnp.arange(m_cap, dtype=jnp.int32)
    bounds = bounds.at[jnp.where(j < n_changes, j + 1, m_cap + 1)].set(
        _fit(pos_c, m_cap), mode="drop")        # OOB index -> dropped
    bounds = bounds.at[n_changes + 1].set(count, mode="drop")
    lens = bounds[1:] - bounds[:-1]
    n_runs = jnp.where(count > 0, n_changes + 1, 0)
    return jnp.where(j < n_runs, lens, 0)


def _scan_block(b, prev_byte, starts_in_seq, *, seq_type: int, fastq: bool):
    """Per-byte classification shared by both passes.

    Returns the dict from ops.scan plus 'qual_keep'/'qual_val'/'qual_unex'
    (zeros for FASTA).
    """
    if fastq:
        return S.scan_fastq_block(b, prev_byte, seq_type=seq_type)
    s = S.scan_fasta_block(b, prev_byte, seq_type=seq_type,
                           starts_in_seq=starts_in_seq)
    z = jnp.zeros(b.shape[0], bool)
    return dict(s, qual_keep=z, qual_unex=z, qual_val=b,
                hist_qual=jnp.zeros(256, jnp.int32))


def _hist_split(h):
    """i32[256] -> (lo, hi) u32 halves so psum over many blocks can't wrap."""
    hu = h.astype(jnp.uint32)
    return hu & 0xFFFF, hu >> 16


# ---------------------------------------------------------------------------
# pass 1: stats
# ---------------------------------------------------------------------------

def _stats_fn(block, prev_byte, sis, *, seq_type: int, fastq: bool):
    b = block[0]
    s = _scan_block(b, prev_byte[0], sis[0], seq_type=seq_type, fastq=fastq)
    count = jnp.sum(s["stream_keep"].astype(jnp.int32))

    counts = jax.lax.all_gather(count, BLOCK_AXIS)              # i32[D]
    my = jax.lax.axis_index(BLOCK_AXIS)
    prefix = jnp.sum(jnp.where(jnp.arange(counts.shape[0]) < my, counts, 0))
    odd = (prefix % 2) == 1

    first_lower, n_runs = _run_stats_uncompacted(
        s["stream_keep"], s["stream_val"])

    id_bytes = jnp.sum(s["id_keep"].astype(jnp.int32))
    com_bytes = jnp.sum(s["com_keep"].astype(jnp.int32))
    qual_bytes = jnp.sum(s["qual_keep"].astype(jnp.int32))
    n_rec = jnp.sum(s["rec_start"].astype(jnp.int32))

    # FASTQ's "longest line" is the max read length; since reads never span
    # blocks and only lane-1 bytes are seq_keep, the same per-line kept-max
    # + pmax covers both formats in pass 1 (no host derivation needed)
    longest = jax.lax.pmax(
        S.longest_line_block(s["seq_keep"], s["is_eol"]), BLOCK_AXIS)

    hists = []
    for key in ("hist_id", "hist_comment", "hist_seq", "hist_qual"):
        lo, hi = _hist_split(s[key])
        hists.append(jax.lax.psum(lo, BLOCK_AXIS))
        hists.append(jax.lax.psum(hi, BLOCK_AXIS))

    out = (count[None], odd[None], id_bytes[None], com_bytes[None],
           qual_bytes[None], n_rec[None], n_runs[None], first_lower[None],
           longest[None]) + tuple(h[None] for h in hists)
    return out


@functools.partial(jax.jit, static_argnames=("seq_type", "fastq", "mesh"))
def stats_blocks_sharded(blocks, prev_bytes, starts_in_seq, *,
                         seq_type: int, fastq: bool, mesh: Mesh):
    n_out = 9 + 8
    fn = shard_map(
        functools.partial(_stats_fn, seq_type=seq_type, fastq=fastq),
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS)),
        out_specs=tuple(P(BLOCK_AXIS) for _ in range(n_out)),
    )
    return fn(blocks, prev_bytes, starts_in_seq)


# ---------------------------------------------------------------------------
# pass 2: emit compacted payloads
# ---------------------------------------------------------------------------

def _emit_fn(block, prev_byte, sis, odd, *, seq_type: int, fastq: bool,
             p_cap: int, id_cap: int, com_cap: int, r_cap: int, m_cap: int,
             q_cap: int, pack_nibbles: bool = True):
    b = block[0]
    s = _scan_block(b, prev_byte[0], sis[0], seq_type=seq_type, fastq=fastq)

    seq_c, cnt = S.compact(s["stream_keep"], s["stream_val"])
    if pack_nibbles:
        # nibble-parity alignment: when the global prefix char count is
        # odd, this block's first char pairs with the previous block's
        # last char — pack chars[1:] and emit chars[0]'s code separately
        shifted = jnp.where(odd[0], jnp.roll(seq_c, -1), seq_c)
        packed = _fit(S.pack_even(shifted), p_cap)
        # one-element LUT gather: take [0] BEFORE the table lookup
        first_code = jnp.take(S.T.NUC_CODE,
                              seq_c[0].astype(jnp.int32))
    else:
        # protein/text sequences store raw bytes (tables.c:96-117 has no
        # 4-bit code for them): emit the compacted char stream as-is;
        # host stitching is plain concatenation, no parity carry
        packed = _fit(seq_c, p_cap)
        first_code = jnp.uint8(0)

    id_vals = _fit(S.compact(s["id_keep"], b)[0], id_cap)
    com_vals = _fit(S.compact(s["com_keep"], s["com_val"])[0], com_cap)

    bnd = _record_bounds(s["rec_start"], r_cap)
    seq_lens = _segment_sum_bounds(s["seq_keep"], bnd)
    id_lens = _segment_sum_bounds(s["id_keep"], bnd)
    com_lens = _segment_sum_bounds(s["com_keep"], bnd)

    lower = (seq_c >= 96) & (jnp.arange(seq_c.shape[0]) < cnt)
    run_lens = _run_lengths(lower, cnt, m_cap)

    if fastq:
        qual_vals = _fit(S.compact(s["qual_keep"], s["qual_val"])[0], q_cap)
        qual_lens = _segment_sum_bounds(s["qual_keep"], bnd)
    else:
        qual_vals = jnp.zeros(q_cap, jnp.uint8)
        qual_lens = jnp.zeros(r_cap, jnp.int32)

    return (packed[None], first_code[None], cnt[None],
            id_vals[None], com_vals[None], qual_vals[None],
            seq_lens[None], id_lens[None], com_lens[None],
            qual_lens[None], run_lens[None])


@functools.partial(jax.jit, static_argnames=(
    "seq_type", "fastq", "mesh", "p_cap", "id_cap", "com_cap", "r_cap",
    "m_cap", "q_cap", "pack_nibbles"))
def emit_blocks_sharded(blocks, prev_bytes, starts_in_seq, odd, *,
                        seq_type: int, fastq: bool, mesh: Mesh,
                        p_cap: int, id_cap: int, com_cap: int, r_cap: int,
                        m_cap: int, q_cap: int, pack_nibbles: bool = True):
    fn = shard_map(
        functools.partial(_emit_fn, seq_type=seq_type, fastq=fastq,
                          p_cap=p_cap, id_cap=id_cap, com_cap=com_cap,
                          r_cap=r_cap, m_cap=m_cap, q_cap=q_cap,
                          pack_nibbles=pack_nibbles),
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS),) * 4,
        out_specs=tuple(P(BLOCK_AXIS) for _ in range(11)),
    )
    return fn(blocks, prev_bytes, starts_in_seq, odd)


# ---------------------------------------------------------------------------
# host side of the two passes (in-memory and streaming encoders)
# ---------------------------------------------------------------------------

@dataclass
class PassStats:
    """Pass-1 results on the host (one entry per block)."""

    counts: np.ndarray
    id_bytes: np.ndarray
    com_bytes: np.ndarray
    qual_bytes: np.ndarray
    n_rec: np.ndarray
    n_runs: np.ndarray
    first_lower: np.ndarray
    longest: np.ndarray
    hists: list            # 8 x u32[1, 256] psum'd (lo, hi) halves


def upload_blocks(blocks: "Blocks", mesh: Mesh, cols: int = 0):
    """Blocks -> device arrays sharded on the mesh (rows padded with LF to
    ``cols`` columns when given, so chunked callers reuse one shape)."""
    data = blocks.data
    if cols > data.shape[1]:
        pad = np.full((data.shape[0], cols - data.shape[1]), _LF, np.uint8)
        data = np.concatenate([data, pad], axis=1)
    sharding = NamedSharding(mesh, P(BLOCK_AXIS))
    with trace_span("device-upload", bytes=data.nbytes):
        return tuple(jax.device_put(a, sharding) for a in
                     (data, blocks.prev, blocks.starts_in_seq))


def _platform(mesh: Mesh) -> str:
    return mesh.devices.flat[0].platform


def stats_pass(dev, *, mesh: Mesh, seq_type: int, fastq: bool) -> PassStats:
    """Run pass 1 and fetch its O(1)-per-block results."""
    with trace_span("device-stats", bytes=int(dev[0].size),
                    platform=_platform(mesh)):
        st = stats_blocks_sharded(*dev, seq_type=seq_type, fastq=fastq,
                                  mesh=mesh)
        (counts, _odd, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
         first_lower, longest) = [np.asarray(o) for o in st[:9]]
        hists = [np.asarray(o)[:1] for o in st[9:]]
    return PassStats(counts, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
                     first_lower.astype(bool), longest, hists)


def emit_caps(st: PassStats, *, fastq: bool, text_like: bool) -> dict:
    """Power-of-two output capacities for pass 2 from pass-1 maxima."""
    if text_like:
        p_cap = _bucket(int(st.counts.max(initial=2)) + 1)
    else:
        p_cap = _bucket(int((st.counts + 1).max(initial=2) // 2) + 1)
    return dict(
        p_cap=p_cap,
        id_cap=_bucket(max(int(st.id_bytes.max(initial=1)), 1)),
        com_cap=_bucket(max(int(st.com_bytes.max(initial=1)), 1)),
        r_cap=_bucket(int(st.n_rec.max(initial=0)) + 1),
        m_cap=(2 if text_like
               else _bucket(max(int(st.n_runs.max(initial=2)), 2))),
        q_cap=(_bucket(max(int(st.qual_bytes.max(initial=1)), 1))
               if fastq else 16))


def emit_pass(dev, st: PassStats, caps: dict, *, mesh: Mesh, seq_type: int,
              fastq: bool, text_like: bool = False,
              parity_odd_in: bool = False) -> list:
    """Run pass 2 and fetch its 11 outputs (payload rows are padded to the
    caps; consumers index only the used prefixes).  ``parity_odd_in`` is
    the global char-count parity before these blocks (the streaming
    encoder's carry)."""
    prefix = np.concatenate([[0], np.cumsum(st.counts)[:-1]])
    odd = ((int(parity_odd_in) + prefix) % 2).astype(bool)
    odd_d = jax.device_put(odd, NamedSharding(mesh, P(BLOCK_AXIS)))
    with trace_span("device-emit", bytes=int(dev[0].size),
                    platform=_platform(mesh)):
        em = emit_blocks_sharded(*dev, odd_d, seq_type=seq_type, fastq=fastq,
                                 mesh=mesh, pack_nibbles=not text_like,
                                 **caps)
        return [np.asarray(o) for o in em]


# ---------------------------------------------------------------------------
# host-side block splitting
# ---------------------------------------------------------------------------

@dataclass
class Blocks:
    data: np.ndarray          # u8[D, B] '\n'-padded
    prev: np.ndarray          # u8[D] byte before each block
    starts_in_seq: np.ndarray  # bool[D] block cut mid-record (FASTA SP)


def make_blocks(data: np.ndarray, n_blocks: int, *, marker: int = _GT,
                prev0: int | None = None, sis0: bool = False) -> Blocks:
    """Split bytes (already past the first marker) into line-aligned blocks.

    Cut candidates are line starts (byte after any EOL), so headers and
    lines never straddle blocks; a block whose first byte is not a record
    marker starts mid-record (sequence-parallel continuation).

    ``prev0``/``sis0`` carry chunk state for the streaming device encoder
    (parallel/stream.py): the byte before this chunk and whether the chunk
    resumes mid-record.  Default = chunk 0 right after the global marker.
    """
    n = data.size
    if n == 0:
        blocks = np.full((n_blocks, 2), _LF, dtype=np.uint8)
        prev = np.full(n_blocks, _LF, dtype=np.uint8)
        prev[0] = marker if prev0 is None else prev0
        sis = np.zeros(n_blocks, bool)
        sis[0] = bool(sis0)
        return Blocks(blocks, prev, sis)

    is_eol = C.IS_EOL[:256][data]
    line_starts = np.flatnonzero(is_eol[:-1]) + 1     # n excluded

    targets = (np.arange(1, n_blocks) * n) // n_blocks
    idx = np.searchsorted(line_starts, targets)
    cuts = [0]
    for i in idx:
        cut = int(line_starts[i]) if i < line_starts.size else n
        if cut > cuts[-1]:
            cuts.append(cut)
    while len(cuts) < n_blocks + 1:
        cuts.append(n)
    cuts = cuts[: n_blocks + 1]
    cuts[-1] = n

    B = max(max(e - s for s, e in zip(cuts[:-1], cuts[1:])), 2)
    B += B % 2
    blocks = np.full((n_blocks, B), _LF, dtype=np.uint8)
    prev = np.full(n_blocks, _LF, dtype=np.uint8)
    prev[0] = marker if prev0 is None else prev0
    sis = np.zeros(n_blocks, bool)
    sis[0] = bool(sis0) and data[0] != marker
    for k, (s, e) in enumerate(zip(cuts[:-1], cuts[1:])):
        blocks[k, : e - s] = data[s:e]
        if k > 0:
            if s > 0:
                prev[k] = data[s - 1]
            else:
                prev[k] = prev[0]
            sis[k] = ((e > s) and data[s] != marker
                      and (s > 0 or sis[0]))
    return Blocks(blocks, prev, sis)


def make_blocks_fastq(data: np.ndarray, n_blocks: int):
    """Record-aligned FASTQ blocks; returns (Blocks, n_records) or None.

    Requires the regular 4-line LF grid (every production FASTQ):
    non-empty lines, '+' third lines, '@' record heads, trailing newline,
    and no CR/VT/FF anywhere — the reference FASTQ parser treats those as
    EOL-class, so e.g. a CRLF grid is an ERROR there ("can't find '+'
    line"); rejecting them here routes such inputs to the host parser,
    which raises the reference-exact message.  ``data`` starts right
    after the leading '@'.
    """
    n = data.size
    if n == 0 or data[-1] != _LF:
        return None
    if np.any((data == 11) | (data == 12) | (data == 13)):
        return None
    eol = np.flatnonzero(data == _LF)
    n_lines = eol.size
    if n_lines % 4 != 0:
        return None
    line_start = np.concatenate([[0], eol[:-1] + 1])
    if np.any(eol == line_start):           # empty line
        return None
    if not np.all(data[line_start[2::4]] == ord("+")):
        return None
    if n_lines > 4 and not np.all(data[line_start[4::4]] == _AT):
        return None

    rec_starts = line_start[0::4]
    n_rec = rec_starts.size
    targets = (np.arange(1, n_blocks) * n) // n_blocks
    idx = np.searchsorted(rec_starts, targets)
    cuts = [0]
    for i in idx:
        cut = int(rec_starts[i]) if i < rec_starts.size else n
        if cut > cuts[-1]:
            cuts.append(cut)
    while len(cuts) < n_blocks + 1:
        cuts.append(n)
    cuts = cuts[: n_blocks + 1]
    cuts[-1] = n

    B = max(max(e - s for s, e in zip(cuts[:-1], cuts[1:])), 2)
    B += B % 2
    blocks = np.full((n_blocks, B), _LF, dtype=np.uint8)
    prev = np.full(n_blocks, _LF, dtype=np.uint8)
    prev[0] = _AT
    for k, (s, e) in enumerate(zip(cuts[:-1], cuts[1:])):
        blocks[k, : e - s] = data[s:e]
        if k > 0 and s > 0:
            prev[k] = data[s - 1]
    return Blocks(blocks, prev, np.zeros(n_blocks, bool)), n_rec


# ---------------------------------------------------------------------------
# host-side stitching
# ---------------------------------------------------------------------------

def stitch_packed(packed: np.ndarray, counts: np.ndarray,
                  first_codes: np.ndarray) -> np.ndarray:
    """Merge per-block even-aligned payloads into one nibble stream.

    For a block whose prefix parity is odd, its first char's code was left
    out of its packed payload; it belongs in the high nibble of the previous
    byte of the stream.  One OR per block edge.
    """
    pieces: list[np.ndarray] = []
    total = 0
    pending_low: int | None = None
    for d in range(counts.shape[0]):
        cnt = int(counts[d])
        if cnt == 0:
            continue
        odd = (total % 2) == 1
        if odd:
            assert pending_low is not None
            pieces.append(np.asarray(
                [pending_low | (int(first_codes[d]) << 4)], dtype=np.uint8))
            pending_low = None
            packed_chars = cnt - 1
        else:
            packed_chars = cnt
        nbytes = packed_chars // 2
        body = packed[d, :nbytes]
        pieces.append(np.ascontiguousarray(body))
        if packed_chars % 2:
            pending_low = int(packed[d, nbytes]) & 0x0F
        total += cnt
    if pending_low is not None:
        pieces.append(np.asarray([pending_low], dtype=np.uint8))
    if not pieces:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(pieces)


def stitch_packed_range(rows: dict, counts: np.ndarray,
                        first_codes: np.ndarray, k0: int, k1: int
                        ) -> np.ndarray:
    """``stitch_packed`` for blocks [k0, k1) only, using global carry state.

    ``rows[d]`` is block d's even-aligned packed payload; ``counts`` and
    ``first_codes`` are the GLOBAL per-block vectors (O(D) scalars every
    host already holds).  Boundary nibble ownership: a byte straddling two
    ranges is emitted by the EARLIER range (completed with the next range's
    first code) and skipped by the later one, so concatenating every range's
    output in block order reproduces ``stitch_packed`` byte-for-byte.  This
    is what lets each host of a multi-host mesh compress its own packed
    bytes locally (O(compressed) traffic — parallel/multihost.py).
    """
    D = counts.shape[0]
    pieces: list[np.ndarray] = []
    total = int(counts[:k0].sum())
    pending_low: int | None = None
    for d in range(k0, k1):
        cnt = int(counts[d])
        if cnt == 0:
            continue
        odd = (total % 2) == 1
        if odd:
            if pending_low is not None:
                pieces.append(np.asarray(
                    [pending_low | (int(first_codes[d]) << 4)],
                    dtype=np.uint8))
                pending_low = None
            # else: first char of this range completes the previous
            # range's last byte — emitted there, skipped here
            packed_chars = cnt - 1
        else:
            packed_chars = cnt
        nbytes = packed_chars // 2
        pieces.append(np.ascontiguousarray(rows[d][:nbytes]))
        if packed_chars % 2:
            pending_low = int(rows[d][nbytes]) & 0x0F
        total += cnt
    if pending_low is not None:
        nxt = None
        for j in range(k1, D):
            if int(counts[j]) > 0:
                nxt = j
                break
        if nxt is None:
            pieces.append(np.asarray([pending_low], dtype=np.uint8))
        else:
            pieces.append(np.asarray(
                [pending_low | (int(first_codes[nxt]) << 4)],
                dtype=np.uint8))
    if not pieces:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(pieces)


def stitch_lengths(per_block: list[np.ndarray]) -> np.ndarray:
    """Per-block segment counts -> global per-record values.

    Segment 0 of every block after the first continues the previous open
    record (0 when the block starts at a marker); block 0's segment 0 is
    record 0 itself (its marker was stripped by the reader).
    """
    out: list[np.ndarray] = []
    for k, lens in enumerate(per_block):
        lens = np.asarray(lens, dtype=np.int64)
        if k == 0:
            seg = lens
        else:
            if out and lens.size:
                out[-1][-1] += int(lens[0])
            seg = lens[1:]
        if seg.size:
            out.append(seg.copy())
    if not out:
        return np.zeros(0, np.int64)
    return np.concatenate(out)


def stitch_runs(per_block_runs: list[np.ndarray],
                per_block_first: list[bool]) -> tuple[np.ndarray, bool]:
    """Per-block mask runs -> (global run lengths, first char is lower)."""
    runs: list[np.ndarray] = []
    state_first = False
    state_last = None          # case of the last run appended
    for lens, first in zip(per_block_runs, per_block_first):
        lens = np.asarray(lens, dtype=np.int64)
        if lens.size == 0:
            continue
        if state_last is None:
            runs.append(lens.copy())
            state_first = bool(first)
        elif bool(first) == state_last:
            runs[-1][-1] += int(lens[0])
            if lens.size > 1:
                runs.append(lens[1:].copy())
        else:
            runs.append(lens.copy())
        state_last = bool(first) ^ ((lens.size - 1) % 2 == 1)
    if not runs:
        return np.zeros(0, np.int64), False
    return np.concatenate(runs), state_first


def blob_from_lens(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenated per-record values + lens -> '\\0'-terminated blob."""
    n_rec = lens.size
    total = int(vals.size) + n_rec
    out = np.zeros(total, dtype=np.uint8)
    ends = np.cumsum(lens + 1) - 1
    fill = np.ones(total, dtype=bool)
    fill[ends] = False
    out[fill] = vals
    return out.tobytes()
