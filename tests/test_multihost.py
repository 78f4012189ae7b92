"""Multi-process (simulated multi-host) pipeline test.

Spawns 2 python processes that `jax.distributed.initialize` against a local
coordinator with 2 virtual CPU devices each (global mesh of 4), run the
sharded block-encode step over a global `Mesh`, and verify the collective
reductions and host-0 archive assembly — multi-host behavior on one machine
(SURVEY §4 multi-node strategy).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import os, sys
import jax

NPROC = int(sys.argv[3])
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=NPROC,
    process_id=int(sys.argv[2]),
)

import numpy as np

from naf_tpu.parallel.multihost import encode_multihost
from naf_tpu.pipeline.encoder import EncodeOptions, encode

pid = int(sys.argv[2])
devices = jax.devices()
assert len(devices) == 2 * NPROC, devices

# identical input everywhere; each process feeds its local block shards.
# Record sizes vary wildly so block cuts are uneven, and one giant record
# spans several blocks (sequence-parallel continuation across hosts).
rng = np.random.default_rng(0)
rows = []
for i in range(15):
    seq = rng.choice(np.frombuffer(b"ACGTacgtNn", np.uint8),
                     size=int(rng.integers(5, 400)))
    rows.append(b">r%d c\n" % i + seq.tobytes() + b"\n")
giant = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=3000)
rows.append(b">giant\n")
rows.append(b"\n".join(giant[j:j+61].tobytes() for j in range(0, 3000, 61)))
rows.append(b"\n")
data = b"".join(rows)

blob, stats = encode_multihost(data, EncodeOptions(level=1))
host_blob, _ = encode(data, EncodeOptions(level=1))
assert blob == host_blob, "multihost FASTA archive != host archive"
assert stats.n_sequences == 16

fq = []
for i in range(23):          # odd count -> uneven record split over blocks
    ln = int(rng.integers(5, 120))
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=ln).tobytes()
    q = rng.integers(33, 74, size=ln, dtype=np.uint8).tobytes()
    fq.append(b"@rd%d x\n%s\n+\n%s\n" % (i, s, q))
fq_data = b"".join(fq)
fq_blob, _ = encode_multihost(fq_data, EncodeOptions(level=1))
fq_host, _ = encode(fq_data, EncodeOptions(level=1))
assert fq_blob == fq_host, "multihost FASTQ archive != host archive"

# ---- O(compressed) extended path: per-host frame compression -------------
import io
from naf_tpu.parallel.multihost import encode_multihost_extended
from naf_tpu.pipeline.decoder import Decoder, DecodeOptions

# compressible payload so gathered-vs-input sizes separate clearly; small
# frames force multiple frames per host
motif_a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=512)
motif = motif_a.copy()
motif[100:300] += 32          # one soft-masked stretch (realistic runs)
motif = motif.tobytes()
big_rows = [b">big%d some comment\n" % i + motif * 24 + b"\n"
            for i in range(12)]
big = b"".join(big_rows)
traffic = {}
ext_blob, ext_stats = encode_multihost_extended(
    big, EncodeOptions(level=1, block_bytes=1 << 14), traffic=traffic)
host_blob2, _ = encode(big, EncodeOptions(level=1))
dec_ext = Decoder(io.BytesIO(ext_blob), DecodeOptions()).fasta()
dec_host = Decoder(io.BytesIO(host_blob2), DecodeOptions()).fasta()
assert dec_ext == dec_host, "extended multihost decode != host decode"
assert ext_stats.n_sequences == 12

gathered = traffic["gathered_bytes"]
comp = len(ext_blob)
assert gathered < len(big) // 4, \
    f"extended path gathered {gathered}B for {len(big)}B input"
assert gathered < 20 * comp, (gathered, comp)

# the plain multihost path on the same input gathers O(input) — prove the
# extended path's traffic is the smaller by a wide margin
assert gathered * 4 < len(big), (gathered, len(big))

# FASTQ extended: quality stream also leaves compressed
fq_traffic = {}
fq_ext, _ = encode_multihost_extended(
    fq_data, EncodeOptions(level=1, block_bytes=1 << 12),
    traffic=fq_traffic)
assert (Decoder(io.BytesIO(fq_ext), DecodeOptions()).fastq()
        == Decoder(io.BytesIO(fq_host), DecodeOptions()).fastq())

# ---- plain-format O(compressed) path: single-frame part stitching --------
from naf_tpu.parallel.multihost import encode_multihost_parts

pt_traffic = {}
parts_blob, _ = encode_multihost_parts(big, EncodeOptions(level=1),
                                       traffic=pt_traffic)
assert (Decoder(io.BytesIO(parts_blob), DecodeOptions()).fasta()
        == dec_host), "parts multihost decode != host decode"
assert not (parts_blob[4] & 0x80), "parts archive must stay PLAIN format"
pt_gathered = pt_traffic["gathered_bytes"]
assert pt_gathered < len(big) // 4, \
    f"parts path gathered {pt_gathered}B for {len(big)}B input"

fq_parts, _ = encode_multihost_parts(fq_data, EncodeOptions(level=1))
assert (Decoder(io.BytesIO(fq_parts), DecodeOptions()).fastq()
        == Decoder(io.BytesIO(fq_host), DecodeOptions()).fastq())

# ---- full input space: protein + strict + well-formed ---------------------
prot = b"".join(b">p%d c\nMKV*LNDAEFGH-ikw\nACDEF\n" % i for i in range(9))
for kw in ({"seq_type": 2}, {"strict": True}, {"well_formed": True}):
    mb, _ = encode_multihost(prot if "seq_type" in kw else data,
                             EncodeOptions(level=1, **kw))
    hb, _ = encode(prot if "seq_type" in kw else data,
                   EncodeOptions(level=1, **kw))
    assert mb == hb, f"multihost {kw} != host"

import hashlib
digest = hashlib.md5(ext_blob + fq_ext + parts_blob + fq_parts).hexdigest()
print(f"proc{pid}: OK n_rec=16 fasta={len(blob)}B fastq={len(fq_blob)}B "
      f"ext_gathered={gathered}B input={len(big)}B EXTDIGEST={digest}")
"""


@pytest.mark.skipif(os.environ.get("NAF_TPU_SKIP_MULTIHOST") == "1",
                    reason="multihost test disabled")
@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_mesh(tmp_path, nproc):
    """2- and 4-process virtual pods (2 devices each -> global mesh of 4/8).

    P=4 exercises rank>1 stitching: multi-shard `_gather_rows` reassembly
    and uneven block splits across 8 devices (SURVEY §2.4 / BASELINE
    config 5)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    w = tmp_path / "worker.py"
    w.write_text(WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(REPO)
    procs = [
        subprocess.Popen([sys.executable, str(w), coord, str(i), str(nproc)],
                         env=env, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE)
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        outs.append((p.returncode, out, err))
    digests = []
    for rc, out, err in outs:
        assert rc == 0, (out.decode()[-500:], err.decode()[-2000:])
        assert b"OK n_rec=16" in out, out
        digests.append(out.split(b"EXTDIGEST=")[1].split()[0])
    assert len(set(digests)) == 1, "extended archive differs across hosts"


def test_stitch_packed_range_matches_global():
    """Concatenating per-range outputs == stitch_packed, for every split,
    including odd char counts, empty blocks, and cross-range nibble bytes."""
    from naf_tpu.parallel.block import stitch_packed, stitch_packed_range

    rng = np.random.default_rng(7)
    for trial in range(40):
        D = int(rng.integers(1, 7))
        counts = rng.integers(0, 9, size=D)
        if trial % 5 == 0:
            counts[rng.integers(0, D)] = 0
        p_cap = 8
        packed = np.zeros((D, p_cap), np.uint8)
        first_codes = np.zeros(D, np.uint8)
        total = 0
        codes_all = []
        for d in range(D):
            cnt = int(counts[d])
            codes = rng.integers(0, 16, size=cnt).astype(np.uint8)
            codes_all.append(codes)
            if cnt:
                first_codes[d] = codes[0]
            body = codes[1:] if total % 2 else codes
            by = np.zeros(p_cap, np.uint8)
            for i, c in enumerate(body):
                if i % 2 == 0:
                    by[i // 2] |= c
                else:
                    by[i // 2] |= c << 4
            packed[d] = by
            total += cnt
        ref = stitch_packed(packed, counts, first_codes)
        for _ in range(4):
            n_cuts = int(rng.integers(0, D))
            cuts = sorted({0, D, *rng.integers(0, D + 1, size=n_cuts)})
            parts = [stitch_packed_range(
                {d: packed[d] for d in range(a, b)},
                counts, first_codes, a, b)
                for a, b in zip(cuts[:-1], cuts[1:])]
            got = (np.concatenate(parts) if parts
                   else np.zeros(0, np.uint8))
            assert np.array_equal(got, ref), (trial, cuts, counts)


def test_gather_rows_orders_uneven_shards():
    """_gather_rows reassembles rows by index even when shard order varies."""
    from naf_tpu.parallel import multihost as MH

    class Shard:
        def __init__(self, start, data):
            self.index = (slice(start, start + data.shape[0]),)
            self.data = data

    class FakeGlobal:
        def __init__(self, rows):
            # deliberately out of order, uneven split: [2:5], [0:2]
            self.addressable_shards = [Shard(2, rows[2:5]), Shard(0, rows[0:2])]

    rows = np.arange(10).reshape(5, 2)

    import naf_tpu.parallel.multihost as mh
    import jax.experimental.multihost_utils as mu
    orig = mu.process_allgather
    mu.process_allgather = lambda x: np.asarray(x)[None]   # single process
    try:
        out = MH._gather_rows(FakeGlobal(rows), 5)
    finally:
        mu.process_allgather = orig
    assert np.array_equal(out, rows)
