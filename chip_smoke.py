#!/usr/bin/env python3
"""Smoke test of the device path on one GPU: ``python chip_smoke.py``.

Drives ``tnaf --device`` / ``untnaf --device`` as CLI subprocesses on three
inputs generated from a seed (nothing is downloaded), each at the size its
users run, and checks every result against the host path byte for byte:

  A  chromosome-scale FASTA: one 248,956,422-base record (GRCh38 chr1's
     length), 60 per line, ~50% soft-masked in runs of 100-10,000, ~8% N
     gaps.  In-memory sharded encode; uniform-group decode render.
  B  short-read FASTQ: 1,200,000 reads x 150 bp, quality '#'..'J'.
     Streaming DeviceScanEngine encode (64 MB chunks); uniform-group
     FASTQ render.
  C  many-record FASTA: 100,000 records of 500-3,000 bp, IUPAC codes,
     soft-masked.  In-memory encode; ragged gather render.

Per phase: the device archive must equal the host archive, both decoders
must reproduce the input, and the trace (NAF_TPU_TRACE) must show the
device stages ran on the GPU with no chunk requeued to the host.  Every
child runs with NAF_TPU_NO_FALLBACK=1, so a device fault fails the run.
Then the on-card tests (tests/test_on_chip.py) run in a child.

Only one process uses the card at a time: the parent never imports JAX
(device facts come from a child), and children run one after another.

``--cards 4`` instead runs phases A and C through ``encode_sharded`` and
the gather render over a 4-card mesh (encode and render each in a child of
its own, so each child's per-card peak memory shows that card took part),
and ``encode_multihost`` with four processes, one card each; every archive
must equal the host archive.
``--profile DIR`` also records a JAX profiler trace of every device CLI
call and prints each jitted program's device time and the device's busy
time.

The last line of stdout is {"ok": true, "device": {...}} with the device
as JAX reports it; any failure raises (non-zero exit, no such line).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shlex
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0

CHR1_LEN = 248_956_422


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# ---------------------------------------------------------------------------
# inputs (numpy only, from a seed)
# ---------------------------------------------------------------------------

def _runs(rng, n: int, lo_a: int, hi_a: int, lo_b: int, hi_b: int):
    """bool[n]: alternating runs, False lengths in [lo_a, hi_a), True
    lengths in [lo_b, hi_b), starting with False."""
    k = 2 * (n // (lo_a + lo_b) + 2)
    lens = np.empty(k, np.int64)
    lens[0::2] = rng.integers(lo_a, hi_a, k // 2)
    lens[1::2] = rng.integers(lo_b, hi_b, k // 2)
    ends = np.cumsum(lens)
    k = int(np.searchsorted(ends, n)) + 1
    flags = np.zeros(k, bool)
    flags[1::2] = True
    return np.repeat(flags, lens[:k])[:n]


def _layout(headers: list, lens: np.ndarray, seq: np.ndarray,
            width: int) -> bytes:
    """FASTA bytes: each header line, then its record's chars wrapped at
    ``width`` (vectorized: every byte's output position is computed)."""
    hdr = np.frombuffer(b"".join(headers), np.uint8)
    hl = np.fromiter((len(h) for h in headers), np.int64, len(headers))
    body = lens + -(-lens // width)
    rec_out = np.concatenate([[0], np.cumsum(hl + body)[:-1]])
    out = np.full(int((hl + body).sum()), ord("\n"), np.uint8)
    hstart = np.repeat(rec_out, hl)
    hoff = np.arange(hdr.size) - np.repeat(np.cumsum(hl) - hl, hl)
    out[hstart + hoff] = hdr
    p = np.arange(seq.size) - np.repeat(np.cumsum(lens) - lens, lens)
    out[np.repeat(rec_out + hl, lens) + p + p // width] = seq
    return out.tobytes()


def gen_chromosome() -> bytes:
    rng = np.random.default_rng(SEED)
    n = CHR1_LEN
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n, np.uint8)]
    seq = seq | (_runs(rng, n, 100, 10_001, 100, 10_001).astype(np.uint8)
                 << 5)
    # N gaps: 10-100 kb runs between 100 kb-1.165 Mb stretches (~8%)
    seq[_runs(rng, n, 100_000, 1_165_000, 10_000, 100_000)] = ord("N")
    return _layout([b">chr1 synthetic seed=%d\n" % SEED],
                   np.asarray([n]), seq, 60)


def gen_reads() -> bytes:
    rng = np.random.default_rng(SEED + 1)
    n = 1_200_000
    hdr = np.frombuffer(b"".join(b"@SIM.%07d length=150\n" % i
                                 for i in range(n)), np.uint8)
    hdr = hdr.reshape(n, -1)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 150),
                                                        np.uint8)]
    seq[rng.random((n, 150)) < 0.001] = ord("N")
    qual = rng.integers(ord("#"), ord("J") + 1, (n, 150), np.uint8)
    lf = np.full((n, 1), ord("\n"), np.uint8)
    plus = np.tile(np.frombuffer(b"+\n", np.uint8), (n, 1))
    return np.concatenate([hdr, seq, lf, plus, qual, lf], axis=1).tobytes()


def gen_records() -> bytes:
    rng = np.random.default_rng(SEED + 2)
    n = 100_000
    lens = rng.integers(500, 3001, n)
    total = int(lens.sum())
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, total)]
    iupac = rng.random(total) < 0.02
    seq[iupac] = np.frombuffer(b"RYKMSWBDHVN", np.uint8)[
        rng.integers(0, 11, int(iupac.sum()))]
    seq = seq | (_runs(rng, total, 200, 4000, 50, 2000).astype(np.uint8)
                 << 5)
    headers = [b">seq%d taxon=%d sample %s\n"
               % (i, int(rng.integers(1, 10 ** int(rng.integers(1, 7)))),
                  b"x" * int(rng.integers(0, 20))) for i in range(n)]
    return _layout(headers, lens, seq, 60)


PHASES = {
    # name: (generator, file suffix, expected decode span)
    "A": (gen_chromosome, "fa", "device-regular"),
    "B": (gen_reads, "fq", "device-regular"),
    "C": (gen_records, "fa", "device-gather"),
}


# ---------------------------------------------------------------------------
# children
# ---------------------------------------------------------------------------

class Smoke:
    def __init__(self, cards: int, work: Path):
        self.cards = cards
        self.work = work

    def env(self, device: bool, **extra) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
        env["TMPDIR"] = str(self.work)
        env["NAF_TPU_NO_FALLBACK"] = "1"
        if device:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(i) for i in range(self.cards))
        else:
            env["CUDA_VISIBLE_DEVICES"] = ""       # host children: no card
        env.update({k: str(v) for k, v in extra.items()})
        return env

    def run(self, args: list, *, device: bool, timeout: int = 900,
            **extra) -> subprocess.CompletedProcess:
        t0 = time.perf_counter()
        r = subprocess.run(args, env=self.env(device, **extra), cwd=REPO,
                           capture_output=True, timeout=timeout)
        r.seconds = time.perf_counter() - t0
        if r.returncode != 0:
            sys.stderr.write(r.stderr.decode("utf-8", "replace")[-4000:])
        check(r.returncode == 0,
              f"{' '.join(map(str, args[:4]))}... exited {r.returncode}")
        return r

    def probe(self) -> dict:
        code = ("import json, jax; d = jax.devices(); print(json.dumps("
                "{'platform': d[0].platform, 'kind': d[0].device_kind, "
                "'count': len(d), 'jax': jax.__version__}))")
        r = self.run([sys.executable, "-c", code], device=True, timeout=300)
        info = json.loads(r.stdout.decode().strip().splitlines()[-1])
        info["startup_s"] = round(r.seconds, 3)
        check(info["platform"] == "gpu", f"JAX found no GPU: {info}")
        check(info["count"] == self.cards,
              f"expected {self.cards} devices, JAX sees {info['count']}")
        return info


def trace_lines(stderr: bytes) -> list:
    """[(stage, fields)] of the '[naf-trace] stage [12.3 ms ...] k=v'
    lines (a span's wall time lands in fields["ms"])."""
    out = []
    for ln in stderr.decode("utf-8", "replace").splitlines():
        m = re.match(r"\[naf-trace\] (\S+)\s+(.*)", ln)
        if m:
            fields = dict(kv.split("=", 1) for kv in shlex.split(m.group(2))
                          if "=" in kv)
            t = re.match(r"([\d.]+) ms", m.group(2))
            if t:
                fields["ms"] = t.group(1)
            out.append((m.group(1), fields))
    return out


def sha(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def device_facts(lines: list, stages: list) -> dict:
    """Check the device stages ran on the GPU; returns the closing 'device'
    line's fields plus span counts."""
    facts = {}
    for stage in stages:
        spans = [f for s, f in lines if s == stage]
        check(spans, f"no {stage} span in the trace")
        plats = {f.get("platform") for f in spans}
        check(plats == {"gpu"}, f"{stage} ran on {plats}, not the GPU")
        facts[stage] = len(spans)
    dev = [f for s, f in lines if s == "device"]
    check(len(dev) == 1 and dev[0]["platform"] == "gpu",
          f"device line: {dev}")
    facts.update(compile_s=float(dev[0]["compile_s"]),
                 peak_bytes_in_use=dev[0]["peak_bytes_in_use"])
    return facts


def phase(smoke: Smoke, name: str, profile: Path | None):
    gen, suffix, decode_span = PHASES[name]
    t0 = time.perf_counter()
    data = gen()
    src = smoke.work / f"{name}.{suffix}"
    src.write_bytes(data)
    gen_s = time.perf_counter() - t0
    in_sha = hashlib.sha256(data).hexdigest()
    size = len(data)
    del data
    tnaf = [sys.executable, "-m", "naf_tpu.cli.tnaf"]
    untnaf = [sys.executable, "-m", "naf_tpu.cli.untnaf"]
    host_naf, dev_naf = smoke.work / "host.naf", smoke.work / "dev.naf"
    host_out, dev_out = smoke.work / "host.out", smoke.work / "dev.out"

    def prof(kind):
        return ({"NAF_TPU_PROFILE": profile / f"{name}-{kind}"}
                if profile is not None else {})

    h_enc = smoke.run(tnaf + [str(src), "-o", str(host_naf)], device=False)
    d_enc = smoke.run(tnaf + ["--device", str(src), "-o", str(dev_naf)],
                      device=True, NAF_TPU_TRACE=1, **prof("encode"))
    check(sha(host_naf) == sha(dev_naf),
          f"phase {name}: device archive != host archive")
    enc_lines = trace_lines(d_enc.stderr)
    enc = device_facts(enc_lines, ["device-stats", "device-emit"])
    stream = [f for s, f in enc_lines if s == "device-stream"]
    if name == "B":
        check(len(stream) == 1, "phase B did not take the streaming engine")
    for f in stream:
        check(int(f["device_chunks"]) > 0 and int(f["fault_chunks"]) == 0,
              f"phase {name}: stream engine {f}")
        enc["stream"] = {k: int(v) for k, v in f.items()}

    h_dec = smoke.run(untnaf + [str(host_naf), "-o", str(host_out)],
                      device=False)
    check(sha(host_out) == in_sha, f"phase {name}: host output != input")
    d_dec = smoke.run(untnaf + ["--device", str(dev_naf), "-o",
                                str(dev_out)],
                      device=True, NAF_TPU_TRACE=1, **prof("decode"))
    check(sha(dev_out) == in_sha, f"phase {name}: device output != input")
    dec_lines = trace_lines(d_dec.stderr)
    dec = device_facts(dec_lines, [decode_span])
    for facts, lines in ((enc, enc_lines), (dec, dec_lines)):
        ms = {}
        for stage, f in lines:
            if stage.startswith("device-") and "ms" in f:
                ms[stage] = ms.get(stage, 0.0) + float(f["ms"])
        facts["span_ms"] = {k: round(v, 3) for k, v in ms.items()}
    row = dict(phase=name, input_bytes=size,
               archive_bytes=host_naf.stat().st_size,
               archive_identical=True, output_identical=True,
               generate_s=round(gen_s, 3),
               host_encode_s=round(h_enc.seconds, 3),
               device_encode_s=round(d_enc.seconds, 3),
               host_decode_s=round(h_dec.seconds, 3),
               device_decode_s=round(d_dec.seconds, 3),
               encode=enc, decode=dec)
    print("phase", json.dumps(row), flush=True)
    for p in (src, host_naf, dev_naf, host_out, dev_out):
        p.unlink()


def on_card_tests(smoke: Smoke):
    r = smoke.run([sys.executable, "-m", "pytest", "-q", "-m", "chip",
                   "-p", "no:cacheprovider", "tests/test_on_chip.py"],
                  device=True, timeout=900, NAF_TPU_REAL_DEVICE=1)
    tail = r.stdout.decode("utf-8", "replace").strip().splitlines()[-1]
    check("passed" in tail and "failed" not in tail
          and "skipped" not in tail, f"on-card tests: {tail}")
    print("on-card tests:", tail, flush=True)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _card_peaks(mesh) -> list:
    """Each card's peak bytes in use in this process; all must be > 0, so
    no card sat idle while device 0 did the work."""
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in mesh.devices.flat]
    check(all(p > 0 for p in peaks), f"idle cards: {peaks}")
    return peaks


def mesh_encode_child(src: str, naf: str) -> None:
    """Child body: encode_sharded over a mesh of every visible card,
    checked against the host archive, which is written to ``naf``."""
    from naf_tpu.parallel.mesh import block_mesh
    from naf_tpu.parallel.pipeline import encode_sharded
    from naf_tpu.pipeline.encoder import EncodeOptions, encode

    data = Path(src).read_bytes()
    mesh = block_mesh()
    D = mesh.devices.size
    host, _ = encode(data, EncodeOptions())
    t0 = time.perf_counter()
    blob, _ = encode_sharded(data, EncodeOptions(), mesh=mesh)
    enc_s = time.perf_counter() - t0
    check(blob == host, f"{D}-card archive != host archive")
    Path(naf).write_bytes(blob)
    print(json.dumps(dict(step="encode", cards=D, input_bytes=len(data),
                          archive_bytes=len(blob), archive_identical=True,
                          encode_s=round(enc_s, 3),
                          platforms=sorted({d.platform for d in
                                            mesh.devices.flat}),
                          peak_bytes_in_use=_card_peaks(mesh))), flush=True)


def mesh_decode_child(src: str, naf: str) -> None:
    """Child body: the gather render of ``naf`` over a mesh of every
    visible card, checked against the input ``src``."""
    import io

    from naf_tpu.parallel.mesh import block_mesh
    from naf_tpu.pipeline.decoder import Decoder, DecodeOptions

    blob = Path(naf).read_bytes()
    mesh = block_mesh()
    D = mesh.devices.size
    t0 = time.perf_counter()
    out = Decoder(io.BytesIO(blob), DecodeOptions()).fasta_device(mesh=mesh)
    dec_s = time.perf_counter() - t0
    check(out == Path(src).read_bytes(), f"{D}-card render != input")
    print(json.dumps(dict(step="decode", cards=D, output_bytes=len(out),
                          output_identical=True, decode_s=round(dec_s, 3),
                          platforms=sorted({d.platform for d in
                                            mesh.devices.flat}),
                          peak_bytes_in_use=_card_peaks(mesh))), flush=True)


def multihost_child(pid: int, nproc: int, port: int, src: str) -> None:
    """Child body: one process per card under jax.distributed."""
    import jax

    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nproc, process_id=pid,
                               local_device_ids=[pid])
    from naf_tpu.parallel.multihost import encode_multihost
    from naf_tpu.pipeline.encoder import EncodeOptions, encode

    data = Path(src).read_bytes()
    t0 = time.perf_counter()
    blob, _ = encode_multihost(data, EncodeOptions())
    enc_s = time.perf_counter() - t0
    host, _ = encode(data, EncodeOptions())
    check(blob == host, f"multihost archive != host archive (process {pid})")
    print(json.dumps(dict(process=pid, processes=nproc,
                          devices=len(jax.devices()),
                          local=[d.id for d in jax.local_devices()],
                          archive_identical=True,
                          encode_s=round(enc_s, 3))), flush=True)
    jax.distributed.shutdown()


def four_cards(smoke: Smoke) -> None:
    for name in ("A", "C"):
        src, naf = smoke.work / f"{name}.fa", smoke.work / f"{name}.naf"
        src.write_bytes(PHASES[name][0]())
        for step in ("encode", "decode"):
            r = smoke.run([sys.executable, "-c",
                           f"import chip_smoke; chip_smoke.mesh_{step}_child("
                           f"{str(src)!r}, {str(naf)!r})"],
                          device=True, timeout=1200)
            print("mesh", name, r.stdout.decode().strip().splitlines()[-1],
                  flush=True)
        naf.unlink()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.multihost_child("
             f"{pid}, {smoke.cards}, {port}, {str(src)!r})"],
            env=smoke.env(True), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for pid in range(smoke.cards)]
        try:
            outs = [p.communicate(timeout=1200) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (o, e) in zip(procs, outs):
            if p.returncode != 0:
                sys.stderr.write(e.decode("utf-8", "replace")[-3000:])
            check(p.returncode == 0, f"multihost process exited "
                                     f"{p.returncode}")
            print("multihost", name, o.decode().strip().splitlines()[-1],
                  flush=True)
        src.unlink()


# ---------------------------------------------------------------------------
# profiler traces -> per-program device time
# ---------------------------------------------------------------------------

def reduce_traces(profile: Path) -> None:
    """Per trace: device time per XLA module (jitted program) and per
    memcpy direction, summed over the GPU's stream lines, plus the device
    busy time (union of event intervals) over the traced window."""
    import jax

    rows = {}
    for pb in sorted(profile.glob("*/plugins/profile/*/*.xplane.pb")):
        run = pb.relative_to(profile).parts[0]
        per, spans = {}, []
        for plane in jax.profiler.ProfileData.from_file(str(pb)).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    stats = dict(ev.stats)
                    key = (ev.name if ev.name.startswith("Memcpy")
                           else str(stats.get("hlo_module", ev.name)))
                    per.setdefault(key, [0, 0.0])
                    per[key][0] += 1
                    per[key][1] += ev.duration_ns / 1e6
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        busy, end = 0.0, None
        for s0, s1 in sorted(spans):
            if end is None or s0 > end:
                busy += s1 - s0
                end = s1
            elif s1 > end:
                busy += s1 - end
                end = s1
        window = (max(s[1] for s in spans) - min(s[0] for s in spans)
                  if spans else 0)
        rows[run] = dict(
            device_busy_ms=round(busy / 1e6, 3),
            device_window_ms=round(window / 1e6, 3),
            programs={k: {"events": c, "device_ms": round(ms, 3)}
                      for k, (c, ms) in sorted(per.items(),
                                               key=lambda kv: -kv[1][1])})
        print("trace", run, json.dumps(rows[run]), flush=True)
    (profile / "stages.json").write_text(json.dumps(rows, indent=1))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--profile", type=Path, default=None,
                    help="record profiler traces of the device calls here")
    args = ap.parse_args(argv)
    check((REPO / "naf_tpu" / "__init__.py").is_file(),
          f"no naf_tpu package beside {Path(__file__).name}")

    work = Path(tempfile.mkdtemp(prefix="naf_smoke_"))
    try:
        smoke = Smoke(args.cards, work)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader",
             "--id=" + ",".join(str(i) for i in range(args.cards))],
            capture_output=True, text=True, timeout=60)
        check(smi.returncode == 0, "nvidia-smi failed")
        print(smi.stdout.strip(), flush=True)
        info = smoke.probe()
        print(f"jax {info['jax']} on {info['count']} x {info['kind']} "
              f"({info['platform']}); process start to devices listed "
              f"{info['startup_s']} s", flush=True)
        # build the native host library (first use) before any timed call
        r = smoke.run([sys.executable, "-c", "from naf_tpu import native; "
                       "print(native.available())"], device=False)
        print("native host library:", r.stdout.decode().strip(),
              f"({r.seconds:.3f} s)", flush=True)
        if args.cards == 4:
            four_cards(smoke)
        else:
            profile = args.profile.resolve() if args.profile else None
            if profile is not None:
                profile.mkdir(parents=True, exist_ok=True)
            for name in PHASES:
                phase(smoke, name, profile)
            on_card_tests(smoke)
            if profile is not None:
                reduce_traces(profile)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
