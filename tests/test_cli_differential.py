"""Differential CLI fuzz: tnaf|untnaf vs ennaf|unnaf on randomized inputs.

Full pipe round trips with randomized encode/decode flag combinations;
stdout must match byte-for-byte, stderr after tool-name normalization.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import HAVE_REFERENCE, REF_BUILD

pytestmark = pytest.mark.skipif(not HAVE_REFERENCE,
                                reason="reference binaries unavailable")

PY = sys.executable


def _norm(b: bytes) -> bytes:
    return b.replace(b"untnaf", b"unnaf").replace(b"tnaf", b"ennaf")


def _norm_sizes(b: bytes) -> bytes:
    """--sizes output with the compressed-bytes column masked.

    Compressed sizes are an implementation detail (our high-level sections
    compress one-shot with a pledged source size: a few header bytes differ
    from the reference's streamed frames); the contract is decodability +
    content round-trip + ratio parity, so compare only the labels and the
    original sizes ('Label: <comp> / <orig> (<pct>%)' -> 'Label: <orig>')."""
    out = []
    for line in b.splitlines(keepends=True):
        if b" / " in line and line.rstrip().endswith(b"%)"):
            head, rest = line.split(b": ", 1)
            orig = rest.split(b" / ", 1)[1].split(b" (", 1)[0]
            out.append(head + b": " + orig + b"\n")
        else:
            out.append(line)
    return b"".join(out)


def _run(cmd, data):
    env = dict(os.environ, TMPDIR="/tmp", PYTHONPATH="")
    return subprocess.run(cmd, input=data, capture_output=True, env=env,
                          timeout=300)


def _pipe(enc_args, dec_args, data, ours: bool):
    if ours:
        enc = [PY, "-m", "naf_tpu.cli.tnaf", *enc_args, "-c"]
        dec = [PY, "-m", "naf_tpu.cli.untnaf", *dec_args, "-c"]
    else:
        enc = [str(REF_BUILD / "ennaf"), *enc_args, "-c"]
        dec = [str(REF_BUILD / "unnaf"), *dec_args, "-c"]
    p = _run(enc, data)
    q = _run(dec, p.stdout)
    return p, q


def _gen_fasta(rng):
    recs = []
    for i in range(int(rng.integers(1, 12))):
        ln = int(rng.integers(0, 800))
        seq = rng.choice(np.frombuffer(b"ACGTacgtNnRYwk-U\x07 ", np.uint8),
                         size=ln).tobytes()
        line = int(rng.integers(10, 90))
        body = b"\n".join(seq[k:k + line] for k in range(0, len(seq), line))
        recs.append(b">%s%d desc\n%s\n" % (b"seq", i, body))
    return b"".join(recs)


def _gen_fastq(rng):
    recs = []
    for i in range(int(rng.integers(1, 30))):
        ln = int(rng.integers(1, 200))
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=ln).tobytes()
        qual = rng.choice(np.frombuffer(b"IJKF#!~", np.uint8),
                          size=ln).tobytes()
        recs.append(b"@r%d x/%d\n%s\n+\n%s\n" % (i, i, seq, qual))
    return b"".join(recs)


ENC_CHOICES = [[], ["--no-mask"], ["-9"], ["--rna"], ["--protein"],
               ["--text"], ["--well-formed"], ["--line-length", "33"],
               ["--title", "fuzz"]]
DEC_CHOICES = [[], ["--no-mask"], ["--seq"], ["--sequences"], ["--ids"],
               ["--names"], ["--lengths"], ["--charcount"],
               ["--line-length", "50"], ["--sizes"], ["--part-list"],
               ["--total-length"], ["--mask"]]


@pytest.mark.parametrize("trial", range(25))
def test_differential_roundtrip(trial):
    rng = np.random.default_rng(1000 + trial)
    fastq = trial % 3 == 2
    data = _gen_fastq(rng) if fastq else _gen_fasta(rng)
    enc_args = list(ENC_CHOICES[int(rng.integers(len(ENC_CHOICES)))])
    dec_args = list(DEC_CHOICES[int(rng.integers(len(DEC_CHOICES)))])
    if fastq:
        enc_args = [a for a in enc_args
                    if a not in ("--well-formed", "--text", "--protein")]
        if dec_args and dec_args[0] == "--mask":
            dec_args = []
    if "--text" in enc_args or "--protein" in enc_args:
        if dec_args and dec_args[0] == "--mask":
            dec_args = []

    p_ref, q_ref = _pipe(enc_args, dec_args, data, ours=False)
    p_our, q_our = _pipe(enc_args, dec_args, data, ours=True)

    ctx = (trial, enc_args, dec_args)
    assert (p_our.returncode == 0) == (p_ref.returncode == 0), ctx
    assert _norm(p_our.stderr) == p_ref.stderr, ctx
    if dec_args[:1] == ["--sizes"]:
        assert _norm_sizes(q_our.stdout) == _norm_sizes(q_ref.stdout), ctx
    else:
        assert q_our.stdout == q_ref.stdout, ctx
    assert (q_our.returncode == 0) == (q_ref.returncode == 0), ctx


@pytest.mark.parametrize("threads", ["0", "1", "2", "4"])
def test_threads_flag_reference_decodable(threads):
    """tnaf --threads N must emit single-frame sections the reference
    unnaf decodes; output bytes must match the single-threaded pipeline."""
    rng = np.random.default_rng(7)
    data = _gen_fasta(rng)
    p = _run([PY, "-m", "naf_tpu.cli.tnaf", "--threads", threads, "-19",
              "--long", "20", "-c"], data)
    assert p.returncode == 0, p.stderr
    q_ref = _run([str(REF_BUILD / "unnaf"), "-c"], p.stdout)
    q_our = _run([PY, "-m", "naf_tpu.cli.untnaf", "-c"], p.stdout)
    assert q_ref.returncode == 0
    assert q_our.stdout == q_ref.stdout
    # default (no flag) must also stay reference-decodable
    p2 = _run([PY, "-m", "naf_tpu.cli.tnaf", "-c"], data)
    q2 = _run([str(REF_BUILD / "unnaf"), "-c"], p2.stdout)
    assert q2.returncode == 0 and q2.stdout == q_ref.stdout


def test_device_flag_byte_identical():
    """tnaf --device (sharded mesh pipeline) must produce the same archive
    bytes as the host pipeline (JAX_PLATFORMS=cpu keeps the test hermetic)."""
    rng = np.random.default_rng(11)
    data = _gen_fasta(rng)
    env = dict(os.environ, TMPDIR="/tmp", PYTHONPATH="",
               JAX_PLATFORMS="cpu")
    p_dev = subprocess.run([PY, "-m", "naf_tpu.cli.tnaf", "--device", "-c"],
                           input=data, capture_output=True, env=env, timeout=300)
    p_host = subprocess.run([PY, "-m", "naf_tpu.cli.tnaf", "-c"],
                            input=data, capture_output=True, env=env, timeout=300)
    assert p_dev.returncode == 0, p_dev.stderr
    assert p_dev.stdout == p_host.stdout
