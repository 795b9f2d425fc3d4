"""The engine paths the reference's tier-1 tests hold, through the port on
the CPU: an align dispatch failing mid-batch falls back to the Python path
with the same bytes (tests/test_native_engine.py:49), short reads through
the native engine against the Python path (:88), and a 30 kb read across
a deletion and an inversion through the port's CLI (tests/test_e2e.py:99).
The SV case of tests/test_native_engine.py:118 (12 reads of test_3, about
4 minutes on the CPU) runs on the card, in tests/test_torch_cuda.py.
"""

import io
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ngmlr_tpu_torch.cli import build_parser, config_from_args
from ngmlr_tpu_torch.io.fastx import parse_fastx
from ngmlr_tpu_torch.pipeline.runner import Pipeline

from conftest import DATA_DIR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST2_REF = os.path.join(DATA_DIR, "test_2/ref_chr21_20kb.fa")
TEST2 = ["-r", TEST2_REF,
         "-q", os.path.join(DATA_DIR, "test_2/reads_100_2200bp.fa")]


def _pipeline(argv):
    args = build_parser().parse_args(argv)
    return Pipeline(config_from_args(args, argv), args.reference,
                    use_cache=True, device="cpu"), args.query


def _run(argv, native, monkeypatch):
    monkeypatch.setenv("NGMLR_TPU_NATIVE", "1" if native else "0")
    p, query = _pipeline(argv)
    assert (p.native is not None) == native
    buf = io.BytesIO()
    p.run(query, buf)
    if native:
        assert p.ctx.stats.get("native_failed", 0) == 0
    return [l for l in buf.getvalue().split(b"\n") if not l.startswith(b"@PG")]


def test_native_engine_dispatch_failure_falls_back():
    """An align dispatch that raises once mid-batch aborts the engine batch
    cleanly: every read falls back to the Python path and the bytes stay
    the same (the reference logs and keeps going, NGM.cpp:262-265)."""
    def run(sabotage):
        p, query = _pipeline(TEST2)
        assert p.native is not None
        if sabotage:
            orig = p.ctx.align_dispatch_pk
            calls = {"n": 0}

            def boom(*a, **kw):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise RuntimeError("injected dispatch failure")
                return orig(*a, **kw)

            p.ctx.align_dispatch_pk = boom
        buf = io.BytesIO()
        p.run(query, buf)
        return buf.getvalue(), p.ctx.stats.get("native_failed", 0)

    good, f0 = run(False)
    bad, f1 = run(True)
    assert f0 == 0 and f1 > 0
    assert good == bad


def test_native_engine_matches_python_short_reads(tmp_path, monkeypatch):
    """40 seeded reads of 40-256 bp (a few substitutions, half reverse
    complemented) ride the engine's short-read path: the same bytes as
    the Python path (pipeline/shortread.py)."""
    g = b"".join(r.seq for r in parse_fastx(TEST2_REF))
    rng = np.random.default_rng(42)
    comp = bytes.maketrans(b"ACGTacgt", b"TGCATGCA")
    reads_p = str(tmp_path / "shorts.fa")
    with open(reads_p, "wb") as f:
        for i in range(40):
            L = int(rng.integers(40, 257))
            p = int(rng.integers(0, len(g) - L))
            seq = g[p:p + L]
            if rng.random() < 0.3:
                a = bytearray(seq)
                for _ in range(int(rng.integers(1, 6))):
                    a[int(rng.integers(0, L))] = b"ACGT"[int(rng.integers(0, 4))]
                seq = bytes(a)
            if rng.random() < 0.5:
                seq = seq.translate(comp)[::-1]
            f.write(b">s%d\n" % i + seq + b"\n")
    argv = ["-r", TEST2_REF, "-q", reads_p]
    assert _run(argv, True, monkeypatch) == _run(argv, False, monkeypatch)


def test_long_read_with_sv(tmp_path):
    """A 30 kb read spanning a 1.5 kb deletion and an inverted 2 kb tail,
    through `python -m ngmlr_tpu_torch`: every CIGAR consumes the whole
    read (ConvexAlignFast.cpp:424-428), the tail maps on the reverse
    strand, and one primary record covers the bulk."""
    rng = np.random.default_rng(99)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.choice(bases, size=60_000).tobytes()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    read = (genome[5_000:10_000] + genome[11_500:16_000]
            + genome[16_000:18_000].translate(comp)[::-1])
    ref_p, q_p = tmp_path / "ref.fa", tmp_path / "r.fa"
    for path, name, seq in ((ref_p, b"chrL", genome), (q_p, b"longsv", read)):
        with open(path, "wb") as f:
            f.write(b">" + name + b"\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80] + b"\n")
    out = subprocess.run(
        [sys.executable, "-m", "ngmlr_tpu_torch", "-r", str(ref_p),
         "-q", str(q_p)], check=True, cwd=REPO, capture_output=True,
        env=dict(os.environ, NGMLR_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1"),
        timeout=600)
    records = [l.split("\t") for l in out.stdout.decode().splitlines()
               if not l.startswith("@")]
    mapped = [r for r in records if not (int(r[1]) & 0x4)]
    assert mapped, "no mapped records"
    for r in mapped:
        consumed = sum(int(n) for n, op in
                       re.findall(r"(\d+)([MIS=X])", r[5]))
        assert consumed == len(read), r[5][:80]
    assert any(int(r[1]) & 0x10 for r in mapped)
    assert len([r for r in mapped if not (int(r[1]) & 0x800)]) == 1
