"""End-to-end runs of the PyTorch port (ngmlr_tpu_torch) on the CPU: its
SAM output must be byte-identical to the reference binary's goldens and to
ngmlr_tpu's own Pipeline on the same input (the @PG line excluded), for any
intake batch size, through the native engine and through the Python path.
"""

import io
import os
import subprocess
import sys

import pytest
import torch

from ngmlr_tpu_torch.cli import build_parser, config_from_args
from ngmlr_tpu_torch.pipeline.runner import Pipeline

from conftest import DATA_DIR, GOLDEN_DIR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST2 = ["-r", os.path.join(DATA_DIR, "test_2/ref_chr21_20kb.fa"),
         "-q", os.path.join(DATA_DIR, "test_2/reads_100_2200bp.fa")]
TEST6 = ["-r", os.path.join(DATA_DIR, "test_6/reference.fasta.gz"),
         "-q", os.path.join(DATA_DIR, "test_6/read.fa.gz")]


def _records(sam_bytes):
    return [l for l in sam_bytes.split(b"\n") if not l.startswith(b"@PG")]


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return _records(f.read())


def _run(argv, batch_reads=None, pipeline_cls=Pipeline, **kw):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args, argv)
    if batch_reads is not None:
        cfg.batch_reads = batch_reads
    pipeline = pipeline_cls(cfg, args.reference, use_cache=True, **kw)
    buf = io.BytesIO()
    pipeline.run(args.query, buf)
    return pipeline, _records(buf.getvalue())


@pytest.mark.parametrize("preset,golden", [("pacbio", "test_2.sam"),
                                           ("ont", "test_2_ont.sam")])
def test_golden_test2(preset, golden):
    p, out = _run(TEST2 + ["-x", preset], device="cpu")
    assert p.ctx.device.type == "cpu"
    assert p.ctx.stats.get("engine_waves", 0) > 0
    assert out == _golden(golden)


def test_matches_jax_pipeline():
    """The port and ngmlr_tpu give the same bytes on the same input."""
    from ngmlr_tpu.cli import build_parser as jparser
    from ngmlr_tpu.cli import config_from_args as jconfig
    from ngmlr_tpu.pipeline.runner import Pipeline as JPipeline
    args = jparser().parse_args(TEST6)
    jp = JPipeline(jconfig(args, TEST6), args.reference, use_cache=True)
    buf = io.BytesIO()
    jp.run(args.query, buf)
    _, out = _run(TEST6, device="cpu")
    assert out == _records(buf.getvalue())
    assert out == _golden("test_6.sam")


def test_batch_size_invariance():
    """The intake batch is a throughput knob, never a semantic one: a
    batch smaller than an intake group and one larger than the input give
    the golden bytes (which the default batch gives, test_golden_test2)."""
    for batch_reads in (5, 1024):
        _, out = _run(TEST2, batch_reads=batch_reads, device="cpu")
        assert out == _golden("test_2.sam"), batch_reads


def test_native_engine_matches_python_path(monkeypatch):
    """The native C++ assembly engine and the Python assembly path (which
    posts its waves through the object API: score_dispatch/align_dispatch)
    give the same bytes."""
    outs = {}
    for native in ("1", "0"):
        monkeypatch.setenv("NGMLR_TPU_NATIVE", native)
        p, outs[native] = _run(TEST2, device="cpu")
        if native == "1":
            assert p.native is not None
            assert p.ctx.stats.get("native_failed", 0) == 0
        else:
            assert p.native is None
    assert outs["1"] == outs["0"]


def _cli(env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **env_extra)
    return subprocess.run([sys.executable, "-m", "ngmlr_tpu_torch"] + TEST6,
                          cwd=REPO, env=env, capture_output=True)


def test_cli_runs_on_the_cpu_when_asked():
    r = _cli({"NGMLR_TORCH_DEVICE": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert _records(r.stdout) == _golden("test_6.sam")


def test_cli_without_a_card_raises():
    """The CLI defaults to the card and never falls back to the CPU."""
    r = _cli({"NGMLR_TORCH_DEVICE": "cuda", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert b"NGMLR_TORCH_DEVICE=cpu" in r.stderr
    assert not [l for l in r.stdout.split(b"\n") if l and l[:1] != b"@"]
