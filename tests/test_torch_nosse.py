"""--nosse in the port, on the CPU. The CLI flag sets NGMLR_TPU_NO_PALLAS,
as the JAX package's does: a DeviceContext built under it calls the plain
versions of the four alignment kernels itself, and the aligner's
--stdout 6 dump adds each alignment's per-row corridor (the reference's
scalar fwdFillMatrix dump). Both CLIs run as subprocesses, so the port is
never imported into the JAX package's process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ngmlr_tpu_torch.ops import device_engine as tde
from ngmlr_tpu_torch.ops import kernels as K

from chip_smoke import align_rows, score_rows
from conftest import DATA_DIR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = (2.0, -5.0, -5.0, -5.0, -1.0, 0.15)
ALIGN_KERNELS = ("corridor_windows", "convex_fill", "convex_backtrack")


def _dump6(module, env):
    r = subprocess.run(
        [sys.executable, "-m", module,
         "-r", os.path.join(DATA_DIR, "test_2/ref_chr21_20kb.fa"),
         "-q", os.path.join(DATA_DIR, "test_2/reads_100_2200bp.fa"),
         "-x", "pacbio", "--stdout", "6", "--nosse", "-o", os.devnull],
        capture_output=True, cwd=REPO, timeout=900,
        env=dict(os.environ, NGMLR_TPU_STRICT="1", OMP_NUM_THREADS="1",
                 **env))
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_nosse_stdout6_matches_the_reference():
    """--stdout 6 --nosse on test_2: the port prints the JAX package's
    bytes, the per-row corridor lines included."""
    port = _dump6("ngmlr_tpu_torch", {"NGMLR_TORCH_DEVICE": "cpu"})
    ref = _dump6("ngmlr_tpu", {"JAX_PLATFORMS": "cpu"})
    assert port.count(b"\n") == ref.count(b"\n") > 30_000
    assert port == ref


def _waves(monkeypatch, nosse, patch):
    """A score wave (96 rows at the 306 x 256 subread shape, 8 of them over
    planted reads) and an align wave (16 rows of all four corridor modes,
    each query a mutated copy of its window) through a context on the CPU
    built with or without
    NGMLR_TPU_NO_PALLAS, the four wrappers replaced by `patch(name,
    wrapper)`. Returns (context, scores, align results)."""
    if nosse:
        monkeypatch.setenv("NGMLR_TPU_NO_PALLAS", "1")
    else:
        monkeypatch.delenv("NGMLR_TPU_NO_PALLAS", raising=False)
    for name in ("score_fill",) + ALIGN_KERNELS:
        monkeypatch.setattr(K, name, patch(name, getattr(K, name)))
    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, 40_000).astype(np.uint8)
    readbuf = np.full(16_384, 4, np.uint8)
    spk = score_rows(rng, len(genome), len(readbuf), 96)
    apk = align_rows(rng, genome, readbuf, 16, (200, 700), (0, 1),
                     (40, 160), (0, 1, 2, 3), plant=True)
    # eight score rows over the forward rows' windows and planted reads
    fwd = apk[::2]
    spk[:8, 0], spk[:8, 1] = fwd[:, 0], fwd[:, 0] + 306
    spk[:8, 2], spk[:8, 4], spk[:8, 6] = 0, fwd[:, 4], 0
    ctx = tde.DeviceContext(genome, device="cpu")
    ctx.upload_reads(readbuf)
    scores = ctx.score_wave_np(spk)
    res = ctx.align_finalize_pk(ctx.align_dispatch_pk(apk, PARAMS))
    return ctx, scores, res


def test_nosse_context_calls_the_plain_versions(monkeypatch):
    reached = []

    def counted(name, wrapper):
        def call(*a, **kw):
            reached.append(name)
            return wrapper(*a, **kw)
        return call

    def refused(name, wrapper):
        def call(*a, **kw):
            raise AssertionError("%s's wrapper called under --nosse" % name)
        return call

    ctx, want_s, want_a = _waves(monkeypatch, False, counted)
    assert not ctx.plain_kernels and ctx.stats["plain_kernels"] == 0
    assert set(reached) == {"score_fill"} | set(ALIGN_KERNELS)
    monkeypatch.undo()
    ctx, got_s, got_a = _waves(monkeypatch, True, refused)
    assert ctx.plain_kernels and ctx.stats["plain_kernels"] == 1
    np.testing.assert_array_equal(got_s, want_s)
    assert want_s.max() > 40
    for g, w in zip(got_a[:6], want_a[:6]):
        np.testing.assert_array_equal(g, w)
    assert want_a[5].sum() >= 12            # backtracks that reached STOP
    for g, w in zip(got_a[6], want_a[6]):
        np.testing.assert_array_equal(g, w)


def test_nosse_plain_version_failure_raises(monkeypatch):
    """A failing plain version raises out of the wave, as a failing kernel
    does; nothing falls back to the wrapper."""
    def boom(*a, **kw):
        raise RuntimeError("plain fill failed")

    monkeypatch.setattr(K, "convex_fill_plain", boom)
    with pytest.raises(RuntimeError, match="plain fill failed"):
        _waves(monkeypatch, True, lambda name, w: w)
