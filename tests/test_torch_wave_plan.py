"""The native wave's planner (csrc/wave_plan.h, which csrc/wave.cu compiles
into the kernel library and the engine library exports for these tests)
against DeviceContext's own plan (ops/device_engine.py plan_align_rows,
plan_score_rows): the same launches, shapes, rows, row order, refused
rows and cells, on seeded rows. And the paths that keep the Python wave
(the CPU, a mesh, --nosse's plain kernels): the golden bytes, and no wave
counted as native.
"""

import io
import os

import numpy as np
import pytest
import torch

from ngmlr_tpu_torch.cli import build_parser, config_from_args
from ngmlr_tpu_torch.native import get_engine_lib
from ngmlr_tpu_torch.ops import device_engine as tde
from ngmlr_tpu_torch.pipeline import native_engine
from ngmlr_tpu_torch.pipeline.runner import Pipeline

from conftest import DATA_DIR, GOLDEN_DIR

torch.set_num_threads(1)

CAP = 4 << 30


def _align_rows(seed, n, W=(200, 3000), H=(200, 3000), width=(20, 400),
                modes=(0, 1, 2, 3)):
    """n align rows over every corridor mode; mode 0 (FULL) rows span
    their whole window, as the engine builds them."""
    rng = np.random.default_rng(seed)
    pk = np.zeros((n, 12), np.int32)
    pkf = pk.view(np.float32)
    for b in range(n):
        w, h = int(rng.integers(*W)), int(rng.integers(*H))
        mode = modes[b % len(modes)]
        wd = int(rng.integers(*width))
        ci, cf = 0, (float(rng.uniform(0.2, 3.0)), float(rng.uniform(-50, 50)))
        if mode == 0:
            ci = int(-0.2 * (w + 1))
            wd = w + 1 + int(0.2 * (w + 1))
        elif mode == 1:
            ci, cf = wd // 2, (1.0, 0.0)
        ds = int(rng.integers(0, 1 << 27))
        pk[b, :10] = (ds, ds + w, int(rng.integers(0, 5)), w,
                      int(rng.integers(0, 1 << 20)), h, b & 1, mode, ci, wd)
        pkf[b, 10:12] = cf
    # a non-positive slope takes the conservative bound
    pkf[n // 2, 10] = -0.5
    return pk


def _native_align(pk, conservative=False, lanes=0, cap=CAP):
    lib = get_engine_lib()
    n = len(pk)
    pk = np.ascontiguousarray(pk, np.int32)
    chunks = np.zeros((max(n, 1), 6), np.int64)
    rows = np.zeros(max(n, 1), np.int32)
    failed = np.zeros(max(n, 1), np.int32)
    counts = np.zeros(4, np.int64)
    nc = lib.wave_plan_align(pk.ctypes.data, n, int(conservative), lanes,
                             cap, chunks.ctypes.data, rows.ctypes.data,
                             failed.ctypes.data, counts.ctypes.data)
    out = [(int(L), int(Wp), int(Hp), int(B),
            rows[r0:r0 + m].tolist())
           for L, Wp, Hp, B, r0, m in chunks[:nc].tolist()]
    return out, failed[:counts[1]].tolist(), int(counts[2]), int(counts[3])


def _python_align(pk, conservative=False, cap=CAP):
    chunks, failed, cells, useful = tde.plan_align_rows(pk, conservative,
                                                        cap)
    out = [(L, Wp, Hp, tde._pad_align(len(idxs)), idxs.tolist())
           for L, Wp, Hp, idxs in chunks]
    return out, failed, cells, useful


ALIGN_CASES = {
    # every corridor mode at the hot sizes
    "modes": dict(rows=lambda: _align_rows(1, 200)),
    # lane classes past 1024 ({2^n, 1.5 * 2^n}) and pow2 classes past 2^14
    "wide": dict(rows=lambda: _align_rows(2, 60, W=(5000, 40000),
                                          H=(5000, 40000),
                                          width=(1100, 7000),
                                          modes=(1, 2, 3))),
    # a cap that splits the largest buckets into several launches
    "cap_split": dict(rows=lambda: _align_rows(3, 120, W=(2100, 4000),
                                               H=(2100, 4000),
                                               width=(20, 100),
                                               modes=(1, 2, 3)),
                      cap=16 << 20),
    # a cap below some rows' solo launch: those rows are refused
    "cap_refusal": dict(rows=lambda: _align_rows(4, 120, W=(300, 9000),
                                                 H=(300, 9000)),
                        cap=1 << 22),
    # the lane-bound retry's plan: width + 3 lanes
    "conservative": dict(rows=lambda: _align_rows(5, 80), conservative=True),
}


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_native_align_plan_matches_python(case):
    c = ALIGN_CASES[case]
    pk = c["rows"]()
    cons, cap = c.get("conservative", False), c.get("cap", CAP)
    want = _python_align(pk, cons, cap)
    got = _native_align(pk, cons, cap=cap)
    assert got == want
    chunks, failed = want[0], want[1]
    assert sorted(sum((r for *_, r in chunks), []) + failed) == \
        list(range(len(pk)))
    if case == "wide":
        assert max(L for L, *_ in chunks) > 1024
    if case == "cap_split":
        keys = [(L, Wp, Hp) for L, Wp, Hp, *_ in chunks]
        assert len(keys) > len(set(keys)) and not failed
    if case == "cap_refusal":
        assert failed and chunks


def test_a_row_past_the_cap_is_counted_refused(monkeypatch):
    """A wave of one row whose solo launch passes a small DIRS_CAP: the
    C++ planner refuses it (csrc/wave.cu counts its planner's refusals in
    align_rows_refused; the card test holds that count against the Python
    wave's), and the Python wave counts it there."""
    pk = _align_rows(9, 1, W=(3000, 3001), H=(3000, 3001))
    cap = 1 << 20
    chunks, failed, cells, useful = _native_align(pk, cap=cap)
    assert (chunks, failed, cells, useful) == ([], [0], 0, 0)
    monkeypatch.setattr(tde, "dirs_cap", lambda: cap)
    ctx = tde.DeviceContext(np.zeros(1 << 16, np.uint8), device="cpu")
    rb = ctx.upload_reads(np.zeros(1 << 16, np.uint8))
    pend = ctx.align_dispatch_pk(pk, (2.0, -5.0, -5.0, -5.0, -1.0, 0.15),
                                 readbuf=rb)
    assert pend[4] == [0]
    assert ctx.stats["align_rows_refused"] == 1
    assert ctx.stats["align_launches"] == ctx.stats["cells_align"] == 0


def test_a_refused_realign_row_counts_as_asked(monkeypatch):
    """cells_sv_useful counts the cells a realign row asks for as it is
    posted (native/engine.cpp's align_banded alike): a realign row past a
    small DIRS_CAP counts there, in sv_align_rows and in
    align_rows_refused, and not in cells_align_useful."""
    from ngmlr_tpu_torch.align.aligner import (RefWin, align_banded,
                                               corridor_endpoints)
    from ngmlr_tpu_torch.io.reads import Read, SeqView
    monkeypatch.setattr(tde, "dirs_cap", lambda: 1 << 20)
    n = 3000
    ctx = tde.DeviceContext(np.zeros(1 << 16, np.uint8), device="cpu")
    ctx.upload_reads(np.zeros(n, np.uint8))
    monkeypatch.setattr(tde, "_current", ctx)
    read = Read(0, b"r", b"A" * n, None)
    read.buf_offset = 0
    ref_win = RefWin(tde.RefDesc(0, 0, n, n), b"A" * n)
    c = corridor_endpoints(n, ref_win.W, n, True)
    assert align_banded(ref_win, SeqView(read, 0, n, False), c, 0, 0,
                        sv=True) is None
    st = ctx.stats
    assert (st["sv_align_rows"], st["cells_sv_useful"]) == (1, n * n)
    assert st["align_rows_refused"] == 1
    assert st["cells_align_useful"] == st["align_launches"] == 0


def test_native_align_plan_forced_lanes(monkeypatch):
    """The lanes every row of a first pass takes when forced (the card
    tests force the lane-bound retry with it) against the Python plan with
    align_lanes forced alike."""
    pk = _align_rows(6, 100)
    orig = tde.align_lanes
    monkeypatch.setattr(tde, "align_lanes", lambda pk, cons: (
        orig(pk, cons) if cons else np.full(len(pk), 128, np.int64)))
    want = _python_align(pk)
    assert {L for L, *_ in want[0]} == {128}
    assert _native_align(pk, lanes=128) == want


def _score_rows(seed, n):
    rng = np.random.default_rng(seed)
    pk = np.zeros((n, 7), np.int32)
    W = rng.choice([40, 306, 500, 513, 700, 2000, 30000, 99998, 99999,
                    150000], n)
    q = rng.choice([0, 1, 50, 256, 300, 1500, 70000, 99998, 99999], n)
    pk[:, 0] = rng.integers(0, 1 << 27, n)
    pk[:, 1] = pk[:, 0] + W
    pk[:, 2] = rng.integers(0, 6, n)
    pk[:, 3], pk[:, 5] = W, q
    pk[:, 4] = rng.integers(0, 1 << 20, n)
    pk[:, 6] = np.arange(n) & 1
    return pk


@pytest.mark.parametrize("seed", [7, 8])
def test_native_score_plan_matches_python(seed):
    """Score buckets (Rp, Qp, padded rows, rows in order) and cells, with
    rows past the ssw guard (W or qlen + 1 >= MAX_SEQ_LEN) left out."""
    pk = _score_rows(seed, 300)
    lib = get_engine_lib()
    n = len(pk)
    buckets = np.zeros((n, 5), np.int64)
    rows = np.zeros(n, np.int32)
    counts = np.zeros(3, np.int64)
    nb = lib.wave_plan_score(pk.ctypes.data, n, buckets.ctypes.data,
                             rows.ctypes.data, counts.ctypes.data)
    got = [(int(Rp), int(Qp), int(B), rows[r0:r0 + m].tolist())
           for Rp, Qp, B, r0, m in buckets[:nb].tolist()]
    live, want, cells, useful = tde.plan_score_rows(pk)
    assert got == [(rp, qp, tde._pad_score(len(idxs)), idxs.tolist())
                   for rp, qp, idxs in want]
    assert (int(counts[1]), int(counts[2])) == (cells, useful)
    assert int(counts[0]) == int(live.sum()) < n


def _test2_records(**kw):
    argv = ["-r", os.path.join(DATA_DIR, "test_2/ref_chr21_20kb.fa"),
            "-q", os.path.join(DATA_DIR, "test_2/reads_100_2200bp.fa")]
    args = build_parser().parse_args(argv)
    p = Pipeline(config_from_args(args, argv), args.reference,
                 use_cache=True, **kw)
    buf = io.BytesIO()
    p.run(args.query, buf)
    return p, [l for l in buf.getvalue().split(b"\n")
               if not l.startswith(b"@PG")]


@pytest.mark.parametrize("path", ["cpu", "mesh", "plain_kernels"])
def test_python_wave_paths_keep_the_golden(path, monkeypatch):
    """The CPU, a two-device mesh and --nosse's plain kernels take the
    Python wave: every engine wave through DeviceContext, none native, and
    test_2's golden bytes."""
    if path == "plain_kernels":
        monkeypatch.setenv("NGMLR_TPU_NO_PALLAS", "1")
    device = ["cpu", "cpu"] if path == "mesh" else "cpu"
    p, out = _test2_records(device=device)
    assert p.native is not None
    assert not native_engine.native_wave_wanted(p.ctx)
    assert (p.ctx.mesh is not None) == (path == "mesh")
    assert p.ctx.plain_kernels == (path == "plain_kernels")
    st = p.ctx.stats
    assert st["engine_waves"] > 0 and st["native_waves"] == 0
    assert st["align_launches"] > 0 and st["native_failed"] == 0
    with open(os.path.join(GOLDEN_DIR, "test_2.sam"), "rb") as f:
        want = [l for l in f.read().split(b"\n") if not l.startswith(b"@PG")]
    assert out == want
