#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ngmlr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out DIR] [--profile DIR]

Phases, each printed with its wall time:
  1. card and build: the card's name and power limit, nvcc build of the four
     kernels from csrc/ (one nvcc per source, started together);
  2. each kernel against its plain PyTorch version on the card, bit for bit,
     at the shapes of the main path and the wide lane classes, with the
     kernel's, the plain version's and (where one exists) a library call's
     times, and the bound worked out from this run's inputs;
  3. the goldens: the nine checks of scripts/check_goldens.sh (test_2
     pacbio and ont, test_4 and the other six) mapped through the port's
     Pipeline on the card, identical to tests/golden (@PG excluded);
  4. a mapping run at a real size: a seeded synthetic genome (50 Mbp, about
     one human chromosome) and 256 PacBio-like 9 kb reads at ~15% error,
     through the native assembly engine (traced by torch.profiler with
     --profile, which gives the device time by kernel and the busy share).
Then one JSON line listing every kernel, the card's line from nvidia-smi,
and the final line {"ok": true, "device": {...}}.

Every mapping run (each golden, and phase 4) sets the launch counters to 0
just before it drives the pipeline and reads them just after; each run's
counts must equal the waves its device engine recorded (one score_fill per
score wave, one launch of each convex kernel per align wave), and phase 4,
the main path, must launch every kernel. The kernels line carries phase 4's
counts; the comparisons of phase 2 count nowhere. Any failed phase exits
non-zero without the final line. Needs one CUDA card, nvcc and the
repository checkout (it imports ngmlr_tpu_torch from beside this file).
"""

import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
GOLDEN = os.path.join(HERE, "tests", "golden")

# H100 SXM peaks from NVIDIA's data sheet: HBM3 at 3.35 TB/s, and 67 TFLOP/s
# in f32 outside the tensor cores, which counts a fused multiply-add as two
# operations. The kernels are built with -fmad=false, so each f32 add or
# multiply is one instruction of the FMA pipe: 33.5e12 a second (132 SMs x
# 128 lanes x 1.98 GHz). Integer operations, compares, min/max, selects and
# conversions run on the ALU pipe, which has 64 lanes per SM, half that rate.
# All instructions share the 128-lane issue, so the operation floor is the
# larger of (fma + alu) / ISSUE_OPS_S and alu / ALU_OPS_S.
PEAK_BYTES_S = 3.35e12
ISSUE_OPS_S = 67e12 / 2
ALU_OPS_S = ISSUE_OPS_S / 2

# operations per unit of work, counted from the kernel bodies as
# (fma-pipe, alu-pipe), the recurrence's own arithmetic (the address
# arithmetic of the gathers and loop control are left out, as work a
# better kernel could amortise):
# score_fill, per cell: compares q == r, r < 4, two selects for s, the add,
#   the floor at 0 and the running best
OPS_SCORE_CELL = (0, 7)
# corridor_windows, per problem and wavefront: two key compares and two
# pointer adds, the window height and its running max; per row, the two
# keys (conversion, subtract, divide ~10 FMA-pipe instructions as
# __fdiv_rn expands, convert back; clamps, max, add: 8 ALU each)
OPS_WINDOW_STEP = (0, 6)
OPS_WINDOW_ROW = (20, 16)
# convex_fill, per live cell: the lane's live test (1); diag = s2 +
# (mat | mis) (1 add; compare + select); per gap side: run * gdecay + ge
# (2), + s and + go (2); ext and zero tests, the min with gemin, two
# selects, the run's conversion (5);
# unpacking both neighbours' run and direction (4); the max of three with
# the floor (3); the tie tests (3); the direction and run chain (11); the
# STOP zeroing (2); the best-cell order (11); packing run and direction (2)
OPS_FILL_CELL = (9, 49)
# convex_backtrack, per walk step: the lane and its bounds (3), the STOP
# test (1), the validPath band (convert, 2 adds + 1 subtract, 2 converts
# back; 2 compares), the op's pack (2), the two moves (6), the edge test
# (2) and the step's wavefront test (2)
OPS_WALK_STEP = (3, 21)

# phase 4: one chromosome (about human chr21/22) and PacBio-like reads
GENOME_MBP = 50.0
N_READS = 256
READ_LEN = 9000


class PhaseError(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def bound_ms(nbytes, ops):
    """(least ms, "bytes" or "operations") for nbytes of traffic and ops =
    (fma-pipe, alu-pipe) operation counts."""
    fma, alu = ops
    b = nbytes / PEAK_BYTES_S * 1e3
    o = max((fma + alu) / ISSUE_OPS_S, alu / ALU_OPS_S) * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def ops_of(per_unit, n):
    return tuple(k * n for k in per_unit)


def cuda_ms(fn, reps=1, warmup=1):
    """Mean device time of fn() over reps launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed_once(fn):
    """(result, device ms) of one call, by CUDA events."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    r = fn()
    b.record()
    torch.cuda.synchronize()
    return r, a.elapsed_time(b)


def max_abs_err(pairs):
    """Largest |a - b| over (kernel, plain) tensor pairs (f32 compared as
    values; integer tensors exactly)."""
    import torch
    m = 0.0
    for a, b in pairs:
        check(a.shape == b.shape, "shape mismatch %s vs %s"
              % (tuple(a.shape), tuple(b.shape)))
        if a.numel():
            m = max(m, float((a.double() - b.double()).abs().max()))
        if a.dtype == torch.float32:   # bit-exact, signed zeros included
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  "f32 bits differ")
    return m


# ---------------------------------------------------------------------------
# phase 2 inputs (numpy seeds)
# ---------------------------------------------------------------------------

def score_rows(rng, G, R, P):
    """P score rows at the hot 306 x 256 subread shape (bucket 320 x 256)."""
    pk = np.zeros((P, 7), np.int32)
    pku = pk.view(np.uint32)
    ds = rng.integers(0, G - 400, P)
    pku[:, 0], pku[:, 1] = ds, ds + 306
    pk[:, 2] = rng.integers(0, 8, P)          # some leading 'x' codes
    pk[:, 3] = 306
    pk[:, 4] = rng.integers(0, R - 300, P)
    pk[:, 5] = 256
    pk[:, 6] = np.arange(P) & 1
    return pk


def cw_rows(rng, B):
    """Corridor-window rows over all four modes, with width <= 0 and H = 0
    rows (the cases of tests/test_corridor_windows.py, widened)."""
    pk = np.zeros((B, 12), np.int32)
    pkf = pk.view(np.float32)
    pk[:, 7] = rng.integers(0, 4, B)
    pk[:, 3] = rng.integers(1, 16000, B)
    pk[:, 5] = rng.integers(0, 16000, B)
    pk[:, 9] = rng.integers(1, 3000, B)
    pk[B // 2:B // 2 + 8, 9] = 0
    pk[B // 2 + 8:B // 2 + 16, 9] = -rng.integers(1, 50, 8)
    pk[:4, 5] = 0
    pk[:, 8] = rng.integers(-50, 200, B)
    pkf[:, 10] = rng.uniform(0.05, 3.0, B).astype(np.float32)
    pkf[:, 11] = rng.uniform(-100.0, 100.0, B).astype(np.float32)
    return pk


def align_rows(rng, genome, readbuf, B, Wr, Hr, widths, modes,
               plant=False):
    """Align rows with the geometry of scripts/check_kernels.py:46-72. With
    plant, each query is a PacBio-like mutated copy of its reference window
    written into readbuf (in place), so the backtrack walks a whole path."""
    G, R = len(genome), len(readbuf)
    pk = np.zeros((B, 12), np.int32)
    pku = pk.view(np.uint32)
    pkf = pk.view(np.float32)
    qs_next = 0
    for b in range(B):
        W = int(rng.integers(*Wr))
        H = int(rng.integers(*Hr))
        ds = int(rng.integers(0, G - W - 1))
        qs = int(rng.integers(0, R - H - 1))
        if plant:
            read = np.frombuffer(mutate_codes(rng, genome[ds:ds + W]),
                                 dtype=np.uint8)
            H, qs = len(read), qs_next
            # a rev row's query is the reverse complement of its slice
            readbuf[qs:qs + H] = (np.where(read < 4, read ^ 1, read)[::-1]
                                  if b & 1 else read)
            qs_next += H
        mode = int(modes[b % len(modes)])
        width = int(rng.integers(*widths))
        if mode == 0:
            w = W + 1
            ci = int(np.float32(w) * np.float32(-0.2))
            width = w + int(np.float32(w) * np.float32(0.2))
            cf = (1.0, 0.0)
        elif mode == 1:
            ci = width // 2
            cf = (1.0, 0.0)
        else:
            ci = 0
            cf = (float(np.float32(H) / np.float32(W)),
                  float(np.float32(width) / np.float32(2.0)))
        pku[b, 0], pku[b, 1] = ds, ds + W
        pk[b, 2:10] = (0, W, qs, H, b & 1, mode, ci, width)
        pkf[b, 10:12] = cf
    return pk


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card_and_build():
    from ngmlr_tpu_torch.ops import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    log("card: %s" % card)
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.get_lib()
    log("kernels built in %.2f s (nvcc %.2f s)"
        % (time.perf_counter() - t0, build.build_seconds))
    return card


def phase_kernels(rng, dev="cuda"):
    """Every kernel against its plain version on the card. Returns the
    per-kernel records of the kernels line (launches filled in later)."""
    import torch
    from ngmlr_tpu_torch.ops import kernels as K
    from ngmlr_tpu_torch.ops.device_engine import _convex_kernel
    dev = torch.device(dev)
    G, R = 4_000_000, 1 << 20
    genome_np = rng.integers(0, 5, G).astype(np.uint8)
    readbuf_np = rng.integers(0, 5, R).astype(np.uint8)
    # the main-path shape aligns real (mutated) copies of its windows
    main_pk = align_rows(rng, genome_np, readbuf_np, 32, (9000, 10000),
                         (0, 1), (200, 400), (2, 3), plant=True)
    genome = torch.from_numpy(genome_np).to(dev)
    readbuf = torch.from_numpy(readbuf_np).to(dev)
    params = torch.tensor([2.0, -5.0, -5.0, -5.0, -1.0, 0.15],
                          dtype=torch.float32, device=dev)
    rec = {}
    log("tolerance: 0 (every output equal to its plain version; f32 compared "
        "as bit patterns)")

    # score_fill: P = 4096 at the hot 320 x 256 bucket
    P, Rp, Qp = 4096, 320, 256
    spk = torch.from_numpy(score_rows(rng, G, R, P)).to(dev)
    got = K.score_fill(genome, readbuf, spk, Rp, Qp)
    want, plain_ms = timed_once(
        lambda: K.score_fill_plain(genome, readbuf, spk, Rp, Qp))
    err = max_abs_err([(got, want)])
    ms = cuda_ms(lambda: K.score_fill(genome, readbuf, spk, Rp, Qp), reps=20)
    cells = P * 306 * 256
    b, by_ = bound_ms(P * (7 * 4 + 4 + 306 + 256),
                      ops_of(OPS_SCORE_CELL, cells))
    rec["score_fill"] = dict(
        name="score_fill", route="cuda", source="ngmlr_tpu_torch/csrc/score_fill.cu",
        replaces="ngmlr_tpu/ops/pallas_kernels.py:691", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by_, library_ms=None)
    log("score_fill P=%d %dx%d: max_abs_err=%g kernel_ms=%.4f plain_ms=%.2f "
        "bound_ms=%.4f" % (P, Rp, Qp, err, ms, plain_ms, b))

    # corridor_windows: B = 128, all four modes, TpP = 32768
    B, TpP = 128, 32768
    cpk = torch.from_numpy(cw_rows(rng, B)).to(dev)
    got = K.corridor_windows(cpk, TpP)
    want, plain_ms = timed_once(lambda: K.corridor_windows_plain(cpk, TpP))
    err = max_abs_err(zip(got, want))
    ms = cuda_ms(lambda: K.corridor_windows(cpk, TpP), reps=20)
    lib_ms = _searchsorted_ms(K, cpk, TpP, want[0], want[1])
    n_rows = int(cpk[:, 5].clamp(min=0).sum())
    step_ops, row_ops = (ops_of(OPS_WINDOW_STEP, B * TpP),
                         ops_of(OPS_WINDOW_ROW, n_rows))
    b, by_ = bound_ms(B * 12 * 4 + 2 * B * TpP * 4 + B * 4,
                      (step_ops[0] + row_ops[0], step_ops[1] + row_ops[1]))
    rec["corridor_windows"] = dict(
        name="corridor_windows", route="cuda",
        source="ngmlr_tpu_torch/csrc/corridor_windows.cu",
        replaces="ngmlr_tpu/ops/pallas_kernels.py:566", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by_, library_ms=lib_ms)
    log("corridor_windows B=%d TpP=%d: max_abs_err=%g kernel_ms=%.4f "
        "plain_ms=%.2f library_ms=%.4f bound_ms=%.4f"
        % (B, TpP, err, ms, plain_ms, lib_ms, b))

    # convex fill + backtrack: small all-modes shape, the main-path shape
    # (timed), the wide lane classes
    shapes = [
        ("all-modes", 1024, 1024, 128, align_rows(
            rng, genome_np, readbuf_np, 32, (200, 1000), (100, 1000),
            (24, 120), (0, 1, 2, 3))),
        ("main-path", 16384, 16384, 256, main_pk),
        ("wide-1536", 4096, 3072, 1536, align_rows(
            rng, genome_np, readbuf_np, 8, (2000, 4000), (1000, 3000),
            (1536 - 200, 1536 - 3), (2,))),
        ("wide-2560", 4096, 3072, 2560, align_rows(
            rng, genome_np, readbuf_np, 8, (2000, 4000), (1000, 3000),
            (2560 - 200, 2560 - 3), (2,))),
    ]
    fill_err = bt_err = 0.0
    for tag, Wp, Hp, L, apk_np in shapes:
        apk = torch.from_numpy(apk_np).to(dev)
        B = apk.shape[0]
        TpP = Wp + Hp
        ymin, ymax, hmax = K.corridor_windows(apk, TpP)
        cw_err = max_abs_err(zip((ymin, ymax, hmax),
                                 K.corridor_windows_plain(apk, TpP)))
        got = K.convex_fill(genome, readbuf, apk, params, ymin, ymax, L)
        want, fill_plain_ms = timed_once(lambda: K.convex_fill_plain(
            genome, readbuf, apk, params, ymin, ymax, L))
        # dirs rows past a problem's last non-empty wavefront are unwritten
        # by the kernel and never read
        H = apk[:, 5:6].long()
        live_t = (ymin < H)[:, :, None].expand(-1, -1, L)
        e = max_abs_err([(got[1], want[1]), (got[2], want[2]),
                         (got[3], want[3]),
                         (got[0][live_t], want[0][live_t])])
        fill_err = max(fill_err, e)
        dirs, best, by, bx = got
        bt = K.convex_backtrack(dirs, ymin, apk, bx, by)
        bt_want, bt_plain_ms = timed_once(
            lambda: K.convex_backtrack_plain(dirs, ymin, apk, bx, by))
        e2 = max_abs_err(zip(bt, bt_want))
        bt_err = max(bt_err, e2)
        # the whole fused chain (the contract the engine consumes: [B, 7]
        # scalars and the flat packed ops) against the plain results
        pk_flat, scal = _convex_kernel(genome, readbuf, apk, params,
                                       Wp=Wp, Hp=Hp, L=L)
        scal_want = torch.stack([
            want[1].view(torch.int32), want[3], want[2], bt_want[1],
            bt_want[2], (bt_want[3] == K.DONE).to(torch.int32), hmax], dim=1)
        e3 = max_abs_err([(scal, scal_want),
                          (pk_flat, bt_want[0].reshape(-1))])
        check(cw_err == 0 and e3 == 0,
              "convex %s: windows or fused chain differ" % tag)
        ok = int(bt[3].eq(K.DONE).sum())
        log("convex %s B=%d Wp=%d Hp=%d L=%d: windows, fill, backtrack and "
            "fused max_abs_err = %g, %g, %g, %g; ok=%d/%d, max hmax %d"
            % (tag, B, Wp, Hp, L, cw_err, e, e2, e3, ok, B,
               int(hmax.max())))
        if tag == "main-path":
            fill_ms = cuda_ms(lambda: K.convex_fill(
                genome, readbuf, apk, params, ymin, ymax, L), reps=3)
            bt_ms = cuda_ms(lambda: K.convex_backtrack(dirs, ymin, apk, bx, by),
                            reps=3)
            n_t = (ymin < H).sum(dim=1)
            hgt = (ymax - ymin + 1).clamp(0, L)
            live = int(torch.where(ymin < H, hgt, 0).sum())
            Wsum = int((apk[:, 3] & ((1 << 28) - 1)).sum())
            Hsum = int(apk[:, 5].sum())
            fb, fby = bound_ms(
                B * (12 * 4 + 12) + 24 + int(n_t.sum()) * (8 + L)
                + Wsum + Hsum, ops_of(OPS_FILL_CELL, live))
            ops4 = bt[0]
            steps = sum(int(((ops4 >> s) & 3).ne(0).sum()) for s in (0, 2, 4, 6))
            bb, bby = bound_ms(B * (12 * 4 + 8 + 12) + B * TpP // 4
                               + steps * 5, ops_of(OPS_WALK_STEP, steps))
            log("convex main-path: fill kernel_ms=%.3f plain_ms=%.1f "
                "bound_ms=%.4f (%s); backtrack kernel_ms=%.3f plain_ms=%.1f "
                "bound_ms=%.5f (%s); live cells %d, walk steps %d"
                % (fill_ms, fill_plain_ms, fb, fby, bt_ms, bt_plain_ms, bb,
                   bby, live, steps))
            rec["convex_fill"] = dict(
                name="convex_fill", route="cuda",
                source="ngmlr_tpu_torch/csrc/convex_fill.cu",
                replaces="ngmlr_tpu/ops/pallas_kernels.py:254",
                ms=fill_ms, plain_ms=fill_plain_ms, bound_ms=fb, bound_by=fby,
                library_ms=None)
            rec["convex_backtrack"] = dict(
                name="convex_backtrack", route="cuda",
                source="ngmlr_tpu_torch/csrc/convex_backtrack.cu",
                replaces="ngmlr_tpu/ops/pallas_kernels.py:447",
                ms=bt_ms, plain_ms=bt_plain_ms, bound_ms=bb, bound_by=bby,
                library_ms=None)
        del got, want, bt, bt_want, dirs
        torch.cuda.empty_cache()
    rec["convex_fill"]["max_abs_err"] = fill_err
    rec["convex_backtrack"]["max_abs_err"] = bt_err
    return rec


def _searchsorted_ms(K, cpk, TpP, ymin, ymax):
    """The library yardstick for corridor_windows: torch.searchsorted over
    the (strictly increasing) row keys computes the same windows. Checked
    for equality, timed, and used nowhere in the port."""
    import torch
    c = K._align_cols(cpk)
    Hn = max(int(c["H"].max()), 1)
    y = torch.arange(Hn, dtype=torch.int32, device=cpk.device)[None, :]
    offs = K.corridor_offs(c["mode"], c["ci"], c["k"], c["d"], y)
    W = c["W"].to(torch.int32)[:, None]
    lo = torch.clamp(offs, torch.zeros_like(W), W)
    hi = torch.maximum(torch.clamp(offs + c["width"][:, None],
                                   torch.zeros_like(W), W), lo)
    ok = y < c["H"][:, None]
    key_lo = torch.where(ok, y + lo, K.BIG).contiguous()
    key_hi = torch.where(ok, y + hi, K.BIG).contiguous()
    grid = torch.arange(TpP, dtype=torch.int32, device=cpk.device)[None, :] \
        .expand(cpk.shape[0], -1).contiguous()

    def lib():
        return (torch.searchsorted(key_hi, grid, right=True),
                torch.searchsorted(key_lo, grid, right=True) - 1)

    a, b = lib()
    check(torch.equal(a.to(torch.int32), ymin)
          and torch.equal(b.to(torch.int32), ymax),
          "searchsorted yardstick disagrees with the windows")
    return cuda_ms(lib, reps=20)


def _records(sam):
    return [l for l in sam.split(b"\n") if not l.startswith(b"@PG")]


def _map(argv, device="cuda", use_cache=True):
    """Map through the port's Pipeline. Returns (pipeline, SAM bytes, setup
    s, map s, the kernel launches of this run alone)."""
    import torch
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.ops import kernels as K
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args, argv)
    t0 = time.perf_counter()
    p = Pipeline(cfg, args.reference, use_cache=use_cache, device=device)
    t1 = time.perf_counter()
    buf = io.BytesIO()
    K.reset_launches()
    p.run(args.query, buf)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    return p, buf.getvalue(), t1 - t0, time.perf_counter() - t1, launches


def check_launches(tag, launches, stats):
    """A run's launches must be the waves its engine recorded: one
    score_fill per score wave, one of each convex kernel per align wave."""
    want = {"score_fill": stats["score_waves"]}
    for k in ("corridor_windows", "convex_fill", "convex_backtrack"):
        want[k] = stats["align_waves"]
    check(launches == want, "%s: launches %s, but the engine recorded %s"
          % (tag, launches, want))


def _per_read(sam, mask_qual):
    """qname -> its SAM records as field lists (QUAL masked on request)."""
    d = {}
    for line in sam.decode().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        if mask_qual:
            f[10] = "QUAL"
        d.setdefault(f[0], []).append(f)
    return d


def _golden_runs():
    """(tag, argv, golden file, compare mode) of the nine golden checks of
    scripts/check_goldens.sh. Mode "bytes" compares whole files (@PG
    excluded); "reads"/"reads-qual" compare per read the reads the
    reference binary survived (QUAL masked for test_3)."""
    def d(p):
        return os.path.join(DATA, p)
    t2 = ["-r", d("test_2/ref_chr21_20kb.fa"),
          "-q", d("test_2/reads_100_2200bp.fa")]
    return [
        ("test_2 pacbio", t2 + ["-x", "pacbio"], "test_2.sam", "bytes"),
        ("test_2 ont", t2 + ["-x", "ont"], "test_2_ont.sam", "bytes"),
        ("test_4", ["-r", d("test_4/reference.fasta.gz"),
                    "-q", d("test_4/read.fa.gz"), "-x", "pacbio"],
         "test_4.sam", "bytes"),
        ("test_1", ["-r", d("test_1/ref_chr6_140kb.fa"),
                    "-q", d("test_1/long_name.fa")], "test_1.sam", "bytes"),
        ("test_5", ["-r", d("test_5/reference.fasta.gz"),
                    "-q", d("test_5/read.fa.gz"), "-x", "pacbio"],
         "test_5.sam", "bytes"),
        ("test_6", ["-r", d("test_6/reference.fasta.gz"),
                    "-q", d("test_6/read.fa.gz"), "-x", "pacbio"],
         "test_6.sam", "bytes"),
        ("test_3", ["-r", d("test_3/reference.fasta.gz"),
                    "-q", d("test_3/read.fa.gz")],
         "test_3_perread.sam", "reads-qual"),
        ("test_7 ont sv", ["-r", d("test_7/ref.fa"), "-q", d("test_7/reads.fa"),
                           "-x", "ont"], "test_7_ont_sv.sam", "reads"),
        ("test_8 ultralong", ["-r", d("test_8/ref.fa"),
                              "-q", d("test_8/reads.fa")],
         "test_8_ultralong.sam", "reads")]


def phase_goldens():
    """Returns {tag: {"map_s", "launches"}} of the nine golden runs."""
    runs = {}
    for tag, argv, golden, mode in _golden_runs():
        p, out, t_setup, t_run, launches = _map(argv)
        with open(os.path.join(GOLDEN, golden), "rb") as f:
            want = f.read()
        if mode == "bytes":
            same = _records(out) == _records(want)
            verdict = "BYTE-IDENTICAL" if same else "DIFFERS"
        else:
            g = _per_read(want, mode == "reads-qual")
            ours = _per_read(out, mode == "reads-qual")
            bad = [q for q, recs in g.items() if ours.get(q) != recs]
            same = not bad
            verdict = "%d/%d reads identical%s" % (
                len(g) - len(bad), len(g),
                "" if same else ", first diffs %s" % bad[:3])
        runs[tag] = {"map_s": t_run, "launches": launches}
        log("golden %s: %s (%d reads, setup %.2f s, map %.2f s, engine "
            "waves %d, launches %s)"
            % (tag, verdict, p.stats["reads"], t_setup, t_run,
               p.ctx.stats.get("engine_waves", 0), json.dumps(launches)))
        check(same, "%s differs from tests/golden/%s" % (tag, golden))
        check_launches("golden " + tag, launches, p.ctx.stats)
    for k in ("score_fill", "corridor_windows", "convex_fill",
              "convex_backtrack"):
        check(sum(r["launches"][k] for r in runs.values()) > 0,
              "no golden run launched %s" % k)
    return runs


def make_genome(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n)


def mutate_codes(rng, codes):
    """mutate_pacbio over base codes (A=0,T=1,G=2,C=3)."""
    back = np.frombuffer(b"ATGCN", dtype=np.uint8)[codes]
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ATGC", dtype=np.uint8)] = np.arange(4)
    return lut[np.frombuffer(mutate_pacbio(rng, back), dtype=np.uint8)].tobytes()


def mutate_pacbio(rng, seq):
    """~15% error: 10% insertions, 4% deletions, 1% substitutions (per input
    base: a deletion emits nothing, an insertion emits one random base
    before the original, a substitution replaces it)."""
    n = len(seq)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    r = rng.random(n)
    ins = r < 0.10
    dele = (r >= 0.10) & (r < 0.14)
    sub = (r >= 0.14) & (r < 0.15)
    rand_ins = rng.choice(bases, size=n)
    rand_sub = rng.choice(bases, size=n)
    counts = np.where(dele, 0, 1 + ins.astype(np.int64))
    ends = np.cumsum(counts)
    out = np.empty(int(ends[-1]) if n else 0, dtype=np.uint8)
    keep = ~dele
    out[ends[keep] - 1] = np.where(sub, rand_sub, seq)[keep]
    ins_k = ins & keep
    out[ends[ins_k] - 2] = rand_ins[ins_k]
    return out.tobytes()


def write_fasta(path, records):
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name + b"\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80] + b"\n")


def _profiled(fn, out_dir):
    """Run fn() under torch.profiler (CPU + CUDA activities). Returns
    (fn's result, {device_ms_total, per-name device ms and counts}); writes
    the key_averages table and a Chrome trace into out_dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = fn()
    os.makedirs(out_dir, exist_ok=True)
    ka = prof.key_averages()

    def dev_us(e):
        # device-side events only (kernels and copies): a host op such as
        # aten::copy_ repeats its kernels' time, and "Activity Buffer
        # Request" is the profiler's own bookkeeping
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("Activity Buffer")):
            return 0.0
        return e.self_device_time_total
    rows = sorted(((e.key, dev_us(e) / 1e3, e.count) for e in ka
                   if dev_us(e) > 0), key=lambda x: -x[1])
    with open(os.path.join(out_dir, "mapping_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    prof.export_chrome_trace(os.path.join(out_dir, "mapping_trace.json"))
    top = [{"name": n[:80], "device_ms": ms, "count": c}
           for n, ms, c in rows[:12]]
    log("profile: device time by name: " + json.dumps(top))
    return r, {"device_ms_total": sum(ms for _, ms, _ in rows), "top": top}


def phase_mapping(genome_mbp, n_reads, read_len, workdir, profile_dir=None):
    import torch
    rng = np.random.default_rng(1234)
    glen = int(genome_mbp * 1e6)
    t0 = time.perf_counter()
    genome = make_genome(rng, glen)
    os.makedirs(workdir, exist_ok=True)
    ref_p = os.path.join(workdir, "ref.fa")
    reads_p = os.path.join(workdir, "reads.fa")
    write_fasta(ref_p, [(b"synth_chr1", genome.tobytes())])
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads, origin = [], {}
    for i in range(n_reads):
        pos = int(rng.integers(0, glen - read_len))
        read = mutate_pacbio(rng, genome[pos:pos + read_len])
        if rng.random() < 0.5:
            read = read.translate(comp)[::-1]
        name = b"read_%d_%d" % (i, pos)
        origin[name] = pos
        reads.append((name, read))
    write_fasta(reads_p, reads)
    del genome
    log("generated %.0f Mbp genome + %d x %d bp reads in %.2f s"
        % (genome_mbp, n_reads, read_len, time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()

    def run():
        return _map(["-r", ref_p, "-q", reads_p], use_cache=False)
    if profile_dir:
        (p, out, t_setup, t_run, launches), prof = _profiled(run, profile_dir)
    else:
        p, out, t_setup, t_run, launches = run()
        prof = None
    st, ds = p.stats, p.ctx.stats
    mapped = st["mapped"] / max(1, st["reads"])
    near = n_prim = 0
    for line in out.split(b"\n"):
        if not line or line.startswith(b"@"):
            continue
        f = line.split(b"\t")
        flag = int(f[1])
        if flag & 0x904:
            continue
        n_prim += 1
        near += abs(int(f[3]) - 1 - origin[f[0]]) <= 2000
    summary = dict(
        genome_mbp=genome_mbp, reads=st["reads"], mapped=st["mapped"],
        setup_s=t_setup, map_s=t_run, reads_per_s=st["reads"] / t_run,
        primary_near_origin=near / max(1, n_prim),
        engine_waves=ds.get("engine_waves", 0),
        score_waves=ds["score_waves"], align_waves=ds["align_waves"],
        score_s=ds["score_s"], align_s=ds["align_s"],
        align_fetch_s=ds.get("align_fetch_s", 0.0),
        prep_search_s=ds.get("prep_search_s", 0.0),
        prep_score_stage_s=ds.get("prep_score_stage_s", 0.0),
        waves_wall_s=ds.get("waves_wall_s", 0.0),
        cells_align=ds["cells_align"], cells_align_useful=ds["cells_align_useful"],
        cells_score=ds["cells_score"], cells_score_useful=ds["cells_score_useful"],
        align_gcups_padded=ds["cells_align"] / t_run / 1e9,
        align_gcups_useful=ds["cells_align_useful"] / t_run / 1e9,
        lane_bound_retries=ds.get("lane_bound_retries", 0),
        native_failed=ds.get("native_failed", 0),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches)
    if prof is not None:
        # device busy share of the map: summed device time of every
        # kernel and copy (the genome upload of the setup included) over
        # the map's wall time
        summary["profile"] = prof
        summary["device_busy_share"] = prof["device_ms_total"] / (t_run * 1e3)
    log("mapping: " + json.dumps(summary))
    check(summary["engine_waves"] > 0, "the native engine ran no wave")
    check_launches("mapping", launches, ds)
    for name, n in launches.items():
        check(n > 0, "kernel %s was not launched on the main path" % name)
    check(summary["native_failed"] == 0, "native engine reads failed")
    check(mapped >= 0.95, "only %.3f of the reads mapped" % mapped)
    check(summary["primary_near_origin"] >= 0.9,
          "only %.3f of the primary records lie near their source"
          % summary["primary_near_origin"])
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for a JSON record of every number")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace phase 4 with torch.profiler into DIR")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "ngmlr_tpu_torch")):
        log("FAIL: ngmlr_tpu_torch/ not found beside chip_smoke.py; run it "
            "from a checkout of the repository")
        return 2
    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this script needs a "
            "CUDA card")
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False

    record = {}
    t_all = time.perf_counter()
    try:
        t0 = time.perf_counter()
        card = phase_card_and_build()
        record["card"] = card
        log("phase 1 (card and build): %.2f s" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        kern = phase_kernels(np.random.default_rng(7))
        log("phase 2 (kernels vs plain): %.2f s" % (time.perf_counter() - t0))
        for r in kern.values():
            check(r["max_abs_err"] == 0.0,
                  "%s differs from its plain version" % r["name"])
        t0 = time.perf_counter()
        record["goldens"] = phase_goldens()
        log("phase 3 (goldens): %.2f s" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["mapping"] = phase_mapping(
            GENOME_MBP, N_READS, READ_LEN,
            os.path.join(HERE, "ngmlr_tpu_torch", "_build", "smoke"),
            args.profile)
        log("phase 4 (mapping): %.2f s" % (time.perf_counter() - t0))
        launches = record["mapping"]["launches"]
    except PhaseError as e:
        log("FAIL: %s" % e)
        _dump(args.out, record)
        return 1
    line = {"kernels": []}
    for name in ("score_fill", "corridor_windows", "convex_fill",
                 "convex_backtrack"):
        r = dict(kern[name])
        r["launches"] = launches[name]
        line["kernels"].append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    record["kernels"] = line["kernels"]
    record["total_s"] = time.perf_counter() - t_all
    _dump(args.out, record)
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _dump(out, record):
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
