#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ngmlr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out DIR] [--profile DIR]

Phases, each printed with its wall time:
  1. card and build: the card's name and power limit, nvcc build of the five
     kernels from csrc/ (one nvcc per source, started together);
  2. each kernel against its plain PyTorch version on the card, bit for bit,
     at the shapes of the main path and the wide lane classes (and the edge
     cases of the tiled corridor_windows, convex_fill and convex_backtrack),
     with the kernel's, the plain version's and (where one exists) a
     library call's times, and the bound worked out from this run's inputs;
     then the four alignment kernels on rows spread over the planes of a
     genome of several units (windows at, past and before each plane's end;
     the fill's tiled and wide lane classes), and on rows past 2^31 of a
     flat genome of 2^31 + 2^26 bytes (windows ending at and running past
     its last byte), and on rows over three planes of the real 2^31 slab
     (a [3, 3,221,225,472] u8 tensor on the card, plane 2 past 2^32 of it;
     windows across each slab's end and at and past each plane's end, at
     the main-path shapes, timed, and the wide lane class), bit for bit;
     expand_votes also on slot tables whose position bases have bit 31
     set;
  3. the goldens: the nine checks of scripts/check_goldens.sh (test_2
     pacbio and ont, test_4 and the other six) mapped through the port's
     Pipeline on the card with the default gate (the device candidate
     search), identical to tests/golden (@PG excluded), and test_2 pacbio
     and test_4 again with the host search (NGMLR_TPU_DEVICE_SEARCH=0);
  4. the main path at one chromosome: a seeded synthetic genome (50 Mbp,
     about human chr21/22) and 256 PacBio-like 9 kb reads at ~15% error,
     with the default gate (the device search) through the native assembly
     engine; then the same Pipeline maps the reads again with the host
     search, and the two SAMs must be equal byte for byte, and each equal
     to the JAX package's (the per-read and whole-file digests of
     tests/golden/torch_scale, dataset phase4; hold_to_jax);
  5. chromosome-1 scale: a seeded synthetic 250 Mbp genome (about human
     chr1) carrying a young-LINE-1-like repeat family, 256 such reads from
     outside its copies, and 2 reads from inside copies (one at ONT-like
     2% error, one PacBio-like), whose subreads there run the search's v1
     path and v2's reruns on the card; each read file maps with
     the device search and again with the host search on the same
     Pipeline, byte-identical, each SAM equal to the JAX package's
     (datasets phase5 and phase5_repeats), and each file's first batch of
     candidates equals the host search_batch subread by subread;
  6. scale-out and the debug surface: the nine --stdout dumps of
     tests/golden/dumps through the port's CLI, byte for byte; test_2 in
     serial mode (NGMLR_TPU_SYNC=1) equal to the pipelined run at 4-read
     batches; test_6 --shard 0/2 and 1/2 merged by scripts/merge_sams.py
     equal to the full run; two CLI processes under one coordinator
     (torch.distributed, gloo), merged, equal to the single run of test_2;
     then phase 4's files through a mesh of two shards sharing cuda:0 (the
     CLI's -t 2 over two cards), its SAM equal to phase 4's byte for byte,
     and again over every visible card where there is more than one;
  7. genomes of several units (the TableUnit analog, slabs shrunk by
     NGMLR_TPU_UNIT_SLAB_BITS), through the host search and the Python
     assembly path: (a) the case of tests/test_table_units.py:69 (two
     5 Mbp chromosomes, 14 reads) in 3 units, its SAM equal to its flat
     run's; (b) phase 4's 50 Mbp genome in 6 units and its 256 reads, the
     SAM equal to phase 4's; both under NGMLR_TPU_STRICT=1, launching no
     expand_votes;
  8. --nosse and the oracle modules: (a) test_2 pacbio through the CLI on
     the card with --nosse (the plain versions of the four alignment
     kernels, on the card's tensors), its SAM equal to the golden and to
     the kernels' run of the same command, and phase 4's genome with its
     first NOSSE_READS reads mapped both ways, the SAMs equal (the plain
     convex_fill is a Python loop of tensor steps a wavefront, hence the
     cut), the --nosse runs launching none of the four and as many
     expand_votes as the kernels' runs; (b) --stdout 6 --nosse on test_2,
     the card's dump equal to the CPU's (each in a fresh process: the dump
     numbers alignments from 0 in a process); (c) ops/convex.py's
     run_batch on the card against ops/convex_ref.py's fill_matrix and
     against run_batch on the CPU on the 12 problems of
     tests/test_convex.py:52, align_banded through a context on the card
     (the four kernels) against run_batch + the host backtrack on the 10
     of :75, and ops/ungapped.py's score_batch on the card against
     score_pair_numpy, with each part's seconds;
  9. past 2^31: phase 4's genome and reads behind one all-N gap chromosome
     of GAP_LEN bases, so the chromosome starts at 2,147,550,184 (past
     2^31, congruent to its phase-4 start modulo 2^16; about 2.2 GB of
     codes on the card; the gap emits no k-mer, so the index is phase 4's
     shifted), mapped with the device search and again with the host
     search on the same Pipeline: the SAMs equal, the SAM body (@SQ lines
     aside) equal to phase 4's, every row handed to the four alignment
     kernels at ds >= 2^31 (recorded by stand-ins for their wrappers), the
     first batch's candidates equal to the host search_batch, with its
     setup seconds and peak device memory;
 10. past 2^32: phase 4's genome and reads behind one all-N gap chromosome
     of GAP_LEN_32 bases, so the chromosome starts at 4,295,033,832 and
     the ~4.35 Gbp genome is three units of the real 2^31 slab (9.66 GB of
     planes on the card; the chromosome in unit 2); mapped as the
     reference maps a multi-unit genome (host search, Python assembly
     path) under NGMLR_TPU_STRICT=1: the index int64 and none of its
     positions below the chromosome, every row handed to the four
     alignment kernels naming unit 2, the SAM body equal to phase 4's,
     with its setup seconds and peak device memory;
 11. the bench: scripts/torch_bench.py (bench.py's port) in a subprocess,
     pinned at the ladder's first scale (30 Mbp, 576 + 16 reads, 3 passes,
     a 300 s deadline): exit code 0, its one JSON line without an error,
     reads/s above 0, >= 0.95 mapped, 0 < useful GCUPS <= padded, waves of
     the native engine, every kernel launched in the best pass (as often
     as check_launches wants, which the bench holds), on the card phase 1
     read; the line is logged; then the bench's 576 timed reads map once
     in this process on its caches (device search, native engine, under
     NGMLR_TPU_STRICT=1), the SAM equal to the JAX package's (bench30);
 12. the SV-rich fuzz: the six seeds committed in tests/golden/torch_fuzz
     (scripts/fuzz_vs_reference.py's datasets, 501-505 with -x pacbio and
     506 with -x ont: a 500 kbp genome of two chromosomes with an N gap,
     150 reads of eight kinds: short, clean and noisy long,
     deletion-spanning, inversions, translocations, junk and N-gap spans)
     mapped through scripts/torch_fuzz_vs_jax.py's map_seed with the
     device search, the host search and the device search at 20-read
     batches on one Pipeline, under NGMLR_TPU_STRICT=1: every SAM equal to
     the JAX package's committed SAM byte for byte (@PG aside), every
     mapping's launches its engine's record, all five kernels launched
     over the device-search runs; each seed's reads, identical reads, SA:Z
     and supplementary records, unmapped reads and map seconds logged;
 13. long SV reads: scripts/torch_scale_vs_jax.py's svlong (64 reads of
     10-40 kb on phase 4's genome: clean, deletions of 1-20 kb, insertions
     of 0.5-5 kb, inversions and tandem duplications of 1-10 kb, joins of
     pieces >= 1 Mbp apart; 15% noise, half reverse-complemented) through
     its map_both on a new Pipeline: the device search, then the host
     search, under NGMLR_TPU_STRICT=1, the native engine's waves, each SAM
     equal to the JAX package's (dataset svlong), convex_fill's lane
     classes logged;
 14. ultra-long reads: the script's ultralong (36 reads of 50-250 kb on
     phase 4's genome, svlong's kinds at larger events, 8-15% noise)
     through map_both as in phase 13, every read and the file held to the
     JAX package's digests (dataset ultralong); the fill's lane classes
     (R=8 and the wide kernel), its largest launch's direction bytes (4
     GiB, DIRS_CAP's limit), the rows DIRS_CAP refused and the peak device
     memory logged; every kernel launched, the phase's launches on the
     kernels line (ultralong_launches). In phases 13 and 14 the largest
     align launch's first row is then copied into each of its slots and
     launched again: each slot's ops and scalars equal the first row's in
     the mapping (in phase 14 the last slots' direction bytes lie past
     2^31);
 15. the CLI's option sets over FASTQ input (scripts/torch_options_vs_jax.py):
     fuzzq (seed 501's fuzz dataset with per-base qualities, FASTQ.gz)
     under every option set but bamfix (default, ont, scoring, affine,
     fractional, k11, k15, bins, sub128, sub512, strict, nosplit,
     readgroup), each through the script's map_set on a new Pipeline
     built from the set's argv by the port's parser: the gate's
     search, which must be the device search for every set but sub512
     (whose gate keeps the host search), then the other search (sub512:
     the host search at 20-read batches), readgroup also through the
     CLI's -o *.sam.gz; every read, QUAL included, and each whole file
     equal to the JAX package's digests (tests/golden/torch_options);
     every kernel launched, the phase's launches on the kernels line
     (options_launches). phase4q (phase 4 as FASTQ.gz) is held by the
     script's card run alone: under scoring and k15 it adds ~47 s (an
     index build at k = 13 and one at k = 15 with its 2^30-row table) to
     a smoke that must stay well inside its time limit.
With --profile DIR, torch.profiler traces the first mapping of phases 4
and 5 (device time by kernel and the busy share; in phase 4 also the
launch shapes of corridor_windows, convex_fill and convex_backtrack and
their device ms per launch, and convex_fill's wavefronts and us per
wavefront). Then one JSON line
listing every kernel, the card's line from nvidia-smi, and the final line
{"ok": true, "device": {...}}.

Every mapping run (each golden, each mapping of phases 4 to 7, 9, 10,
12 to 15, and phase 11's in-process one; a process of phase 6's
two-process run reports its own) sets the launch counters to 0 just
before it drives the pipeline and reads them just after; each run's
counts must equal the launches its own engine recorded (one score_fill per
shard of each score wave, one launch of each convex kernel per shard of
each align wave, a shard per wave off a mesh, one expand_votes per
row-local device-search launch, none with the host search), and the first
mappings of phases 4, 5 and 9 must launch all five. On the mesh,
mesh_problems_psum must equal the real problems handed to the waves,
counted on the host before the split.
The kernels line carries the counts of phase 4's first mapping, the
main path, under ultralong_launches those of phase 14's two mappings,
and under options_launches those of phase 15's mappings; the
comparisons of phase 2 count nowhere. Any failed phase exits non-zero
without the final line. Needs one CUDA card, nvcc and the
repository checkout (it imports ngmlr_tpu_torch from beside this file).
"""

import argparse
import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import threading
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
# corridor_windows, per problem and wavefront: the two counts (a mark and
# a scan add each), the window height and its running max; per row, the two
# keys (conversion, subtract, divide ~10 FMA-pipe instructions as
# __fdiv_rn expands, convert back; clamps, max, add: 8 ALU each)
OPS_WINDOW_STEP = (0, 6)
OPS_WINDOW_ROW = (20, 16)
# convex_fill, per live cell, as the tiled kernel computes it: diag = s2 +
# (mat | mis) (1 add; the code test and a select, 2); the max of three with
# the floor (3); the three tie tests and the two extension tests (5); the
# live test (1); the keep / DEL / INS predicates (4); the run and the score
# selects (3); the per-lane best (3); the direction (3); the value the cell
# offers its neighbours: run * gdecay + ge, + s, + go, run + 1 (5 adds and
# multiplies), the min with gemin, the zero test and its select (3), the
# four up / left selects (4); packing the direction byte (1)
OPS_FILL_CELL = (6, 32)
# convex_backtrack, per walk step, the walk's own tests as the plain
# version makes them: the lane and its bounds (3), the STOP test (1), the
# validPath band (convert, 2 adds + 1 subtract, 2 converts back; 2
# compares), the op's pack (2), the two moves (6), the edge test (2) and
# the step's wavefront test (2)
OPS_WALK_STEP = (3, 21)
# expand_votes, per vote and binary-search step: the compare and the select
# of the next bound (ceil(log2(SL2 + 1)) = 10 steps for 544 slots)
OPS_EXPAND_STEP = (0, 2)

# phase 4: one chromosome (about human chr21/22) and PacBio-like reads
MAPPING_SEED = 1234
GENOME_MBP = 50.0
N_READS = 256
READ_LEN = 9000
# phase 5: about human chr1
LARGE_SEED = 2500
LARGE_GENOME_MBP = 250.0
# phase 5's genome carries one repeat family, about a young LINE-1
# subfamily (full-length L1 is ~6 kb; young subfamilies hold hundreds of
# near-identical copies): REPEAT_COPIES copies of one REPEAT_LEN element,
# REPEAT_DIV of each copy's bases redrawn, half of them reverse-complemented
# (2.4% of the genome). REPEAT_READS more reads start inside copies, every
# other one at REPEAT_READ_ERR error, as ONT R10 reads do (their subreads in
# a copy pass L_V2_MAX votes: v1 outliers), the rest PacBio-like at 15%
# (their subreads in a copy pass E_CAP entries: v2 rows rerun through v1).
# Each such read took ~30 s of chaining on the host of an H100 80GB HBM3
# machine, so there are two.
REPEAT_LEN = 6000
REPEAT_COPIES = 1000
REPEAT_DIV = 0.005
REPEAT_READS = 2
REPEAT_READ_ERR = 0.02
KERNELS =("score_fill", "corridor_windows", "convex_fill",
           "convex_backtrack", "expand_votes")


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
    """Mean device time of fn() over reps launches, by CUDA events. The
    launches queue behind a sleep kernel (~10 ms), so for a kernel shorter
    than its wrapper's host overhead the gaps between launches do not
    count."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
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

# the score parameters of the kernels' comparisons
PARAMS = (2.0, -5.0, -5.0, -5.0, -1.0, 0.15)

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
        ci, width, cf = corridor(mode, W, H, int(rng.integers(*widths)))
        pku[b, 0], pku[b, 1] = ds, ds + W
        pk[b, 2:10] = (0, W, qs, H, b & 1, mode, ci, width)
        pkf[b, 10:12] = cf
    return pk


def corridor(mode, W, H, width):
    """(ci, width, (k, d)) of a corridor of the given mode over a W x H
    problem, as the aligner makes them (FULL: its own width)."""
    f32 = np.float32
    if mode == 0:
        w = W + 1
        return (int(f32(w) * f32(-0.2)), w + int(f32(w) * f32(0.2)),
                (1.0, 0.0))
    if mode == 1:
        return width // 2, width, (1.0, 0.0)
    return 0, width, (float(f32(H) / f32(W)), float(f32(width) / f32(2.0)))


# phase 2's unit rows: a genome of UNIT_PLANES planes of UNIT_PLANE bytes
# (a slab of 3/4 of the plane, the rest its halo), as DeviceContext stacks a
# genome of more than one slab
UNIT_PLANES = 5
UNIT_PLANE = 1 << 20
UNIT_KINDS = ("end", "past-end", "halo")


def unit_rows(rng, planes, readbuf, B, Wr, widths, modes, H_max=None,
              q0=0, plane_len=None, halo=None):
    """Align rows int32 [B, 12] over the planes of a unit genome u8
    [U, planeP], each row's unit (spread over every plane) in bits 28+ of
    W, ds and hi local to its plane. By kind, cycling: end, a window that
    ends 0-64 bases before its plane's end (plane_len, else the plane's
    whole length); past-end, one that starts 1-64 bases before it, so its
    window runs past that end (past the plane itself, a position reads the
    plane's last byte); halo, one in the plane's last quarter (the slab's
    halo), or with halo = (lo, hi) one starting in [lo, hi). Each query is
    a PacBio-like mutated copy of its window (as the kernels read it), at
    most H_max long, written into readbuf from q0 (reverse-complemented on
    odd rows). The first 7 columns are score rows."""
    U, planeP = planes.shape
    end = planeP if plane_len is None else plane_len
    pk = np.zeros((B, 12), np.int32)
    pku, pkf = pk.view(np.uint32), pk.view(np.float32)
    qs = q0
    for b in range(B):
        u = b % U
        kind = UNIT_KINDS[(b // U) % len(UNIT_KINDS)]
        W = int(rng.integers(*Wr))
        if kind == "end":
            hi = end - int(rng.integers(0, 65))
            ds = hi - W
        elif kind == "past-end":
            ds = end - int(rng.integers(1, 65))
            hi = ds + W
        else:
            ds = int(rng.integers(*(halo or (end * 3 // 4, end - W))))
            hi = ds + W
        window = planes[u, np.minimum(np.arange(ds, ds + W), planeP - 1)]
        q = np.frombuffer(mutate_codes(rng, window), np.uint8)[:H_max]
        H = len(q)
        readbuf[qs:qs + H] = np.where(q < 4, q ^ 1, q)[::-1] if b & 1 else q
        mode = int(modes[b % len(modes)])
        ci, width, cf = corridor(mode, W, H, int(rng.integers(*widths)))
        pku[b, 0], pku[b, 1] = ds, hi
        pk[b, 2:10] = (0, W | (u << 28), qs, H, b & 1, mode, ci, width)
        pkf[b, 10:12] = cf
        qs += H
    return pk


# phase 2's rows past 2^31: a flat genome of HIGH_G bytes whose last
# HIGH_SPAN bytes (from HIGH_G - HIGH_SPAN, past 2^31) hold numpy-seeded
# codes and the rest N codes
HIGH_G = (1 << 31) + (1 << 26)
HIGH_SPAN = 1 << 26
HIGH_KINDS = ("end", "past-end", "inside")

# phase 2's real-slab planes: REAL_UNITS planes of the default 2^31-base
# slab and its 2^24-base halo, each of the size DeviceContext gives it
# (3,221,225,472 B; plane 2 starts 6,442,450,944 B into the tensor), N
# codes but for numpy-seeded codes from REAL_SEEDED_FROM up to REAL_SEEDED_TO
# (the end of the slab and the whole halo; N from the plane length on).
# unit_rows' halo windows start in REAL_HALO_DS, so they cross the slab's end
REAL_UNITS = 3
REAL_SLAB = 1 << 31
REAL_PLANE_LEN = REAL_SLAB + (1 << 24)
REAL_SEEDED_FROM = REAL_SLAB - (1 << 20)
REAL_SEEDED_TO = REAL_PLANE_LEN + (1 << 16)
REAL_HALO_DS = (REAL_SLAB - 12_000, REAL_SLAB + 4_000)


class SeededPlanes:
    """The real-slab planes' seeded bytes on the host: unit_rows reads
    shape and planes[u, positions] (positions in [REAL_SEEDED_FROM,
    REAL_SEEDED_TO)), and to(dev) makes the [REAL_UNITS, planeP] tensor on
    the card, N codes elsewhere."""

    def __init__(self, rng, planeP):
        self.shape = (REAL_UNITS, planeP)
        self.top = np.full((REAL_UNITS, REAL_SEEDED_TO - REAL_SEEDED_FROM), 4,
                           np.uint8)
        n = REAL_PLANE_LEN - REAL_SEEDED_FROM
        self.top[:, :n] = rng.integers(0, 5, (REAL_UNITS, n))

    def __getitem__(self, key):
        u, pos = key
        pos = np.asarray(pos) - REAL_SEEDED_FROM
        check(pos.min() >= 0 and pos.max() < self.top.shape[1],
              "a real-slab window outside the seeded bytes")
        return self.top[u, pos]

    def to(self, dev):
        import torch
        planes = torch.full(self.shape, 4, dtype=torch.uint8, device=dev)
        planes[:, REAL_SEEDED_FROM:REAL_SEEDED_TO] = \
            torch.from_numpy(self.top).to(dev)
        return planes


def high_rows(rng, top, lo, readbuf, B, Wr, widths, modes, H_max=None,
              q0=0):
    """Align rows int32 [B, 12] over a flat genome whose last len(top)
    bytes, from lo, are top (the genome ends at lo + len(top)); ds and hi
    are absolute, so with lo past 2^31 both pass it. By kind, cycling: end,
    a window that ends at the genome's last byte (row 0) or 1-64 bases
    before it; past-end, one that starts 1-64 bases before the end, so it
    runs past it (a position there reads the last byte); inside, one
    anywhere in top. Each query is a PacBio-like mutated copy of its window
    (as the kernels read it), at most H_max long, written into readbuf from
    q0 (reverse-complemented on odd rows). The first 7 columns are score
    rows."""
    n = len(top)
    pk = np.zeros((B, 12), np.int32)
    pku, pkf = pk.view(np.uint32), pk.view(np.float32)
    qs = q0
    for b in range(B):
        kind = HIGH_KINDS[b % len(HIGH_KINDS)]
        W = int(rng.integers(*Wr))
        if kind == "end":
            hi = n - (0 if b == 0 else int(rng.integers(1, 65)))
            ds = hi - W
        elif kind == "past-end":
            ds = n - int(rng.integers(1, 65))
            hi = ds + W
        else:
            ds = int(rng.integers(0, n - W))
            hi = ds + W
        window = top[np.minimum(np.arange(ds, ds + W), n - 1)]
        q = np.frombuffer(mutate_codes(rng, window), np.uint8)[:H_max]
        H = len(q)
        readbuf[qs:qs + H] = np.where(q < 4, q ^ 1, q)[::-1] if b & 1 else q
        mode = int(modes[b % len(modes)])
        ci, width, cf = corridor(mode, W, H, int(rng.integers(*widths)))
        pku[b, 0], pku[b, 1] = lo + ds, lo + hi
        pk[b, 2:10] = (0, W, qs, H, b & 1, mode, ci, width)
        pkf[b, 10:12] = cf
        qs += H
    return pk


# the edge cases of the tiled corridor_windows kernel (1024-wavefront tiles):
# name -> (B, TpP, W and H below); every case cycles the four modes
CW_EDGES = {
    "tpp-512": (64, 512, 400, 400),           # below one tile
    "ragged-tile": (96, 3 * 1024 + 160, 2000, 2000),
    "first-key-tiles-up": (40, 8192, 8000, 3000),
    "tall": (48, 1024, 800, 5000),            # H past TpP
    "one-problem": (1, 2048, 1500, 1500),
    "odd-B": (37, 4096, 3000, 3000),
}


def cw_edge_case(name):
    """(align rows int32 [B, 12], TpP) of one corridor_windows edge case.
    With B >= 8, rows 1-3 have H = 0, width 0 and width < 0. In
    first-key-tiles-up every corridor starts 2000-5000 wavefronts up (FULL
    ci, LINEAR -ci, ENDPOINTS and ANCHORS d), so a row's first key lies
    several tiles above t = 0."""
    B, TpP, Wmax, Hmax = CW_EDGES[name]
    rng = np.random.default_rng(100 + list(CW_EDGES).index(name))
    pk = np.zeros((B, 12), np.int32)
    pkf = pk.view(np.float32)
    mode = np.arange(B) % 4
    pk[:, 7] = mode
    pk[:, 3] = rng.integers(1, Wmax, B)
    pk[:, 5] = rng.integers(0, Hmax, B)
    pk[:, 8] = rng.integers(-50, 200, B)
    pk[:, 9] = rng.integers(1, max(2, Wmax // 2), B)
    k = rng.uniform(0.05, 3.0, B).astype(np.float32)
    d = rng.uniform(-100.0, 100.0, B).astype(np.float32)
    if name == "first-key-tiles-up":
        far = rng.integers(2000, 5000, B)
        pk[:, 3] = rng.integers(6000, 8000, B)
        pk[:, 8] = np.where(mode == 0, far, np.where(mode == 1, -far, 0))
        k = rng.uniform(0.5, 2.0, B).astype(np.float32)
        d = np.where(mode == 2, -far * k, -far).astype(np.float32)
    if name == "tall":
        pk[:, 5] = rng.integers(TpP + 1, Hmax, B)
    if B >= 8:
        pk[1, 5] = 0
        pk[2, 9] = 0
        pk[3, 9] = -int(rng.integers(1, 50))
    pkf[:, 10], pkf[:, 11] = k, d
    return pk, TpP


# the edge cases of the tiled convex_backtrack kernel, whose tiles hold
# BT_TILE wavefronts (R in csrc/convex_backtrack.cu): name -> (B, TpP, L,
# kind of problem 0); problem b takes kind BT_KINDS[(first + b) % 9]. L130
# takes the kernel's path for an L that is not a multiple of 4.
BT_TILE = 60
BT_EDGES = {
    "L128": (13, 2048, 128, 0),
    "L1536": (6, 1024, 1536, 2),
    "L12288": (3, 1024, 12288, 5),
    "one-problem": (1, 4096, 256, 3),
    "L130": (5, 1024, 130, 3),
}
BT_KINDS = ("top", "by-0", "by-negative", "stop-on-tile-boundary",
            "validpath-exit", "off-x", "off-y", "random", "del-run")


def bt_edge_case(name):
    """(dirs u8 [B, TpP, L], ymin int32 [B, TpP], align rows int32 [B, 12],
    bx, by int32 [B], {b: (state, sx, sy) the walk must end in}) of one
    convex_backtrack edge case. Random directions (1 in 4096 a STOP) and a
    FULL corridor whose validPath band holds every cell, except where the
    kind sets them: top starts at wavefront TpP - 1; by-0 and by-negative
    fail at once; stop-on-tile-boundary walks INS to a STOP at a wavefront
    that is a multiple of BT_TILE; validpath-exit walks DEL out of a LINEAR
    band; off-x walks DEL past x = 0, off-y INS past y = 0; del-run walks
    DEL from a tile's top row across several tiles and off the matrix (each
    tile is left 120 columns from where it was entered)."""
    B, TpP, L, first = BT_EDGES[name]
    rng = np.random.default_rng(200 + list(BT_EDGES).index(name))
    dirs = rng.integers(1, 4, (B, TpP, L), dtype=np.uint8)
    flat = dirs.reshape(-1)
    flat[rng.integers(0, flat.size, flat.size // 4096)] = 0
    t = np.arange(TpP)
    ymin = np.repeat(np.maximum(0, t // 2 - L // 2)[None, :], B, axis=0)
    ymin = ymin.astype(np.int32)
    pk = np.zeros((B, 12), np.int32)
    pk[:, 3], pk[:, 5] = TpP, TpP
    pk[:, 8], pk[:, 9] = -2 * TpP, 10 * TpP      # FULL: band holds all x
    pk.view(np.float32)[:, 10] = 1.0
    bx = rng.integers(TpP // 8, TpP // 2, B).astype(np.int32)
    by = rng.integers(TpP // 8, TpP // 2, B).astype(np.int32)
    expect = {}
    DONE, FAIL = 1, 2
    for b in range(B):
        kind = BT_KINDS[(first + b) % len(BT_KINDS)]
        if kind == "top":
            by[b] = TpP // 2
            bx[b] = TpP - 1 - by[b]
        elif kind in ("by-0", "by-negative"):
            bx[b], by[b] = 100, 0 if kind == "by-0" else -3
            expect[b] = (FAIL, -1, -1)
        elif kind == "stop-on-tile-boundary":
            x0, t0 = 100, TpP - 38
            ts = BT_TILE * (t0 // BT_TILE - 2)
            dirs[b] = 2                          # INS: y - 1, t - 1
            ymin[b] = np.maximum(0, t - x0 - L // 2)
            dirs[b, ts, ts - x0 - ymin[b, ts]] = 0
            bx[b], by[b] = x0, t0 - x0
            expect[b] = (DONE, x0, ts - x0)
        elif kind == "validpath-exit":
            y0 = TpP // 4
            dirs[b] = 3                          # DEL: x - 1, t - 1
            ymin[b] = y0 - L // 2
            pk[b, 7:10] = (1, 0, 100)            # LINEAR: y + 10 < x < y + 100
            bx[b], by[b] = y0 + 40, y0
            expect[b] = (FAIL, -1, -1)
        elif kind == "off-x":
            dirs[b] = 3
            ymin[b] = 300 - L // 2
            bx[b], by[b] = 5, 300
            expect[b] = (DONE, -1, 300)
        elif kind == "off-y":
            dirs[b] = 2
            ymin[b] = 0
            bx[b], by[b] = 300, 5
            expect[b] = (DONE, 300, -1)
        elif kind == "del-run":
            y0, t0 = 200, BT_TILE * (TpP // BT_TILE // 2) + BT_TILE - 1
            dirs[b] = 3
            ymin[b] = y0 - L // 2
            bx[b], by[b] = t0 - y0, y0
            expect[b] = (DONE, -1, y0)
    return dirs, ymin, pk, bx, by, expect


# the edge cases of the tiled convex_fill kernel (tiles of 32 wavefronts,
# R lanes a thread, one warp or several a problem): name -> (B, Wp, Hp, L,
# kind of problem 0); problem b takes kind FILL_KINDS[(first + b) % 9]. The
# corridors' windows come from corridor_windows, so their ymin steps of 0
# and 1 fall in every combination of d1 and d2, across tile boundaries and
# thread and warp lane edges. L6144 and L12288 take the wide kernel, its
# last two wavefronts in shared memory and in a global scratch slab; L6144's
# windows reach past its first 1024 lanes.
FILL_EDGES = {
    "L128": (9, 512, 512, 128, 0),
    "L384": (9, 1024, 1024, 384, 4),
    "L640": (5, 1024, 1024, 640, 2),
    "L1024": (3, 1024, 1024, 1024, 6),
    "L1536": (2, 2048, 2048, 1536, 8),
    "L6144": (5, 1536, 1536, 6144, 4),
    "L12288": (1, 512, 512, 12288, 0),
    "one-problem": (1, 2048, 2048, 256, 6),
}
FILL_KINDS = ("slopes", "exact", "h0", "tiny", "all-n", "x-ends", "del-run",
              "short", "full")


def fill_edge_case(name):
    """(genome u8, readbuf u8, align rows int32 [B, 12], Wp, Hp, L) of one
    convex_fill edge case. Odd rows are reverse (their query is stored
    reverse-complemented). Kinds: slopes, an ENDPOINTS or ANCHORS corridor
    with H / W from 0.4 to 2.5 and a random query; exact, a query equal to
    its period-3 reference window, so equal scores tie across lanes and
    threads; h0, H = 0; tiny, W and H below one tile; all-n, a query of N;
    x-ends, 'x' reference codes at both ends (diff > 0, hi < ds + W);
    del-run, a query missing 60-120 bases of its window, so a DEL run takes
    the gap to gemin; short, a problem ending thousands of wavefronts before
    the rest; full, a FULL corridor, its windows wider than L."""
    B, Wp, Hp, L, first = FILL_EDGES[name]
    rng = np.random.default_rng(300 + list(FILL_EDGES).index(name))
    genome = rng.integers(0, 5, 300_000).astype(np.uint8)
    readbuf = rng.integers(0, 5, 1 << 16).astype(np.uint8)
    pk = np.zeros((B, 12), np.int32)
    pku, pkf = pk.view(np.uint32), pk.view(np.float32)
    f32 = np.float32
    q_next = 0
    top = int(0.85 * min(Wp, Hp))
    for b in range(B):
        kind = FILL_KINDS[(first + b) % len(FILL_KINDS)]
        W = int(rng.integers(top // 2, top))
        ds = int(rng.integers(0, len(genome) - Wp - 1))
        diff, hi = 0, ds + W
        seg = genome[ds:ds + W]
        query = None                       # forward codes, planted below
        mode, width = 2, int(rng.integers(L // 2, 2 * L))
        if kind == "slopes":
            H = int(np.clip(W * rng.uniform(0.4, 2.5), 1, Hp - 1))
            mode = 2 + (b & 1)
        elif kind == "exact":
            genome[ds:ds + W] = np.resize(np.arange(3, dtype=np.uint8), W)
            query = genome[ds:ds + W].copy()
            mode = 1
        elif kind == "h0":
            H = 0
        elif kind == "tiny":
            W = int(rng.integers(5, 32))
            hi = ds + W
            H = int(rng.integers(5, 32))
            mode = 0
        elif kind == "all-n":
            H = int(rng.integers(W // 2, min(Hp - 1, 2 * W)))
            query = np.full(H, 4, np.uint8)
        elif kind == "x-ends":
            diff = int(rng.integers(5, 40))
            hi = ds + W - diff - int(rng.integers(5, 40))
            query = np.frombuffer(mutate_codes(rng, genome[ds:hi]), np.uint8)
        elif kind == "del-run":
            cut = int(rng.integers(60, 120))
            query = np.concatenate([seg[:W // 2], seg[W // 2 + cut:]])
            mode, width = 1, 2 * cut + 40
        elif kind == "short":
            W = int(rng.integers(40, 200))
            hi = ds + W
            query = np.frombuffer(mutate_codes(rng, genome[ds:hi]), np.uint8)
            mode, width = 1, 60
        else:                              # full
            query = np.frombuffer(mutate_codes(rng, seg), np.uint8)
            mode = 0
        if query is not None:
            query = query[:Hp - 1]
            H = len(query)
            readbuf[q_next:q_next + H] = (
                np.where(query < 4, query ^ 1, query)[::-1] if b & 1 else query)
            qs = q_next
            q_next += H
        else:
            qs = int(rng.integers(q_next, len(readbuf) - Hp))
        if mode == 0:
            w = W + 1
            ci = int(f32(w) * f32(-0.2))
            width = w + int(f32(w) * f32(0.2))
            cf = (1.0, 0.0)
        elif mode == 1:
            ci, cf = width // 2, (1.0, 0.0)
        else:
            ci = 0
            cf = (float(f32(max(H, 1)) / f32(W)), float(f32(width) / f32(2.0)))
        pku[b, 0], pku[b, 1] = ds, hi
        pk[b, 2:10] = (diff, W, qs, H, b & 1, mode, ci, width)
        pkf[b, 10:12] = cf
    return genome, readbuf, pk, Wp, Hp, L


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else \
        "nvidia-smi unavailable"


def phase_card_and_build():
    from ngmlr_tpu_torch.ops import build
    card = card_line()
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
    params = torch.tensor(PARAMS, dtype=torch.float32, device=dev)
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
    for name in CW_EDGES:
        epk_np, eT = cw_edge_case(name)
        epk = torch.from_numpy(epk_np).to(dev)
        e = max_abs_err(zip(K.corridor_windows(epk, eT),
                            K.corridor_windows_plain(epk, eT)))
        rec["corridor_windows"]["max_abs_err"] = max(
            rec["corridor_windows"]["max_abs_err"], e)
        log("corridor_windows edge %s B=%d TpP=%d: max_abs_err=%g"
            % (name, epk.shape[0], eT, e))

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
    for name in BT_EDGES:
        *arrays, expect = bt_edge_case(name)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = K.convex_backtrack(*args)
        want = K.convex_backtrack_plain(*args)
        e = max_abs_err(zip(got, want))
        bt_err = max(bt_err, e)
        ends = [(int(want[3][b]), int(want[1][b]), int(want[2][b]))
                for b in range(args[0].shape[0])]
        check(all(ends[b] == v for b, v in expect.items()),
              "backtrack edge %s: the walks end as %s, not as %s"
              % (name, ends, expect))
        log("convex_backtrack edge %s B=%d TpP=%d L=%d: max_abs_err=%g, "
            "walk ends (state, x, y) %s" % ((name,) + tuple(args[0].shape)
                                            + (e, ends)))
        del args, got, want
    for name in FILL_EDGES:
        e, rows = fill_edge_err(name, dev)
        fill_err = max(fill_err, e)
        log("convex_fill edge %s B=%d Wp=%d Hp=%d L=%d: max_abs_err=%g over "
            "%d live wavefront rows" % ((name,) + FILL_EDGES[name][:4]
                                        + (e, rows)))
    rec["convex_fill"]["max_abs_err"] = fill_err
    rec["convex_backtrack"]["max_abs_err"] = bt_err
    rec["expand_votes"] = phase_expand_votes(rng, dev)
    real_errs, real_ms = real_slab_errs(dev)
    for errs in (unit_kernel_errs(dev), high_kernel_errs(dev), real_errs):
        for name, e in errs.items():
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], e)
    for name, ms in real_ms.items():
        rec[name]["real_slab_ms"] = ms
    return rec


def score_err(tag, genome, readbuf, spk_np, timed=False):
    """score_fill against its plain version on score rows spk_np at the hot
    320 x 256 bucket. Returns (max_abs_err, kernel ms or None; timed: CUDA
    events over 20 launches)."""
    import torch
    from ngmlr_tpu_torch.ops import kernels as K
    spk = torch.from_numpy(np.ascontiguousarray(spk_np)).to(genome.device)
    got = K.score_fill(genome, readbuf, spk, 320, 256)
    err = max_abs_err([(got, K.score_fill_plain(genome, readbuf, spk, 320,
                                                256))])
    ds = spk_np[:, 0].view(np.uint32)
    log("%s: score_fill P=%d, ds %d-%d, on a genome of %s B: max_abs_err=%g, "
        "median score %g" % (tag, len(spk_np), int(ds.min()), int(ds.max()),
                             " x ".join(map(str, genome.shape)), err,
                             float(got.median())))
    ms = cuda_ms(lambda: K.score_fill(genome, readbuf, spk, 320, 256),
                 reps=20) if timed else None
    return err, ms


def chain_errs(tag, genome, readbuf, shapes, timed=None):
    """corridor_windows, convex_fill and convex_backtrack against their
    plain versions on each (name, Wp, Hp, L, align rows) of shapes; the
    shape named timed is also timed (CUDA events). Returns ({kernel:
    max_abs_err}, {kernel: ms})."""
    import torch
    from ngmlr_tpu_torch.ops import kernels as K
    params = torch.tensor(PARAMS, dtype=torch.float32, device=genome.device)
    errs = dict(corridor_windows=0.0, convex_fill=0.0, convex_backtrack=0.0)
    times = {}
    for name, Wp, Hp, L, apk_np in shapes:
        apk = torch.from_numpy(apk_np).to(genome.device)
        TpP = Wp + Hp
        win = K.corridor_windows(apk, TpP)
        e_cw = max_abs_err(zip(win, K.corridor_windows_plain(apk, TpP)))
        ymin, ymax, hmax = win
        got = K.convex_fill(genome, readbuf, apk, params, ymin, ymax, L)
        want = K.convex_fill_plain(genome, readbuf, apk, params, ymin, ymax,
                                   L)
        live = (ymin < apk[:, 5:6])[:, :, None].expand(-1, -1, L)
        e_fill = max_abs_err([(got[1], want[1]), (got[2], want[2]),
                              (got[3], want[3]),
                              (got[0][live], want[0][live])])
        dirs, best, by, bx = got
        bt = K.convex_backtrack(dirs, ymin, apk, bx, by)
        e_bt = max_abs_err(zip(bt, K.convex_backtrack_plain(dirs, ymin, apk,
                                                            bx, by)))
        for k, e in (("corridor_windows", e_cw), ("convex_fill", e_fill),
                     ("convex_backtrack", e_bt)):
            errs[k] = max(errs[k], e)
        log("%s: convex %s B=%d Wp=%d Hp=%d L=%d, ds from %d: windows, fill, "
            "backtrack max_abs_err = %g, %g, %g; ok=%d/%d, max hmax %d"
            % (tag, name, apk.shape[0], Wp, Hp, L,
               int(apk_np[:, 0].view(np.uint32).min()), e_cw, e_fill, e_bt,
               int(bt[3].eq(K.DONE).sum()), apk.shape[0], int(hmax.max())))
        if name == timed:
            times = dict(
                corridor_windows=cuda_ms(
                    lambda: K.corridor_windows(apk, TpP), reps=20),
                convex_fill=cuda_ms(lambda: K.convex_fill(
                    genome, readbuf, apk, params, ymin, ymax, L), reps=3),
                convex_backtrack=cuda_ms(lambda: K.convex_backtrack(
                    dirs, ymin, apk, bx, by), reps=3))
        del got, want, bt, dirs
        torch.cuda.empty_cache()
    return errs, times


def unit_kernel_errs(dev):
    """The four alignment kernels against their plain versions on rows of
    a genome of UNIT_PLANES unit planes (unit_rows: windows at and past each
    plane's end and in its halo): score_fill at the hot 320 x 256 bucket,
    then corridor_windows, convex_fill and convex_backtrack at a tiled and
    a wide lane class of the fill. Returns {kernel: max_abs_err}."""
    import torch
    rng = np.random.default_rng(70)
    planes_np = rng.integers(0, 5, (UNIT_PLANES, UNIT_PLANE)).astype(np.uint8)
    readbuf_np = rng.integers(0, 5, 1 << 20).astype(np.uint8)
    spk_np = unit_rows(rng, planes_np, readbuf_np, 600, (306, 307), (1, 2),
                       (1,), H_max=256)[:, :7]
    shapes = [(tag, Wp, Hp, L, unit_rows(rng, planes_np, readbuf_np, 15,
                                         (600, 1800), widths, modes,
                                         H_max=Hp - 1, q0=q0))
              for tag, Wp, Hp, L, widths, modes, q0 in (
                  ("tiled", 2048, 2048, 256, (100, 300), (1, 2, 3), 200_000),
                  ("wide", 2048, 2048, 6144, (800, 1600), (0, 2, 3),
                   600_000))]
    planes = torch.from_numpy(planes_np).to(dev)
    readbuf = torch.from_numpy(readbuf_np).to(dev)
    errs = {"score_fill": score_err("units", planes, readbuf, spk_np)[0]}
    errs.update(chain_errs("units", planes, readbuf, shapes)[0])
    return errs


def high_kernel_errs(dev):
    """The four alignment kernels against their plain versions on rows past
    2^31 of a flat genome of HIGH_G bytes (high_rows: windows ending at and
    running past its last byte, and inside its seeded top): score_fill at
    the hot 320 x 256 bucket, then corridor_windows, convex_fill and
    convex_backtrack at a tiled and a wide lane class of the fill. Returns
    {kernel: max_abs_err}."""
    import torch
    rng = np.random.default_rng(231)
    lo = HIGH_G - HIGH_SPAN
    top = rng.integers(0, 5, HIGH_SPAN).astype(np.uint8)
    readbuf_np = rng.integers(0, 5, 1 << 20).astype(np.uint8)
    spk_np = high_rows(rng, top, lo, readbuf_np, 600, (306, 307), (1, 2),
                       (1,), H_max=256)[:, :7]
    shapes = [(tag, Wp, Hp, L, high_rows(rng, top, lo, readbuf_np, 15,
                                         (600, 1800), widths, modes,
                                         H_max=Hp - 1, q0=q0))
              for tag, Wp, Hp, L, widths, modes, q0 in (
                  ("tiled", 2048, 2048, 256, (100, 300), (1, 2, 3), 200_000),
                  ("wide", 2048, 2048, 6144, (800, 1600), (0, 2, 3),
                   600_000))]
    genome = torch.full((HIGH_G,), 4, dtype=torch.uint8, device=dev)
    genome[lo:] = torch.from_numpy(top).to(dev)
    readbuf = torch.from_numpy(readbuf_np).to(dev)
    errs = {"score_fill": score_err("past 2^31", genome, readbuf,
                                    spk_np)[0]}
    errs.update(chain_errs("past 2^31", genome, readbuf, shapes)[0])
    del genome
    torch.cuda.empty_cache()
    return errs


def real_slab_errs(dev):
    """The four alignment kernels against their plain versions on unit rows
    over REAL_UNITS planes of the real 2^31 slab (SeededPlanes; 9.66 GB on
    the card, plane 2 past 2^32 of the tensor; unit_rows: windows at and
    past each plane's end and across its slab's end, local ds past 2^31),
    at phase 2's main-path shapes (score_fill P=4096 at 320 x 256; the
    fill's B=32, Wp=Hp=16384, L=256, 9-10 kb windows) and the wide lane
    class, the main-path shapes timed. Returns ({kernel: max_abs_err},
    {kernel: ms})."""
    import torch
    from ngmlr_tpu_torch.ops.device_engine import _size_class
    rng = np.random.default_rng(2032)
    planeP = _size_class(REAL_PLANE_LEN + 8, 1 << 20)
    seeded = SeededPlanes(rng, planeP)
    readbuf_np = rng.integers(0, 5, 1 << 21).astype(np.uint8)
    rows = dict(plane_len=REAL_PLANE_LEN, halo=REAL_HALO_DS)
    spk_np = unit_rows(rng, seeded, readbuf_np, 4096, (306, 307), (1, 2),
                       (1,), H_max=256, **rows)[:, :7]
    shapes = [("main-path", 16384, 16384, 256, unit_rows(
                  rng, seeded, readbuf_np, 32, (9000, 10000), (200, 400),
                  (2, 3), H_max=16383, q0=1_100_000, **rows)),
              ("wide", 2048, 2048, 6144, unit_rows(
                  rng, seeded, readbuf_np, 15, (600, 1800), (800, 1600),
                  (0, 2, 3), H_max=2047, q0=1_700_000, **rows))]
    planes = seeded.to(dev)
    readbuf = torch.from_numpy(readbuf_np).to(dev)
    log("real slab: planes %s (%d B) on the card, plane 2 from byte %d"
        % (list(planes.shape), planes.nbytes, 2 * planeP))
    err, ms = score_err("real slab", planes, readbuf, spk_np, timed=True)
    errs, times = {"score_fill": err}, {"score_fill": ms}
    e, t = chain_errs("real slab", planes, readbuf, shapes,
                      timed="main-path")
    errs.update(e)
    times.update(t)
    log("real slab: kernel ms at the main-path shapes %s" % json.dumps(times))
    del planes
    torch.cuda.empty_cache()
    return errs, times


def fill_edge_err(name, dev):
    """(max_abs_err, live wavefront rows) of convex_fill against its plain
    version on one FILL_EDGES case, over best, by, bx and every direction
    byte of a live wavefront (ymin < H)."""
    import torch
    from ngmlr_tpu_torch.ops import kernels as K
    *bufs, pk_np, Wp, Hp, L = fill_edge_case(name)
    genome, readbuf, pk = (torch.from_numpy(a).to(dev)
                           for a in (*bufs, pk_np))
    params = torch.tensor(PARAMS, dtype=torch.float32, device=dev)
    ymin, ymax, _ = K.corridor_windows(pk, Wp + Hp)
    got = K.convex_fill(genome, readbuf, pk, params, ymin, ymax, L)
    want = K.convex_fill_plain(genome, readbuf, pk, params, ymin, ymax, L)
    live_t = ymin < pk[:, 5:6]
    live = live_t[:, :, None].expand(-1, -1, L)
    e = max_abs_err([(got[1], want[1]), (got[2], want[2]), (got[3], want[3]),
                     (got[0][live], want[0][live])])
    return e, int(live_t.sum())


def slot_tables(rng, B, L, n_positions, ragged=False, base_lo=0):
    """Device-search v2 slot tables of B rows with up to L votes each, as
    _search_kernel_v2 builds them: cum2 [B, SL2], d2tp / ct2p [B, SL2 + 1]
    int32. Votes fall on random slots, between 60% and all of L a row; the
    ragged case also has zero-vote rows, a row with exactly L votes, and
    rows whose votes all sit in one slot. Slot position bases are drawn
    from [base_lo, base_lo + n_positions), as uint32 bit patterns (from
    2^31 they have bit 31 set)."""
    from ngmlr_tpu_torch.seed.device_search import SL
    SL2 = 2 * SL
    nv = rng.integers(L * 3 // 5, L + 1, B)
    if ragged:
        nv[:4] = (0, L, L - 3, L)
    slots = rng.integers(0, SL2, (B, L))
    if ragged:
        slots[2] = 37                   # one slot holds all of a row's votes
        slots[3] = SL2 - 1              # ... the last slot, row full
        nv[8:11] = 0
    keep = np.arange(L)[None, :] < nv[:, None]
    flat = (np.arange(B)[:, None] * SL2 + slots)[keep]
    c2 = np.bincount(flat, minlength=B * SL2).reshape(B, SL2).astype(np.int32)
    base2 = rng.integers(base_lo, base_lo + n_positions, (B, SL2))
    ct2 = rng.integers(-300, 300, (B, SL2)).astype(np.int32)
    cum2 = np.cumsum(c2, axis=1, dtype=np.int32)
    zero = np.zeros((B, 1), np.int32)
    d2t = ((base2 - (cum2 - c2)) & 0xFFFFFFFF).astype(np.uint32)
    d2tp = np.concatenate([d2t.view(np.int32), zero], axis=1)
    ct2p = np.concatenate([ct2, zero], axis=1)
    return cum2, d2tp, ct2p


def phase_expand_votes(rng, dev):
    """expand_votes against its plain version (integers: exact) at the
    launch classes that 9 kb reads land in on a 250 Mbp genome, (B, L) =
    (4096, 768), and on a 50 Mbp one, (8192, 512), the largest vote class
    (128, 32768), a small ragged case and the first class again with slot
    position bases that have bit 31 set; timed at the first, beside one
    torch.searchsorted + two gathers (the library yardstick, checked for
    equality, used nowhere in the port)."""
    import torch
    from ngmlr_tpu_torch.ops import kernels as K
    err, out = 0.0, None
    for tag, B, L, ragged, base_lo in (
            ("main", 4096, 768, False, 0),
            ("50 Mbp", 8192, 512, False, 0),
            ("L_V2_MAX", 128, 32768, False, 0),
            ("ragged", 16, 512, True, 0),
            ("bit 31", 4096, 768, False, 1 << 31)):
        t = [torch.from_numpy(x).to(dev)
             for x in slot_tables(rng, B, L, 83_000_000, ragged, base_lo)]
        got = K.expand_votes(*t, L)
        want, plain_ms = timed_once(lambda: K.expand_votes_plain(*t, L))
        e = max_abs_err(zip(got, want))
        err = max(err, e)
        log("expand_votes %s B=%d L=%d: max_abs_err=%g" % (tag, B, L, e))
        if tag != "main":
            continue
        cum2, d2tp, ct2p = t
        ms = cuda_ms(lambda: K.expand_votes(cum2, d2tp, ct2p, L), reps=20)
        cols = torch.arange(L, dtype=torch.int32, device=dev)[None, :] \
            .expand(B, -1).contiguous()

        def lib():
            s = torch.searchsorted(cum2, cols, right=True)
            return s, torch.gather(d2tp, 1, s), torch.gather(ct2p, 1, s)
        check(all(torch.equal(a.to(torch.int32), b)
                  for a, b in zip(lib(), want)),
              "searchsorted yardstick disagrees with expand_votes")
        lib_ms = cuda_ms(lib, reps=20)
        SL2 = cum2.shape[1]
        steps = int(np.ceil(np.log2(SL2 + 1)))
        b, by_ = bound_ms(B * L * 12 + B * (3 * SL2 + 2) * 4,
                          ops_of(OPS_EXPAND_STEP, B * L * steps))
        log("expand_votes main B=%d L=%d: kernel_ms=%.4f plain_ms=%.2f "
            "library_ms=%.4f bound_ms=%.4f (%s)"
            % (B, L, ms, plain_ms, lib_ms, b, by_))
        out = dict(
            name="expand_votes", route="cuda",
            source="ngmlr_tpu_torch/csrc/expand_votes.cu",
            replaces="ngmlr_tpu/ops/pallas_kernels.py:635", ms=ms,
            plain_ms=plain_ms, bound_ms=b, bound_by=by_, library_ms=lib_ms)
    out["max_abs_err"] = err
    return out


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


def _map(argv, device="cuda", use_cache=True, batch_reads=None):
    """Map through the port's Pipeline. Returns (pipeline, SAM bytes, setup
    s, map s, the kernel launches of this run alone)."""
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args, argv)
    if batch_reads is not None:
        cfg.batch_reads = batch_reads
    t0 = time.perf_counter()
    p = Pipeline(cfg, args.reference, use_cache=use_cache, device=device)
    t_setup = time.perf_counter() - t0
    out, t_run, launches = _run_on(p, args.query)
    return p, out, t_setup, t_run, launches


def check_launches(tag, launches, stats, mesh=False):
    """A run's launches must be the launches its engine recorded: one
    score_fill per shard of each score wave, one of each convex kernel per
    shard of each align wave, one expand_votes per row-local device-search
    launch (none in a run with the host search). Off a mesh a wave is one
    launch. Under --nosse (the context's plain_kernels) the four alignment
    kernels launch never: their plain versions run on the card."""
    plain = stats.get("plain_kernels", 0)
    want = {"score_fill": 0 if plain else stats["score_launches"]}
    for k in ("corridor_windows", "convex_fill", "convex_backtrack"):
        want[k] = 0 if plain else stats["align_launches"]
    want["expand_votes"] = stats["search_v2_launches"]
    check(launches == want, "%s: launches %s, but the engine recorded %s"
          % (tag, launches, want))
    if not mesh:
        check(stats["score_launches"] == stats["score_waves"]
              and stats["align_launches"] == stats["align_waves"],
              "%s: one device launched %d score and %d align shards for "
              "%d and %d waves" % (tag, stats["score_launches"],
                                   stats["align_launches"],
                                   stats["score_waves"], stats["align_waves"]))


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


def _env(name, value):
    """Set (value str) or unset (None) an environment variable; returns
    the old value."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    return old


def phase_goldens():
    """Returns {tag: {"map_s", "launches"}} of the nine golden runs with the
    default gate (the device candidate search, which must launch
    expand_votes) and two host-search runs (test_2 pacbio and test_4 with
    NGMLR_TPU_DEVICE_SEARCH=0)."""
    runs = {}
    host_runs = [("host search " + tag, argv, golden, mode)
                 for tag, argv, golden, mode in _golden_runs()
                 if tag in ("test_2 pacbio", "test_4")]
    for tag, argv, golden, mode in _golden_runs() + host_runs:
        ds = not tag.startswith("host search")
        old = _env("NGMLR_TPU_DEVICE_SEARCH", None if ds else "0")
        try:
            p, out, t_setup, t_run, launches = _map(argv)
        finally:
            _env("NGMLR_TPU_DEVICE_SEARCH", old)
        check((p.dev_search is not None) == ds,
              "%s: device search %s" % (tag, "off" if ds else "on"))
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
        check(not ds or launches["expand_votes"] > 0,
              "%s launched no expand_votes" % tag)
        fb = {k: v for k, v in p.ctx.stats.items()
              if k.startswith("search_fallback_")}
        check(not fb, "%s: device search fell back: %s" % (tag, fb))
        del p
    for k in KERNELS:
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


def mutate_pacbio(rng, seq, err=0.15):
    """err = 0.15: 10% insertions, 4% deletions, 1% substitutions (per input
    base: a deletion emits nothing, an insertion emits one random base
    before the original, a substitution replaces it); another err scales
    the three alike."""
    n = len(seq)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    r = rng.random(n) * (0.15 / err)
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


# the wrappers whose launch shapes and per-launch device times phase 4 logs
# under --profile: for each, the CUDA kernels one launch runs (each entry a
# kernel, or the alternatives of which the launch runs one)
PER_LAUNCH = {"corridor_windows": (("hmax_init_kernel",),
                                   ("corridor_windows_kernel",)),
              "convex_fill": (("fill_tiled", "fill_wide"),),
              "convex_backtrack": (("convex_backtrack_kernel",),)}


@contextlib.contextmanager
def recorded_shapes():
    """Stand in for the PER_LAUNCH wrappers of ngmlr_tpu_torch.ops.kernels,
    recording each call's shape ((B, TpP) or (B, TpP, L)) before calling
    the wrapper, and for convex_fill its windows and align rows, from which
    per_launch_times counts the wavefronts the launch runs once the traced
    run is over (so the trace holds no kernel of the record's). One lock
    around record and launch keeps the record in launch order: the pipeline
    launches from several threads, all on the default stream. Yields
    {wrapper: [(shape, (ymin, pk) or None), ...]}."""
    from ngmlr_tpu_torch.ops import kernels as K
    shapes = {n: [] for n in PER_LAUNCH}
    orig = {n: getattr(K, n) for n in PER_LAUNCH}
    lock = threading.Lock()

    def cw(pk, TpP):
        with lock:
            shapes["corridor_windows"].append(((pk.shape[0], TpP), None))
            return orig["corridor_windows"](pk, TpP)

    def cf(genome, readbuf, pk, params, ymin, ymax, L):
        with lock:
            shapes["convex_fill"].append((tuple(ymin.shape) + (L,),
                                          (ymin, pk)))
            return orig["convex_fill"](genome, readbuf, pk, params, ymin,
                                       ymax, L)

    def bt(dirs, ymin, pk, bx, by):
        with lock:
            shapes["convex_backtrack"].append((tuple(dirs.shape), None))
            return orig["convex_backtrack"](dirs, ymin, pk, bx, by)
    K.corridor_windows, K.convex_fill, K.convex_backtrack = cw, cf, bt
    try:
        yield shapes
    finally:
        for n, f in orig.items():
            setattr(K, n, f)


def per_launch_times(events, shapes):
    """Match each recorded launch to its kernels' device times in the
    trace (events in start order) and sum them by launch shape; a launch
    recorded with its (ymin, pk) adds its longest problem's count of ymin <
    H to its shape's wavefronts. Returns {wrapper: {"shape": {launches,
    device_ms, ms_per_launch[, wavefronts, us_per_wavefront]}}}, or a note
    where the trace and the record disagree in count."""
    import torch
    dev = sorted((e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3)
                 for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    out = {}
    for w, kernels in PER_LAUNCH.items():
        per = [[ms for _, name, ms in dev if any(k in name for k in alts)]
               for alts in kernels]
        n = len(shapes[w])
        if any(len(p) != n for p in per):
            out[w] = {"note": "%d launches recorded, kernels traced %s"
                      % (n, [len(p) for p in per])}
            continue
        groups = {}
        for i, (shape, windows) in enumerate(shapes[w]):
            g = groups.setdefault("x".join(map(str, shape)),
                                  {"launches": 0, "device_ms": 0.0})
            g["launches"] += 1
            g["device_ms"] += sum(p[i] for p in per)
            if windows is not None:
                ymin, pk = windows
                g["wavefronts"] = g.get("wavefronts", 0) + int(
                    (ymin < pk[:, 5:6]).sum(dim=1).max())
        for g in groups.values():
            g["ms_per_launch"] = g["device_ms"] / g["launches"]
            if g.get("wavefronts"):
                g["us_per_wavefront"] = g["device_ms"] * 1e3 / g["wavefronts"]
        out[w] = groups
    return out


def _profiled(fn, out_dir, shapes=None):
    """Run fn() under torch.profiler (CPU + CUDA activities). Returns
    (fn's result, {device_ms_total, per-name device ms and counts, and with
    shapes (from recorded_shapes) the per-launch times by shape}); writes
    the key_averages table into out_dir."""
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
    top = [{"name": n[:80], "device_ms": ms, "count": c}
           for n, ms, c in rows[:12]]
    log("profile: device time by name: " + json.dumps(top))
    summary = {"device_ms_total": sum(ms for _, ms, _ in rows), "top": top}
    if shapes is not None:
        summary["per_launch"] = per_launch_times(prof.events(), shapes)
        log("profile: device ms by launch shape (B x TpP [x L]): "
            + json.dumps(summary["per_launch"]))
    return r, summary


def plant_repeats(rng, genome):
    """Overwrite REPEAT_COPIES places of genome (ASCII ACGT), on a grid so no
    two overlap, with copies of one random REPEAT_LEN element (see the
    constants). Returns the copies' starts."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[bases] = np.frombuffer(b"TGCA", dtype=np.uint8)
    elem = rng.choice(bases, size=REPEAT_LEN)
    slots = rng.choice(len(genome) // REPEAT_LEN - 1, size=REPEAT_COPIES,
                       replace=False)
    starts = np.sort(slots) * REPEAT_LEN
    for s in starts:
        c = elem.copy()
        hit = rng.random(REPEAT_LEN) < REPEAT_DIV
        c[hit] = rng.choice(bases, size=int(hit.sum()))
        genome[s:s + REPEAT_LEN] = comp[c[::-1]] if rng.random() < 0.5 else c
    return starts


def make_dataset(rng, genome_mbp, n_reads, read_len, workdir, repeats=False):
    """A seeded synthetic genome and n_reads PacBio-like reads (half
    reverse-complemented) from random places, written as FASTA into
    workdir; with repeats, the genome carries the repeat family, the
    n_reads avoid its copies, and REPEAT_READS more reads, each starting
    inside a copy, go to a file of their own. Returns (ref path, reads
    path, repeat reads path or None, {read name: source position})."""
    glen = int(genome_mbp * 1e6)
    t0 = time.perf_counter()
    genome = make_genome(rng, glen)
    copies = plant_repeats(rng, genome) if repeats else None
    os.makedirs(workdir, exist_ok=True)
    ref_p = os.path.join(workdir, "ref.fa")
    reads_p = os.path.join(workdir, "reads.fa")
    write_fasta(ref_p, [(b"synth_chr1", genome.tobytes())])
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    origin = {}

    def read_at(name, pos, err):
        read = mutate_pacbio(rng, genome[pos:pos + read_len], err)
        if rng.random() < 0.5:
            read = read.translate(comp)[::-1]
        origin[name] = pos
        return name, read
    def in_repeat(pos):
        i = np.searchsorted(copies, pos + read_len)
        return i > 0 and copies[i - 1] + REPEAT_LEN > pos
    reads = []
    for i in range(n_reads):
        pos = int(rng.integers(0, glen - read_len))
        while copies is not None and in_repeat(pos):
            pos = int(rng.integers(0, glen - read_len))
        reads.append(read_at(b"read_%d_%d" % (i, pos), pos, 0.15))
    write_fasta(reads_p, reads)
    rep_p = None
    if repeats:
        rep_p = os.path.join(workdir, "repeat_reads.fa")
        starts = rng.choice(copies, size=REPEAT_READS, replace=False) \
            + rng.integers(0, REPEAT_LEN // 2, size=REPEAT_READS)
        write_fasta(rep_p, [read_at(b"repeat_read_%d_%d" % (i, pos), int(pos),
                                    0.15 if i & 1 else REPEAT_READ_ERR)
                            for i, pos in enumerate(starts)])
    log("generated %.0f Mbp genome%s + %d x %d bp reads in %.2f s"
        % (genome_mbp, " with %d repeat copies and %d reads in them"
           % (REPEAT_COPIES, REPEAT_READS) if repeats else "", n_reads,
           read_len, time.perf_counter() - t0))
    return ref_p, reads_p, rep_p, origin


def near_origin(out, origin):
    """Share of the SAM's primary records within 2 kb of their read's
    source."""
    near = n_prim = 0
    for line in out.split(b"\n"):
        if not line or line.startswith(b"@"):
            continue
        f = line.split(b"\t")
        if int(f[1]) & 0x904:
            continue
        n_prim += 1
        near += abs(int(f[3]) - 1 - origin[f[0]]) <= 2000
    return near / max(1, n_prim)


def mapping_summary(tag, genome_mbp, p, out, origin, t_setup, t_run,
                    launches, prof):
    """The numbers of one mapping run, and its checks: the native engine
    ran, the launches equal the engine's waves, no batch left the device
    search, no read failed, >= 0.95 of the reads mapped and >= 0.90 of the
    primary records lie within 2 kb of their source."""
    import torch
    st, ds = p.stats, p.ctx.stats
    mapped = st["mapped"] / max(1, st["reads"])
    summary = dict(
        genome_mbp=genome_mbp, reads=st["reads"], mapped=st["mapped"],
        setup_s=t_setup, map_s=t_run, reads_per_s=st["reads"] / t_run,
        primary_near_origin=near_origin(out, origin),
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
    summary["search_v2_retry"] = 0
    summary.update({k: v for k, v in ds.items() if k.startswith("search_")})
    if prof is not None:
        # device busy share of the map: summed device time of every
        # kernel and copy over the map's wall time
        summary["profile"] = prof
        summary["device_busy_share"] = prof["device_ms_total"] / (t_run * 1e3)
    log("%s: %s" % (tag, json.dumps(summary)))
    check(summary["engine_waves"] > 0, "%s: the native engine ran no wave"
          % tag)
    check_launches(tag, launches, ds)
    fb = [k for k in ds if k.startswith("search_fallback_")]
    check(not fb, "%s: the device search handed batches back: %s"
          % (tag, fb))
    check(summary["native_failed"] == 0, "%s: native engine reads failed"
          % tag)
    check(mapped >= 0.95, "%s: only %.3f of the reads mapped" % (tag, mapped))
    check(summary["primary_near_origin"] >= 0.9,
          "%s: only %.3f of the primary records lie near their source"
          % (tag, summary["primary_near_origin"]))
    return summary


def _pipeline(ref_p, reads_p, device="cuda"):
    """A Pipeline on the card (or a mesh of cards) with the default search
    gate (the variable unset), timed. Returns (pipeline, setup s)."""
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    argv = ["-r", ref_p, "-q", reads_p]
    args = build_parser().parse_args(argv)
    old = _env("NGMLR_TPU_DEVICE_SEARCH", None)
    try:
        t0 = time.perf_counter()
        p = Pipeline(config_from_args(args, argv), ref_p, use_cache=False,
                     device=device)
        return p, time.perf_counter() - t0
    finally:
        _env("NGMLR_TPU_DEVICE_SEARCH", old)


def _run_on(p, reads_p):
    """Map reads_p through p with the launch counters set to 0 just before.
    Returns (SAM bytes, map s, the kernel launches of this run alone)."""
    import torch
    from ngmlr_tpu_torch.ops import kernels as K
    buf = io.BytesIO()
    K.reset_launches()
    t0 = time.perf_counter()
    p.run(reads_p, buf)
    if p.ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0, dict(K.launches)


def _run_counted(tag, p, reads_p):
    """_run_on, plus the run's own stats (the context's counters after it
    less before it); on the card its launches must equal its own waves
    (on the CPU the wrappers run their plain versions and launch none),
    and no batch may have left the device search. Returns (SAM, map s,
    launches, stats)."""
    before = dict(p.ctx.stats)
    p.stats = {"reads": 0, "mapped": 0, "unmapped": 0}
    out, t_run, launches = _run_on(p, reads_p)
    delta = {k: v - before.get(k, 0) for k, v in p.ctx.stats.items()
             if isinstance(v, (int, float)) and v != before.get(k, 0)}
    if p.ctx.device.type == "cuda":
        check_launches(tag, launches, {
            "score_waves": 0, "align_waves": 0, "score_launches": 0,
            "align_launches": 0, "search_v2_launches": 0, **delta})
    else:
        check(not any(launches.values()), "%s: kernels launched on the "
              "CPU: %s" % (tag, launches))
    fb = [k for k in delta if k.startswith("search_fallback_")]
    check(not fb, "%s: the device search handed batches back: %s"
          % (tag, fb))
    return out, t_run, launches, delta


@contextlib.contextmanager
def other_search(p):
    """p with the other candidate search inside the block: the host search
    where the gate chose the device search, else a DeviceSearch built now.
    Yields (its search, the DeviceSearch's build s or None)."""
    import torch
    from ngmlr_tpu_torch.seed.device_search import DeviceSearch
    first = p.dev_search
    build_s = None
    if first is None:
        t0 = time.perf_counter()
        p.dev_search = DeviceSearch(p.index, device=p.ctx.device)
        if p.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    else:
        p.dev_search = None
    try:
        yield ("host" if first is not None else "device"), build_s
    finally:
        p.dev_search = first


def other_search_run(tag, p, reads_p, out, dataset=None):
    """Map the same reads again on the same Pipeline (index built once) with
    the other candidate search (other_search; a DeviceSearch's build time is
    what the device search adds to setup). Its SAM must equal the first
    run's, byte for byte, and, given a dataset, the JAX package's digests
    (hold_to_jax). Returns its numbers."""
    with other_search(p) as (search, build_s):
        other, t_run, launches, delta = _run_counted(
            "%s, %s search" % (tag, search), p, reads_p)
    rec = dict(search=search, device_search_build_s=build_s, map_s=t_run,
               reads_per_s=p.stats["reads"] / t_run,
               sam_identical=other == out, launches=launches, stats=delta)
    log("%s, %s search on the same Pipeline: %s" % (tag, search,
                                                   json.dumps(rec)))
    check(rec["sam_identical"], "%s: the %s-search SAM differs"
          % (tag, search))
    if dataset:
        rec["jax"] = hold_to_jax("%s, %s search" % (tag, search), dataset,
                                 other, reads_p)
    return rec


def _script(name):
    """scripts/<name>.py as a module (the scripts import this one: main
    registers it as chip_smoke, so they find it rather than load a second
    copy)."""
    import importlib
    if os.path.join(HERE, "scripts") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "scripts"))
    return importlib.import_module(name)


def hold_to_jax(tag, dataset, sam, reads_p):
    """A SAM of the port held to the JAX package's digests of dataset
    (scripts/torch_scale_vs_jax.py, tests/golden/torch_scale): every read's
    records and the whole file after @PG. Returns the counts."""
    S = _script("torch_scale_vs_jax")
    want = S.load_digests()[dataset]
    sam = S.fuzz.strip_pg(sam)
    held = S.hold(want, sam, S.read_names(reads_p))
    rec = {"dataset": dataset, "reads": held["reads"],
           "identical": held["identical"], "diff": len(held["diff"]),
           "file_identical": held["file_identical"]}
    log("%s against the JAX package's %s digests: %s"
        % (tag, dataset, json.dumps(rec)))
    if held["diff"]:
        log(S.diff_text(dataset, want, sam, held["diff"]).rstrip())
    check(not held["diff"] and held["file_identical"],
          "%s: %d reads differ from the JAX package's, file identical %s"
          % (tag, len(held["diff"]), held["file_identical"]))
    return rec


def phase_mapping(genome_mbp, n_reads, read_len, workdir, profile_dir=None):
    """Phase 4: one chromosome with the default gate (the device search),
    then again with the host search on the same Pipeline. Returns (its
    numbers, (ref path, reads path, the device-search SAM))."""
    import torch
    ref_p, reads_p, _, origin = make_dataset(
        np.random.default_rng(MAPPING_SEED), genome_mbp, n_reads, read_len,
        workdir)
    torch.cuda.reset_peak_memory_stats()
    p, t_setup = _pipeline(ref_p, reads_p)
    check(p.dev_search is not None, "the gate left the device search off")
    if profile_dir:
        with recorded_shapes() as shapes:
            (out, t_run, launches), prof = _profiled(
                lambda: _run_on(p, reads_p), profile_dir, shapes)
    else:
        (out, t_run, launches), prof = _run_on(p, reads_p), None
    summary = mapping_summary("mapping", genome_mbp, p, out, origin,
                              t_setup, t_run, launches, prof)
    for name in KERNELS:
        check(launches[name] > 0,
              "kernel %s was not launched on the main path" % name)
    summary["jax"] = hold_to_jax("mapping", "phase4", out, reads_p)
    summary["host_search"] = other_search_run("mapping", p, reads_p, out,
                                              "phase4")
    return summary, (ref_p, reads_p, out)


def first_batch_views(p, reads_p):
    """The first intake batch as the runner's prepare stage lays it out:
    (read buffer on the card, subread starts, lengths, sequences)."""
    from ngmlr_tpu_torch.io.reads import read_batches
    from ngmlr_tpu_torch.io.reference import _CHAR2CODE
    rpl = p.cfg.read_part_length
    batch = next(read_batches(reads_p, p.cfg.batch_reads))
    reads = [r for r in batch if not r.empty]
    buf = np.concatenate([_CHAR2CODE[np.frombuffer(r.seq, dtype=np.uint8)]
                          for r in reads])
    readbuf = p.ctx.upload_reads(buf).primary
    starts, lens, seqs = [], [], []
    off = 0
    for r in reads:
        n = r.subread_count(rpl)
        parts = [(0, r.seq)] if n == 0 else \
            [(j * rpl, r.subread_seq(j, rpl)) for j in range(n)]
        for o, sq in parts:
            starts.append(off + o)
            lens.append(len(sq))
            seqs.append(sq)
        off += len(r.seq)
    return (readbuf, np.asarray(starts, np.int32), np.asarray(lens, np.int32),
            seqs)


def check_first_batch(tag, p, reads_p):
    """The first intake batch of reads_p through the device search and the
    host search_batch: the same candidates, subread by subread."""
    from ngmlr_tpu_torch.seed.candidates import search_batch
    readbuf, starts, lens, seqs = first_batch_views(p, reads_p)
    cfg = p.cfg
    got = p.dev_search.search_views(readbuf, starts, lens, cfg.sensitivity,
                                    cfg.min_kmer_hits)
    want = search_batch(p.index, seqs, cfg.sensitivity, cfg.min_kmer_hits)
    check(len(got) == len(want), "%s: the device search returned %d "
          "subreads of %d" % (tag, len(got), len(want)))
    bad = [i for i, (a, b) in enumerate(zip(want, got))
           if not (np.array_equal(a.locations, b.locations)
                   and np.array_equal(a.reverse, b.reverse)
                   and np.array_equal(a.counts, b.counts)
                   and a.mq_zero == b.mq_zero)]
    n_cand = sum(len(c.locations) for c in want)
    log("%s, first batch: %d subreads, %d candidates, %d differ from the "
        "host search_batch" % (tag, len(want), n_cand, len(bad)))
    check(not bad, "%s, first batch: subreads %s differ" % (tag, bad[:5]))
    return dict(subreads=len(want), candidates=n_cand, differ=len(bad))


def phase_large_genome(genome_mbp, n_reads, read_len, workdir,
                       profile_dir=None):
    """Phase 5: a chromosome-1-sized genome with a repeat family. Its 256
    reads map with the default gate (the device search), then with the host
    search on the same Pipeline; then the repeat reads the same two ways,
    whose subreads in copies run the search's v1 path on the card. Each
    pair of SAMs must be equal, and each file's first batch of candidates
    equal to the host search_batch."""
    import torch
    ref_p, reads_p, rep_p, origin = make_dataset(
        np.random.default_rng(LARGE_SEED), genome_mbp, n_reads, read_len,
        workdir, repeats=True)
    torch.cuda.reset_peak_memory_stats()
    p, t_setup = _pipeline(ref_p, reads_p)
    check(p.dev_search is not None, "the gate left the device search off")
    resident = {"bucket_pairs": p.dev_search.bucket_pairs.nbytes,
                "positions": p.dev_search.positions.nbytes,
                "genome": p.ctx.genome.nbytes}
    log("large genome: setup %.2f s, resident on the card %s"
        % (t_setup, json.dumps(resident)))
    if profile_dir:
        (out, t_run, launches), prof = _profiled(
            lambda: _run_on(p, reads_p), profile_dir)
    else:
        (out, t_run, launches), prof = _run_on(p, reads_p), None
    summary = mapping_summary("large genome", genome_mbp, p, out, origin,
                              t_setup, t_run, launches, prof)
    summary["resident_bytes"] = resident
    for name in KERNELS:
        check(launches[name] > 0,
              "kernel %s was not launched on the large-genome path" % name)
    summary["jax"] = hold_to_jax("large genome", "phase5", out, reads_p)
    summary["host_search"] = other_search_run("large genome", p, reads_p, out,
                                              "phase5")

    # the repeat reads: v2 launch shapes, outliers and reruns on the card
    rep_out, rep_s, rep_launches, st = _run_counted("repeat reads", p, rep_p)
    classes = {k[len("search_v2_class_"):]: v for k, v in st.items()
               if k.startswith("search_v2_class_")}
    rep = dict(reads=p.stats["reads"], mapped=p.stats["mapped"],
               map_s=rep_s, reads_per_s=p.stats["reads"] / rep_s,
               primary_near_origin=near_origin(rep_out, origin),
               v2_launches_by_BxL=classes, launches=rep_launches, stats=st)
    log("repeat reads, device search: %s" % json.dumps(rep))
    log("repeat reads: %d outlier subreads and %d v2 rows rerun through v1 "
        "(%d v1 launches, %d v1 reruns) on the card"
        % (st.get("search_v1_outliers", 0), st.get("search_v2_retry", 0),
           st.get("search_v1_launches", 0), st.get("search_v1_rerun", 0)))
    check(st.get("search_v1_outliers", 0) > 0
          and st.get("search_v2_retry", 0) > 0,
          "the repeat reads missed the v1 search or v2's reruns")
    rep["jax"] = hold_to_jax("repeat reads", "phase5_repeats", rep_out,
                             rep_p)
    rep["host_search"] = other_search_run("repeat reads", p, rep_p, rep_out,
                                          "phase5_repeats")
    summary["repeat_reads"] = rep
    summary["first_batch"] = check_first_batch("large genome", p, reads_p)
    rep["first_batch"] = check_first_batch("repeat reads", p, rep_p)
    return summary


# ---------------------------------------------------------------------------
# phase 6: scale-out and the debug surface
# ---------------------------------------------------------------------------

# the reference binary's --stdout dumps in tests/golden/dumps
DUMP_RUNS = ([("test_2", m) for m in (1, 3, 5, 7)]
             + [("test_4", m) for m in (2, 3, 4, 5, 6)])
DUMP_DATA = {
    "test_2": ("test_2/ref_chr21_20kb.fa", "test_2/reads_100_2200bp.fa"),
    "test_4": ("test_4/reference.fasta.gz", "test_4/read.fa.gz")}
SCALE_KEYS = ("score_waves", "score_launches", "align_waves",
              "align_launches", "search_v2_launches")
# one CLI process (of a multi-process run, or a dump that must start from
# a fresh process: --stdout 6 numbers its alignments from 0 in a process):
# cli.main, then the process's kernel launches and the engine's counts on
# stderr
CLI_COUNTED = """
import json, sys
sys.path.insert(0, %r)
from ngmlr_tpu_torch import cli
from ngmlr_tpu_torch.ops import device_engine, kernels as K
rc = cli.main(sys.argv[1:])
st = device_engine.current().stats
sys.stderr.write("SMOKE_COUNTS %%s\\n" %% json.dumps(
    {"launches": K.launches, "stats": {k: st[k] for k in %r}}))
sys.exit(rc)
""" % (HERE, SCALE_KEYS + ("plain_kernels",))


def _data_argv(name):
    ref, qry = (os.path.join(DATA, p) for p in DUMP_DATA[name])
    return ["-r", ref, "-q", qry, "-x", "pacbio", "--no-progress"]


def cli_run(tag, argv, dev):
    """The port's CLI (cli.main) in this process on dev, its standard
    output captured and its launch counters set to 0 just before and
    checked just after. Returns (stdout bytes, wall s)."""
    import torch
    from ngmlr_tpu_torch import cli
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.ops import kernels as K
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", newline="\n",
                           write_through=True)
    # --nosse sets NGMLR_TPU_NO_PALLAS for the process: undone after
    old = [_env("NGMLR_TPU_STRICT", "1"), _env("NGMLR_TORCH_DEVICE", dev),
           _env("NGMLR_TPU_NO_PALLAS", None)]
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        _env("NGMLR_TPU_STRICT", old[0])
        _env("NGMLR_TORCH_DEVICE", old[1])
        _env("NGMLR_TPU_NO_PALLAS", old[2])
    wall = time.perf_counter() - t0
    out.flush()
    check(rc == 0, "%s: the CLI returned %s" % (tag, rc))
    check_launches(tag, dict(K.launches), device_engine.current().stats)
    return buf.getvalue(), wall


@contextlib.contextmanager
def counted_problems(ctx):
    """Counts on the host, before the engine splits them over the shards,
    the real problems (qlen > 0) of the score and align rows handed to
    ctx's wave dispatch (the lane-bound retry included), summed into the
    yielded list after the block."""
    sd, ad = ctx.score_dispatch_np, ctx.align_dispatch_pk
    counts = []

    def score_dispatch_np(pk, *a, **kw):
        counts.append(int(np.count_nonzero(np.asarray(pk)[:, 5] > 0)))
        return sd(pk, *a, **kw)

    def align_dispatch_pk(pk_all, *a, **kw):
        counts.append(int(np.count_nonzero(np.asarray(pk_all)[:, 5] > 0)))
        return ad(pk_all, *a, **kw)
    ctx.score_dispatch_np, ctx.align_dispatch_pk = (score_dispatch_np,
                                                    align_dispatch_pk)
    total = []
    try:
        yield total
    finally:
        del ctx.score_dispatch_np, ctx.align_dispatch_pk
        total.append(sum(counts))


def _merge_sams(out, shards):
    r = subprocess.run([sys.executable,
                        os.path.join(HERE, "scripts", "merge_sams.py"), out]
                       + shards, capture_output=True, timeout=120)
    check(r.returncode == 0, "merge_sams.py failed: %s" % r.stderr[-500:])
    with open(out, "rb") as f:
        return f.read()


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def start_cli(argv, dev, stdout=subprocess.PIPE, **env):
    """The port's CLI (CLI_COUNTED) in a process of its own on dev under
    NGMLR_TPU_STRICT=1, with the extra environment env. Returns the
    process; its counts come back through cli_counts."""
    env = dict(os.environ, NGMLR_TORCH_DEVICE=dev, NGMLR_TPU_STRICT="1",
               **env)
    env.pop("NGMLR_TPU_NO_PALLAS", None)   # only the CLI's flag sets it
    return subprocess.Popen([sys.executable, "-c", CLI_COUNTED] + argv,
                            cwd=HERE, env=env, stdout=stdout,
                            stderr=subprocess.PIPE)


def cli_counts(tag, proc, err):
    """Check a finished start_cli process: its exit code, and its launches
    against its engine's counts. Returns the counts."""
    err = err.decode(errors="replace")
    check(proc.returncode == 0, "%s failed: %s" % (tag, err[-1500:]))
    line = [l for l in err.splitlines() if l.startswith("SMOKE_COUNTS ")]
    check(line, "%s reported no counts" % tag)
    counts = json.loads(line[-1][len("SMOKE_COUNTS "):])
    check_launches(tag, counts["launches"], counts["stats"])
    return counts


def start_two_processes(workdir, dev):
    """Two CLI processes on the card under one coordinator (gloo on a free
    localhost port), each mapping its round-robin half of test_2 by
    NGMLR_TPU_PROC_ID. Returns [(process, SAM path)]."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        sam = os.path.join(workdir, "proc%d.sam" % pid)
        procs.append((start_cli(
            _data_argv("test_2") + ["-o", sam], dev, subprocess.DEVNULL,
            NGMLR_TPU_COORDINATOR="127.0.0.1:%d" % port,
            NGMLR_TPU_NUM_PROCS="2", NGMLR_TPU_PROC_ID=str(pid)), sam))
    return procs


def finish_two_processes(procs, single, workdir):
    """Wait for the two processes (the caller kills them on any failure),
    check each one's launches against its engine's counts, and merge their
    SAMs: the merge must equal the single run."""
    for pid, (p, _) in enumerate(procs):
        cli_counts("process %d of 2" % pid, p, p.communicate(timeout=300)[1])
    merged = _merge_sams(os.path.join(workdir, "procs_merged.sam"),
                         [sam for _, sam in procs])
    check(_records(merged) == _records(single),
          "two processes, merged, differ from the single run")
    return len(_records(merged))


def mesh_run(tag, devices, ref_p, reads_p, want):
    """Phase 4's files through a Pipeline on the mesh `devices` (native
    engine, device search on the primary card): the SAM must equal phase
    4's, every kernel launch must be one the engine recorded, at least one
    wave must have split over the shards, and mesh_problems_psum must equal
    the real problems handed to the waves, counted before the split."""
    p, t_setup = _pipeline(ref_p, reads_p, device=devices)
    check(p.ctx.devices == devices and p.dev_search is not None,
          "%s: the mesh or the device search is missing" % tag)
    with counted_problems(p.ctx) as real:
        out, t_run, launches = _run_on(p, reads_p)
    st = p.ctx.stats
    rec = dict(devices=[str(d) for d in devices], reads=p.stats["reads"],
               setup_s=t_setup, map_s=t_run,
               reads_per_s=p.stats["reads"] / t_run,
               mesh_problems_psum=st.get("mesh_problems_psum", 0),
               real_problems=real[0], launches=launches,
               sam_identical=out == want,
               **{k: st[k] for k in SCALE_KEYS})
    log("%s: %s" % (tag, json.dumps(rec)))
    check(rec["sam_identical"], "%s: the SAM differs from phase 4's" % tag)
    check_launches(tag, launches, st, mesh=True)
    check(st["score_launches"] > st["score_waves"]
          and st["align_launches"] > st["align_waves"],
          "%s: no wave split over the shards" % tag)
    check(rec["mesh_problems_psum"] == real[0],
          "%s: mesh_problems_psum %d, but the waves were handed %d real "
          "problems" % (tag, rec["mesh_problems_psum"], real[0]))
    return rec


def phase_scaleout(main_path, workdir, dev="cuda"):
    """Phase 6: the --stdout dumps, serial mode, --shard with the merge and
    a two-process run through the CLI on the card, then phase 4's mapping
    on a mesh of two shards sharing cuda:0 (and over every card where
    there are more)."""
    import torch
    os.makedirs(workdir, exist_ok=True)
    rec = {}
    procs = start_two_processes(workdir, dev)
    try:
        runs = {}
        for name, mode in DUMP_RUNS:
            tag = "%s --stdout %d" % (name, mode)
            got, wall = cli_run(tag, _data_argv(name)
                                + ["--stdout", str(mode), "-o", os.devnull],
                                dev)
            with gzip.open(os.path.join(GOLDEN, "dumps", "%s_stdout%d.txt.gz"
                                        % (name, mode)), "rb") as f:
                same = got == f.read()
            runs[tag] = {"wall_s": wall, "bytes": len(got), "same": same}
            log("%s: %s (%d bytes, %.2f s)" % (
                tag, "BYTE-IDENTICAL" if same else "DIFFERS", len(got), wall))
        rec["dumps"] = runs
        check(all(r["same"] for r in runs.values()),
              "dumps differ: %s" % [t for t, r in runs.items()
                                    if not r["same"]])

        serial = {}
        for sync in ("1", None):
            old = [_env("NGMLR_TPU_SYNC", sync), _env("NGMLR_TPU_STRICT", "1")]
            try:
                p, out, _, t_run, launches = _map(_data_argv("test_2"), dev,
                                                  batch_reads=4)
            finally:
                _env("NGMLR_TPU_SYNC", old[0])
                _env("NGMLR_TPU_STRICT", old[1])
            tag = "test_2 %s, 4-read batches" % ("serial" if sync
                                                 else "pipelined")
            check_launches(tag, launches, p.ctx.stats)
            serial[tag] = (out, t_run)
            log("%s: map %.2f s, launches %s" % (tag, t_run,
                                                  json.dumps(launches)))
        (s_out, s_t), (p_out, p_t) = serial.values()
        rec["serial"] = {"serial_map_s": s_t, "pipelined_map_s": p_t,
                         "same": _records(s_out) == _records(p_out)}
        check(rec["serial"]["same"], "serial mode differs from pipelined")

        t6 = ["-r", os.path.join(DATA, "test_6/reference.fasta.gz"),
              "-q", os.path.join(DATA, "test_6/read.fa.gz"), "-x", "pacbio",
              "--no-progress"]
        shard = {}
        for part in ("full", "0/2", "1/2"):
            sam = os.path.join(workdir,
                               "test6_%s.sam" % part.replace("/", "of"))
            extra = [] if part == "full" else ["--shard", part]
            _, shard[part] = cli_run("test_6 " + part, t6 + extra
                                     + ["-o", sam], dev)
            shard[part + " sam"] = sam
        merged = _merge_sams(os.path.join(workdir, "test6_merged.sam"),
                             [shard["0/2 sam"], shard["1/2 sam"]])
        with open(shard["full sam"], "rb") as f:
            full = f.read()
        rec["shards"] = {"wall_s": {k: v for k, v in shard.items()
                                    if not k.endswith(" sam")},
                         "same": _records(merged) == _records(full),
                         "golden": _records(full) == _records(
                             _golden("test_6.sam"))}
        log("test_6 --shard 0/2 + 1/2, merged: %s" % json.dumps(rec["shards"]))
        check(rec["shards"]["same"] and rec["shards"]["golden"],
              "test_6: the merged shards differ from the full run or the "
              "golden")

        single_p = os.path.join(workdir, "test2_single.sam")
        _, single_s = cli_run("test_2 single", _data_argv("test_2")
                              + ["-o", single_p], dev)
        with open(single_p, "rb") as f:
            single = f.read()
        check(_records(single) == _records(_golden("test_2.sam")),
              "test_2 through the CLI differs from the golden")
        n = finish_two_processes(procs, single, workdir)
        rec["two_processes"] = {"records": n, "single_wall_s": single_s}
        log("two processes on the card, merged: equal to the single run "
            "(%d records)" % n)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    ref_p, reads_p, want = main_path
    mesh = [torch.device("cuda", 0) if dev == "cuda"
            else torch.device(dev)] * 2
    rec["mesh"] = mesh_run("mesh of 2 shards on cuda:0", mesh, ref_p,
                           reads_p, want)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        rec["every_card"] = mesh_run("mesh over %d cards" % n_cards, cards,
                                     ref_p, reads_p, want)
    else:
        log("one visible card: the mesh over every card is not run")
    return rec


# ---------------------------------------------------------------------------
# phase 7: genomes of several units (the TableUnit analog, at shrunken slabs)
# ---------------------------------------------------------------------------

# (a) the case of tests/test_table_units.py:69: 3 units of 2^22 bases
UNIT_SMALL_BITS = 22
UNIT_SMALL_READS = 14
# (b) phase 4's genome and reads, the genome in 6 units of 2^23 bases
# (8 Mbp, a 1 Mbp halo)
UNIT_MAIN_BITS = 23


def table_unit_files(workdir):
    """The files of tests/test_table_units.py:69 (its _write_fasta and
    _make_reads, seed 31): two 5 Mbp chromosomes and 14 reads of 400-2000
    bp at ~5% substitutions, half reverse-complemented. Returns (ref path,
    reads path)."""
    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    os.makedirs(workdir, exist_ok=True)
    ref_p = os.path.join(workdir, "multi.fa")
    reads_p = os.path.join(workdir, "reads.fa")
    chroms = []
    with open(ref_p, "wb") as f:
        for c in range(2):
            seq = bases[rng.integers(0, 4, size=5_000_000)]
            chroms.append(seq)
            f.write(b">chr%d\n" % (c + 1))
            g = seq.tobytes()
            for i in range(0, len(g), 80):
                f.write(g[i:i + 80] + b"\n")
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    with open(reads_p, "wb") as f:
        for i in range(UNIT_SMALL_READS):
            c = int(rng.integers(0, len(chroms)))
            n = int(rng.integers(400, 2000))
            pos = int(rng.integers(0, len(chroms[c]) - n))
            s = bytearray(chroms[c][pos:pos + n].tobytes())
            for _ in range(n // 20):
                s[int(rng.integers(0, n))] = b"ACGT"[int(rng.integers(0, 4))]
            s = bytes(s)
            if rng.random() < 0.5:
                s = s.translate(comp)[::-1]
            f.write(b">r%d_c%d_%d\n%s\n" % (i, c, pos, s))
    return ref_p, reads_p


def unit_map(tag, ref_p, reads_p, slab_bits):
    """Map reads_p through a Pipeline on the card with
    NGMLR_TPU_UNIT_SLAB_BITS = slab_bits (None: the default, one unit) and
    NGMLR_TPU_STRICT=1, the launch counters set to 0 just before the map
    and checked just after. A genome of several units must take the host
    search and the Python assembly path and launch no expand_votes.
    Returns (pipeline, SAM, setup s, map s, launches)."""
    old = [_env("NGMLR_TPU_UNIT_SLAB_BITS",
                None if slab_bits is None else str(slab_bits)),
           _env("NGMLR_TPU_STRICT", "1")]
    try:
        p, t_setup = _pipeline(ref_p, reads_p)
        out, t_run, launches = _run_on(p, reads_p)
    finally:
        _env("NGMLR_TPU_UNIT_SLAB_BITS", old[0])
        _env("NGMLR_TPU_STRICT", old[1])
    check_launches(tag, launches, p.ctx.stats)
    if slab_bits is not None:
        check(p.ref.n_units > 1 and p.ctx.n_units == p.ref.n_units
              and p.ctx.genome.dim() == 2,
              "%s: %d units on the host, genome of %d dims on the card"
              % (tag, p.ref.n_units, p.ctx.genome.dim()))
        check(p.native is None and p.dev_search is None,
              "%s: the native engine or the device search is on" % tag)
        check(launches["expand_votes"] == 0 and launches["score_fill"] > 0
              and launches["convex_fill"] > 0,
              "%s: launches %s" % (tag, launches))
    log("%s: %d units, %d of %d reads mapped, setup %.2f s, map %.2f s, "
        "launches %s" % (tag, p.ref.n_units, p.stats["mapped"],
                         p.stats["reads"], t_setup, t_run,
                         json.dumps(launches)))
    return p, out, t_setup, t_run, launches


def phase_table_units(main_path, workdir):
    """Phase 7: (a) the case of tests/test_table_units.py:69 on the card,
    its 3-unit SAM equal to its flat SAM; (b) phase 4's genome in 6 units
    and its reads, the SAM equal to phase 4's (flat, native engine)."""
    rec = {}
    ref_p, reads_p = table_unit_files(workdir)
    _, flat, _, _, _ = unit_map("units (a) flat", ref_p, reads_p, None)
    p, multi, t_setup, t_run, launches = unit_map(
        "units (a)", ref_p, reads_p, UNIT_SMALL_BITS)
    rec["small"] = dict(units=p.ref.n_units, reads=p.stats["reads"],
                        mapped=p.stats["mapped"], setup_s=t_setup,
                        map_s=t_run, launches=launches,
                        sam_identical=_records(multi) == _records(flat))
    check(p.ref.n_units == 3, "units (a): %d units, not 3" % p.ref.n_units)
    check(p.stats["mapped"] == UNIT_SMALL_READS,
          "units (a): %d of %d reads mapped" % (p.stats["mapped"],
                                                UNIT_SMALL_READS))
    check(rec["small"]["sam_identical"],
          "units (a): the 3-unit SAM differs from the flat SAM")
    del p

    ref_p, reads_p, want = main_path
    p, out, t_setup, t_run, launches = unit_map(
        "units (b)", ref_p, reads_p, UNIT_MAIN_BITS)
    planes = p.ctx.genome
    rec["main"] = dict(units=p.ref.n_units, reads=p.stats["reads"],
                       mapped=p.stats["mapped"], setup_s=t_setup,
                       map_s=t_run, reads_per_s=p.stats["reads"] / t_run,
                       planes_shape=list(planes.shape),
                       planes_bytes=planes.nbytes, launches=launches,
                       score_waves=p.ctx.stats["score_waves"],
                       align_waves=p.ctx.stats["align_waves"],
                       sam_identical=_records(out) == _records(want))
    log("units (b): %s" % json.dumps(rec["main"]))
    check(p.ref.n_units == 6, "units (b): %d units, not 6" % p.ref.n_units)
    check(rec["main"]["sam_identical"],
          "units (b): the 6-unit SAM differs from phase 4's")
    # the planes a real genome would need at the default 2^31 slab, as
    # ReferenceGenome and DeviceContext size them (reckoned, not allocated)
    from ngmlr_tpu_torch.ops.device_engine import _size_class
    slab = 1 << 31
    n = 4_600_000_000
    rec["real_4g6_planes"] = dict(
        units=-(-n // slab), plane_bytes=_size_class(
            min(slab + min(1 << 24, max(1 << 20, slab >> 3)), n) + 8,
            1 << 20))
    log("a 4.6 Gbp genome at the 2^31 slab: %d planes of %d B a replica "
        "(reckoned)" % (rec["real_4g6_planes"]["units"],
                        rec["real_4g6_planes"]["plane_bytes"]))
    return rec


# ---------------------------------------------------------------------------
# phase 8: --nosse on the card and the oracles (ops/convex.py,
# ops/ungapped.py, ops/convex_ref.py)
# ---------------------------------------------------------------------------

# (a) phase 4's genome mapped both ways with its first NOSSE_READS reads:
# the plain convex_fill runs a Python loop of tensor steps a wavefront
NOSSE_READS = 8
# (c) the candidate scorer's hot shape: 306-base windows, 256-base subreads
SCORE_PAIRS = 256


def rand_seq(rng, n):
    """tests/test_convex.py's _rand_seq."""
    return bytes(rng.choice(list(b"ACGT"), size=n).astype(np.uint8))


def mutate_seq(rng, seq, sub=0.05, ins=0.03, dele=0.03):
    """tests/test_convex.py's _mutate."""
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.choice(list(b"ACGT")))
        if r < dele + ins + sub:
            out.append(rng.choice(list(b"ACGT")))
        else:
            out.append(c)
    return bytes(out)


def fill_cases():
    """The 12 seeded band problems of tests/test_convex.py:52: (ref, qry,
    per-row offsets, width)."""
    rng = np.random.default_rng(11)
    cases = []
    for _ in range(12):
        H = int(rng.integers(4, 60))
        W = int(rng.integers(4, 80))
        ref = rand_seq(rng, W)
        qry = rand_seq(rng, H)
        width = int(rng.integers(3, 25))
        base = rng.integers(-5, 5)
        offs = (np.arange(H) * float(rng.choice([0.5, 1.0, 1.7]))
                ).astype(np.int64) + base
        cases.append((ref, qry, offs, width))
    return cases


def align_cases():
    """The 10 seeded problems of tests/test_convex.py:75: (ref, qry, linear
    corridor width), the query a mutated copy of the middle of ref."""
    rng = np.random.default_rng(123)
    cases = []
    for _ in range(10):
        truth = rand_seq(rng, int(rng.integers(60, 400)))
        qry = mutate_seq(rng, truth)
        pad = int(rng.integers(5, 60))
        ref = rand_seq(rng, pad) + truth + rand_seq(rng, pad)
        cases.append((ref, qry, int(rng.choice([32, 64, 128]))))
    return cases


def oracle_views(ref, qry, device):
    """tests/test_convex.py's _setup on `device`: a DeviceContext whose
    genome is ref and whose read buffer is qry, made current. Returns
    (reference window, query view)."""
    from ngmlr_tpu_torch.align.aligner import RefWin
    from ngmlr_tpu_torch.io.reads import Read, SeqView
    from ngmlr_tpu_torch.io.reference import _CHAR2CODE
    from ngmlr_tpu_torch.ops import device_engine as de

    def codes(b):
        return _CHAR2CODE[np.frombuffer(b, dtype=np.uint8)]
    ctx = de.DeviceContext(codes(ref), device=device)
    ctx.upload_reads(codes(qry))
    de.set_current(ctx)
    read = Read(0, b"r", qry, None)
    read.buf_offset = 0
    return (RefWin(de.RefDesc(0, 0, len(ref), len(ref)), ref),
            SeqView(read, 0, len(qry), False))


def fill_diffs(ref, qry, offs, width, device):
    """run_batch on `device` against fill_matrix: the best score (to f32
    rounding, as tests/test_convex.py:66 holds it), the best cell where the
    score is positive, and every direction in the band. Returns (the
    result, [what differs])."""
    from ngmlr_tpu_torch.ops.convex import BandSpec, run_batch
    from ngmlr_tpu_torch.ops.convex_ref import fill_matrix
    bs, bx, by, dirs = fill_matrix(ref, qry, offs, width)
    res = run_batch([BandSpec(ref, qry, offs, width)], device=device)[0]
    diffs = []
    if abs(res.score - bs) > 1e-6 * abs(bs):
        diffs.append("score %r, fill_matrix %r" % (res.score, bs))
    if bs > 0 and (res.best_x, res.best_y) != (bx, by):
        diffs.append("best cell %s, fill_matrix %s"
                     % ((res.best_x, res.best_y), (bx, by)))
    for y in range(len(qry)):
        for x in range(max(0, int(offs[y])),
                       min(len(ref), int(offs[y]) + width)):
            if res.dir_at(x, y) != dirs[y, x]:
                diffs.append("direction at %s" % ((x, y),))
    return res, diffs


def align_diffs(ref, qry, corridor_width, device):
    """tests/test_convex.py:75 on `device`: align_banded through the
    current DeviceContext (the kernels on the card, their plain versions
    on the CPU) against run_batch + the host backtrack + convert_cigar.
    Returns [what differs]."""
    from ngmlr_tpu_torch.align.aligner import (align_banded, corridor_linear,
                                               materialize_offsets)
    from ngmlr_tpu_torch.align.cigar import backtrack, convert_cigar
    from ngmlr_tpu_torch.ops.convex import BandSpec, run_batch
    ref_win, view = oracle_views(ref, qry, device)
    c = corridor_linear(corridor_width)
    a_dev = align_banded(ref_win, view, c, 2, 4)
    offs = materialize_offsets(c, len(qry))
    res = run_batch([BandSpec(ref, qry, offs, c.width)], device=device)[0]
    bt = backtrack(res, offs, c.width, len(qry))
    if bt is None or a_dev is None:
        return [] if bt is None and a_dev is None else [
            "engine %s, oracle %s" % (a_dev is not None, bt is not None)]
    ops, ref_position, _ = bt
    a_host, host_len = convert_cigar(ops, ref, ref_position, qry, 2, 4)
    diffs = [k for k in ("cigar", "md", "nm", "qstart", "qend",
                         "position_offset")
             if getattr(a_dev, k) != getattr(a_host, k)]
    if a_dev.score != res.score:
        diffs.append("score")
    if a_dev._final_cigar_length != host_len:
        diffs.append("final cigar length")
    if not np.array_equal(a_dev.nm_per_position, a_host.nm_per_position):
        diffs.append("nm_per_position")
    return diffs


def ungapped_pairs():
    """The pairs of tests/test_ungapped.py: its five fixed pairs, the 32
    seeded pairs of test_batch_matches_numpy (seed 3; bytes of int64
    codes, as that test makes them) and the embedded match (seed 4)."""
    def seq(rng, n, alphabet=b"ACGT"):
        return bytes(rng.choice(list(alphabet), size=n))
    pairs = [(b"ACGTACGT", b"ACGT"), (b"AAAA", b"TTTT"),
             (b"ACGTTTGCA", b"ACGTATGCA"), (b"ACNNGT", b"ACNNGT"),
             (b"ACxxGT", b"ACGGGT")]
    rng = np.random.default_rng(3)
    for _ in range(32):
        pairs.append((seq(rng, int(rng.integers(20, 306)), b"ACGTN"),
                      seq(rng, int(rng.integers(10, 266)), b"ACGTN")))
    rng = np.random.default_rng(4)
    q = seq(rng, 100)
    pairs.append((seq(rng, 80) + q + seq(rng, 80), q))
    return pairs


def score_pairs(rng, n=SCORE_PAIRS):
    """n seeded pairs at the scorer's hot shape: 306-base reference windows
    and 256-base subreads mutated from them, with N in both and 'x' (the
    out-of-chromosome code) in the windows."""
    pairs = []
    for _ in range(n):
        ref = bytearray(rand_seq(rng, 306))
        qry = bytearray(mutate_seq(rng, bytes(ref[25:281]), 0.1)[:256])
        for seq, chars in ((ref, b"Nx"), (qry, b"N")):
            for i in rng.integers(0, len(seq), size=4):
                seq[int(i)] = chars[int(rng.integers(0, len(chars)))]
        pairs.append((bytes(ref), bytes(qry)))
    return pairs


def nosse_pair(tag, argv, dev, golden=None):
    """argv through the port's CLI on dev, then again with --nosse:
    the SAMs must be equal (@PG excluded: it holds the command line), and
    equal to tests/golden/<golden> where one is named. The --nosse run
    launches none of the four alignment kernels and as many expand_votes
    as the kernels' run (the device search is not switched). Returns (its
    numbers, the kernels' SAM)."""
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.ops import kernels as K
    k_out, k_wall = cli_run(tag + ", kernels", argv, dev)
    k_launches = dict(K.launches)
    n_out, n_wall = cli_run(tag + ", --nosse", argv + ["--nosse"], dev)
    n_launches = dict(K.launches)
    st = device_engine.current().stats
    rec = dict(kernels_s=k_wall, nosse_s=n_wall, kernels_launches=k_launches,
               nosse_launches=n_launches, plain_kernels=st["plain_kernels"],
               score_waves=st["score_waves"], align_waves=st["align_waves"],
               sam_identical=_records(n_out) == _records(k_out))
    if golden:
        rec["golden_identical"] = _records(k_out) == _records(_golden(golden))
        check(rec["golden_identical"], "%s: the kernels' SAM differs from "
              "tests/golden/%s" % (tag, golden))
    log("%s: %s" % (tag, json.dumps(rec)))
    check(rec["sam_identical"], "%s: the --nosse SAM differs from the "
          "kernels'" % tag)
    check(st["plain_kernels"] == 1 and st["align_waves"] > 0,
          "%s: the --nosse context ran no plain align wave" % tag)
    check(all(k_launches[k] > 0 for k in KERNELS),
          "%s: the kernels' run launches %s" % (tag, k_launches))
    check(all(n_launches[k] == 0 for k in KERNELS[:4])
          and n_launches["expand_votes"] == k_launches["expand_votes"],
          "%s: --nosse launched %s, the kernels' run %s"
          % (tag, n_launches, k_launches))
    return rec, k_out


DUMP6_ARGV = _data_argv("test_2") + ["--stdout", "6", "--nosse", "-o",
                                     os.devnull]


def oracle_checks(dev):
    """Phase 8(c): the oracle modules on the card. run_batch on the 12
    problems of tests/test_convex.py:52 equals fill_matrix and run_batch on
    the CPU; align_banded through a context on the card (the four CUDA
    kernels, each launched) equals run_batch on the card + the host
    backtrack + convert_cigar on the 10 problems of :75; score_batch on the
    card equals score_pair_numpy on tests/test_ungapped.py's pairs
    (ungapped_pairs), on SCORE_PAIRS seeded hot-shape pairs and on a pair
    past the maxSeqLen guard. Returns the parts' seconds and the oracles' device ms."""
    import torch
    from ngmlr_tpu_torch.ops import kernels as K
    from ngmlr_tpu_torch.ops.convex import BandSpec, run_batch
    from ngmlr_tpu_torch.ops.ungapped import (MAX_SEQ_LEN, nt_codes,
                                              score_batch,
                                              score_batch_kernel,
                                              score_pair_numpy)
    rec = {}
    t0 = time.perf_counter()
    n_cells = 0
    for i, (ref, qry, offs, width) in enumerate(fill_cases()):
        res, diffs = fill_diffs(ref, qry, offs, width, dev)
        check(not diffs, "oracle fill %d on %s: %s" % (i, dev, diffs[:4]))
        cpu = run_batch([BandSpec(ref, qry, offs, width)], device="cpu")[0]
        check(np.array_equal(res.dirs, cpu.dirs)
              and (res.score, res.best_x, res.best_y)
              == (cpu.score, cpu.best_x, cpu.best_y),
              "oracle fill %d: run_batch on the card differs from the CPU's"
              % i)
        n_cells += res.dirs.size * 4
    rec["fill_s"] = time.perf_counter() - t0
    log("phase 8(c) run_batch vs fill_matrix and the CPU, 12 problems "
        "(%d padded cells): %.2f s" % (n_cells, rec["fill_s"]))

    t0 = time.perf_counter()
    old = _env("NGMLR_TPU_NO_PALLAS", None)
    K.reset_launches()
    try:
        for i, case in enumerate(align_cases()):
            diffs = align_diffs(*case, device=dev)
            check(not diffs, "oracle align %d on %s: %s" % (i, dev, diffs))
    finally:
        _env("NGMLR_TPU_NO_PALLAS", old)
    rec["engine_launches"] = dict(K.launches)
    rec["engine_s"] = time.perf_counter() - t0
    log("phase 8(c) align_banded on the card vs run_batch + host backtrack, "
        "10 problems: %.2f s, launches %s" % (rec["engine_s"],
                                              json.dumps(K.launches)))
    check(all(K.launches[k] > 0 for k in KERNELS[1:4]),
          "the engine half launched %s" % K.launches)

    t0 = time.perf_counter()
    # two batches, each padded to its own longest pair, as score_batch pads
    batches = (ungapped_pairs(), score_pairs(np.random.default_rng(21))
               + [(b"A" * MAX_SEQ_LEN, b"ACGT")])
    got = np.concatenate([score_batch([r for r, _ in b], [q for _, q in b],
                                      device=dev) for b in batches])
    pairs = batches[0] + batches[1]
    want = np.asarray([score_pair_numpy(r, q) for r, q in pairs], np.float32)
    check(np.array_equal(got, want), "score_batch on the card differs from "
          "score_pair_numpy at %s" % np.nonzero(got != want)[0][:8])
    check(want[-1] == -1.0 and want[:5].tolist() == [4, 0, 7, 4, 4]
          and want[37] == 100.0, "score_pair_numpy: %s" % want[:38])
    rec["score_s"] = time.perf_counter() - t0
    log("phase 8(c) score_batch on the card vs score_pair_numpy, %d pairs: "
        "%.2f s" % (len(pairs), rec["score_s"]))

    # the oracles' device time on the card, one call each, by CUDA events:
    # score_batch_kernel at the hot shape's padding, and _wavefront_kernel
    # at run_batch's smallest bucket
    hot = score_pairs(np.random.default_rng(22))
    rc = torch.full((len(hot), 512), 4, dtype=torch.uint8)
    qc = torch.full((len(hot), 256), 4, dtype=torch.uint8)
    for i, (r, q) in enumerate(hot):
        rc[i, :len(r)] = torch.from_numpy(nt_codes(r))
        qc[i, :len(q)] = torch.from_numpy(nt_codes(q))
    rc, qc = rc.to(dev), qc.to(dev)
    score_batch_kernel(rc, qc)
    _, rec["score_batch_kernel_ms"] = timed_once(
        lambda: score_batch_kernel(rc, qc))
    from ngmlr_tpu_torch.ops.convex import _wavefront_kernel
    specs = [BandSpec(r, q, o, w).prepare() for r, q, o, w in fill_cases()]
    B, Tp, L = len(specs), 256, 128
    args = [np.zeros((B, Tp), np.uint8), np.full((B, Tp), 255, np.uint8),
            np.zeros((B, Tp), np.int32), np.full((B, Tp), -1, np.int32)]
    for b, sp in enumerate(specs):
        args[0][b, :len(sp.ref)] = np.frombuffer(sp.ref, np.uint8)
        args[1][b, :len(sp.qry)] = np.frombuffer(sp.qry, np.uint8)
        args[2][b, :sp.T], args[3][b, :sp.T] = sp.ymin, sp.ymax
    args = [torch.from_numpy(a).to(dev) for a in args]
    pvec = torch.tensor(PARAMS, device=dev)
    _wavefront_kernel(*args, pvec, L=L)
    _, rec["wavefront_kernel_ms"] = timed_once(
        lambda: _wavefront_kernel(*args, pvec, L=L))
    rec["wavefront_kernel_shape"] = [B, Tp, L]
    log("phase 8(c) oracle device ms: score_batch_kernel %d x 512 x 256 "
        "%.3f, _wavefront_kernel B=%d Tp=%d L=%d %.3f"
        % (len(hot), rec["score_batch_kernel_ms"], B, Tp, L,
           rec["wavefront_kernel_ms"]))
    return rec


def phase_nosse(main_path, workdir, dev="cuda"):
    """Phase 8: (a) test_2 pacbio through the CLI with --nosse on the card,
    its SAM equal to the golden and to the kernels' run of the same
    command; phase 4's genome with its first NOSSE_READS reads, the --nosse
    SAM equal to the kernels', and the kernels' records of those reads
    equal to phase 4's; (b) --stdout 6 --nosse on test_2 on the card equal
    to the same dump on the CPU; (c) the oracle modules on the card."""
    from ngmlr_tpu_torch.io.fastx import parse_fastx
    os.makedirs(workdir, exist_ok=True)
    rec = {}
    # (b): --stdout 6 numbers alignments from 0 in a process, so each dump
    # runs in a fresh one; the CPU's runs beside the card's work
    cpu_dump = start_cli(DUMP6_ARGV, "cpu", OMP_NUM_THREADS="1")
    card_p = None
    try:
        t0 = time.perf_counter()
        rec["test_2"], _ = nosse_pair("nosse (a) test_2",
                                      _data_argv("test_2"), dev, "test_2.sam")
        log("phase 8(a) test_2 pacbio, kernels and --nosse: %.2f s"
            % (time.perf_counter() - t0))

        t0 = time.perf_counter()
        ref_p, reads_p, main_sam = main_path
        few_p = os.path.join(workdir, "reads_%d.fa" % NOSSE_READS)
        reads = []
        for r in parse_fastx(reads_p):
            reads.append((r.name, r.seq))
            if len(reads) == NOSSE_READS:
                break
        write_fasta(few_p, reads)
        rec["genome"], k_out = nosse_pair(
            "nosse (a) %.0f Mbp, %d reads" % (GENOME_MBP, NOSSE_READS),
            ["-r", ref_p, "-q", few_p, "--no-progress"], dev)
        mine, main = _per_read(k_out, False), _per_read(main_sam, False)
        check(set(mine) == {n.decode() for n, _ in reads}
              and all(mine[q] == main[q] for q in mine),
              "nosse (a): the %d reads' records differ from phase 4's"
              % NOSSE_READS)
        log("phase 8(a) %.0f Mbp genome, %d of %d reads, kernels and "
            "--nosse: %.2f s" % (GENOME_MBP, NOSSE_READS, N_READS,
                                 time.perf_counter() - t0))

        t0 = time.perf_counter()
        card_p = start_cli(DUMP6_ARGV, dev)
        card, err = card_p.communicate(timeout=900)
        card_s = time.perf_counter() - t0
        counts = cli_counts("nosse (b) --stdout 6 on the card", card_p, err)
        cpu, err = cpu_dump.communicate(timeout=900)
        cli_counts("nosse (b) --stdout 6 on the CPU", cpu_dump, err)
        rec["dump"] = dict(card_s=card_s, lines=card.count(b"\n"),
                           cpu_lines=cpu.count(b"\n"),
                           identical=card == cpu,
                           launches=counts["launches"])
        log("nosse (b): %s" % json.dumps(rec["dump"]))
        if not rec["dump"]["identical"]:
            for name, dump in (("card", card), ("cpu", cpu)):
                with open(os.path.join(workdir, "dump6_%s.txt" % name),
                          "wb") as f:
                    f.write(dump)
        check(rec["dump"]["identical"] and rec["dump"]["lines"] > 30000,
              "nosse (b): the card's --stdout 6 --nosse dump (%d lines) "
              "differs from the CPU's (%d lines; both in %s)"
              % (rec["dump"]["lines"], rec["dump"]["cpu_lines"], workdir))
        check(counts["stats"]["plain_kernels"] == 1
              and counts["launches"]["expand_votes"] > 0,
              "nosse (b): the card's dump ran %s" % json.dumps(counts))
        log("phase 8(b) --stdout 6 --nosse, card against CPU: %.2f s"
            % (time.perf_counter() - t0))
    finally:
        for p in (cpu_dump, card_p):
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate()
    t0 = time.perf_counter()
    rec["oracles"] = oracle_checks(dev)
    log("phase 8(c) the oracles on the card: %.2f s"
        % (time.perf_counter() - t0))
    return rec


# ---------------------------------------------------------------------------
# phase 9: past 2^31 (phase 4's genome behind an all-N gap chromosome)
# ---------------------------------------------------------------------------

# the gap chromosome's length: even, and GAP_LEN + 1000 a multiple of 2^16
# above 2^31, so phase 4's chromosome starts at 1000 + GAP_LEN + 1000 =
# 2,147,550,184, past 2^31 and congruent to its phase-4 start (1000) modulo
# 2^16: bins and decode parity shift uniformly. An all-N chromosome emits
# no k-mer, so the index is phase 4's, shifted
GAP_LEN = (1 << 31) + (1 << 16) - 1000
GAP_LINE = 1 << 20
HIGH_WRAPPERS = ("score_fill", "corridor_windows", "convex_fill",
                 "convex_backtrack")


def write_gap_reference(path, ref_p, gap_len=GAP_LEN):
    """FASTA of one all-N chromosome of gap_len bases ("gap", lines of
    GAP_LINE bases), then the records of ref_p."""
    line = b"N" * GAP_LINE + b"\n"
    with open(path, "wb") as f:
        f.write(b">gap\n")
        for _ in range(gap_len // GAP_LINE):
            f.write(line)
        f.write(b"N" * (gap_len % GAP_LINE) + b"\n")
        with open(ref_p, "rb") as src:
            while True:
                chunk = src.read(1 << 24)
                if not chunk:
                    break
                f.write(chunk)


@contextlib.contextmanager
def row_reach():
    """Stand in for the four alignment wrappers of ngmlr_tpu_torch.ops.
    kernels, recording for each call, on the device, the rows it was handed
    that name a window (hi > 0: the engine's padding and rows in a spacer
    carry hi = 0), how many of them start at 2^31 or above, their least ds,
    and their least and largest unit (bits 28+ of W); then call the
    wrapper. Yields {wrapper: [(rows, rows past 2^31, least ds, least unit,
    largest unit) tensors]}, read once the run is over (reach_of)."""
    import torch
    from ngmlr_tpu_torch.ops import kernels as K
    seen = {n: [] for n in HIGH_WRAPPERS}
    orig = {n: getattr(K, n) for n in HIGH_WRAPPERS}

    def note(name, pk):
        ds = pk[:, 0].long() & 0xFFFFFFFF
        real = (pk[:, 1].long() & 0xFFFFFFFF) > 0
        unit = (pk[:, 3].long() & 0xFFFFFFFF) >> 28
        seen[name].append((real.sum(), (real & (ds >= 1 << 31)).sum(),
                           torch.where(real, ds, 1 << 32).min(),
                           torch.where(real, unit, 16).min(),
                           torch.where(real, unit, -1).max()))

    def wrap(name, pk_arg):
        def f(*a):
            note(name, a[pk_arg])
            return orig[name](*a)
        return f
    # the position of the rows argument in each wrapper's signature
    for name, i in (("score_fill", 2), ("corridor_windows", 0),
                    ("convex_fill", 2), ("convex_backtrack", 2)):
        setattr(K, name, wrap(name, i))
    try:
        yield seen
    finally:
        for n, f in orig.items():
            setattr(K, n, f)


def reach_of(seen):
    """row_reach's records summed per wrapper: {wrapper: {calls, rows,
    rows_past_2_31, least_ds, units: [least, largest]}} over the rows that
    name a window."""
    reach = {}
    for name, calls in seen.items():
        calls = [[int(v) for v in c] for c in calls]
        live = [c for c in calls if c[0]]
        reach[name] = dict(
            calls=len(calls), rows=sum(c[0] for c in calls),
            rows_past_2_31=sum(c[1] for c in calls),
            least_ds=min((c[2] for c in live), default=None),
            units=[min((c[3] for c in live), default=None),
                   max((c[4] for c in live), default=None)])
    return reach


def check_index_table(tag, p, start):
    """The index of a genome whose last chromosome starts at start (the
    all-N gap before it emits no k-mer): its positions of the type the
    genome's concatenated length calls for, uint32 below 2^32 and int64
    from there (a uint32 table wraps a position past 2^32 to pos - 2^32),
    and none below start. Returns (least position, dtype name)."""
    from ngmlr_tpu_torch.index.kmer_index import positions_dtype
    pos = p.index.positions
    pos_min = int(pos.min())
    want = positions_dtype(p.ref.concat_len)
    check(pos.dtype == want, "%s: index positions of %s for a genome of "
          "%d bases, not %s" % (tag, pos.dtype, len(p.ref.codes), want))
    check(pos_min >= start, "%s: an index position below the chromosome "
          "(%d)" % (tag, pos_min))
    return pos_min, str(pos.dtype)


def _origins(reads_p):
    """{read name: the source position in its name (r<i>_<pos>)}."""
    origin = {}
    with open(reads_p, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                name = line[1:].split()[0]
                origin[name] = int(name.rsplit(b"_", 1)[1])
    return origin


def _body(sam):
    """The SAM without its @SQ and @PG lines."""
    return [l for l in sam.split(b"\n")
            if not l.startswith((b"@SQ", b"@PG"))]


def phase_high_genome(main_path, workdir):
    """Phase 9: phase 4's genome and reads behind one all-N gap chromosome,
    so every window and index position of the real chromosome lies past
    2^31. Its reads map with the default gate (the device search), then
    with the host search on the same Pipeline: the two SAMs equal, and the
    SAM body (@SQ lines aside) equal to phase 4's; every kernel launched,
    the launches equal to the waves, and every row handed to the four
    alignment kernels starting at 2^31 or above; the first batch's
    candidates equal to the host search_batch; mapped and placed shares
    as phase 4's."""
    import torch
    ref_p, reads_p, main_sam = main_path
    os.makedirs(workdir, exist_ok=True)
    ref9 = os.path.join(workdir, "ref_gap.fa")
    t0 = time.perf_counter()
    write_gap_reference(ref9, ref_p)
    log("past 2^31: wrote %s (a %d-base gap chromosome, then phase 4's) in "
        "%.2f s" % (ref9, GAP_LEN, time.perf_counter() - t0))
    origin = _origins(reads_p)
    try:
        torch.cuda.reset_peak_memory_stats()
        p, t_setup = _pipeline(ref9, reads_p)
        check(p.dev_search is not None, "the gate left the device search off")
        start = int(p.ref.ref_start[1])
        check(start == 1000 + GAP_LEN + 1000 and start > 1 << 31,
              "past 2^31: the chromosome starts at %d" % start)
        resident = {"genome": p.ctx.genome.nbytes,
                    "bucket_pairs": p.dev_search.bucket_pairs.nbytes,
                    "positions": p.dev_search.positions.nbytes}
        pos_min, pos_dt = check_index_table("past 2^31", p, start)
        log("past 2^31: setup %.2f s, chromosome start %d, least index "
            "position %d (%s), resident on the card %s"
            % (t_setup, start, pos_min, pos_dt, json.dumps(resident)))
        with row_reach() as seen:
            out, t_run, launches = _run_on(p, reads_p)
        summary = mapping_summary("past 2^31", GENOME_MBP, p, out, origin,
                                  t_setup, t_run, launches, None)
        for name in KERNELS:
            check(launches[name] > 0,
                  "kernel %s was not launched past 2^31" % name)
        reach = reach_of(seen)
        for name, r in reach.items():
            check(r["rows"] > 0 and r["rows_past_2_31"] == r["rows"],
                  "past 2^31: %s was handed %d rows, %d of them past 2^31 "
                  "(least ds %s)" % (name, r["rows"], r["rows_past_2_31"],
                                     r["least_ds"]))
        summary["rows"] = reach
        summary["resident_bytes"] = resident
        summary["chromosome_start"] = start
        summary["least_index_position"] = pos_min
        summary["positions_dtype"] = pos_dt
        log("past 2^31: rows handed to the alignment kernels %s"
            % json.dumps(reach))
        same = _body(out) == _body(main_sam)
        summary["sam_body_equal_to_phase_4"] = same
        check(same, "past 2^31: the SAM body differs from phase 4's")
        summary["host_search"] = other_search_run("past 2^31", p, reads_p,
                                                  out)
        summary["first_batch"] = check_first_batch("past 2^31", p, reads_p)
        log("past 2^31: setup %.2f s, map %.3f s (%.1f reads/s), peak "
            "device memory %d B, SAM body equal to phase 4's"
            % (t_setup, t_run, summary["reads_per_s"],
               summary["max_memory_allocated"]))
        del p
    finally:
        os.remove(ref9)
        torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 10: past 2^32 (phase 4's genome behind a 4.29 Gbp all-N gap
# chromosome: three units of the real 2^31 slab)
# ---------------------------------------------------------------------------

# the gap chromosome's length: even, and GAP_LEN_32 + 1000 a multiple of
# 2^16 above 2^32, so phase 4's chromosome starts at 1000 + GAP_LEN_32 +
# 1000 = 4,295,033,832, past 2^32 and congruent to its phase-4 start modulo
# 2^16. The genome (~4.35 Gbp) is 3 units of 2^31; the chromosome lies in
# unit 2, from its local base 66,536
GAP_LEN_32 = (1 << 32) + (1 << 16) - 1000
UNITS_PAST_2_32 = 3


def phase_units_past_2_32(main_path, workdir):
    """Phase 10: phase 4's genome and reads behind one all-N gap chromosome
    of GAP_LEN_32 bases, so the chromosome's sequence and index positions
    lie past 2^32 and in unit 2 of three real 2^31-base slabs. Mapped as the
    reference maps a multi-unit genome (host search, Python assembly path)
    under NGMLR_TPU_STRICT=1: the index int64 and shifted, every row handed
    to the four alignment kernels naming unit 2, the launches equal to the
    waves (no expand_votes), the SAM body (@SQ lines aside) equal to phase
    4's, mapped and placed shares as phase 4's (placement is
    chromosome-local, which the gap does not move)."""
    import torch
    tag = "past 2^32"
    ref_p, reads_p, main_sam = main_path
    os.makedirs(workdir, exist_ok=True)
    ref10 = os.path.join(workdir, "ref_gap32.fa")
    t0 = time.perf_counter()
    write_gap_reference(ref10, ref_p, GAP_LEN_32)
    t_write = time.perf_counter() - t0
    log("%s: wrote %s (a %d-base gap chromosome, then phase 4's) in %.2f s"
        % (tag, ref10, GAP_LEN_32, t_write))
    origin = _origins(reads_p)
    old = [_env("NGMLR_TPU_UNIT_SLAB_BITS", None),
           _env("NGMLR_TPU_STRICT", "1")]
    try:
        torch.cuda.reset_peak_memory_stats()
        p, t_setup = _pipeline(ref10, reads_p)
        start = int(p.ref.ref_start[1])
        check(start == 1000 + GAP_LEN_32 + 1000 and start > 1 << 32,
              "%s: the chromosome starts at %d" % (tag, start))
        planes = p.ctx.genome
        check(p.ref.n_units == p.ctx.n_units == UNITS_PAST_2_32
              and planes.dim() == 2 and planes.shape[0] == UNITS_PAST_2_32,
              "%s: %d units on the host, %d in the context, planes %s"
              % (tag, p.ref.n_units, p.ctx.n_units, list(planes.shape)))
        check(p.dev_search is None and p.native is None,
              "%s: the device search or the native engine is on" % tag)
        pos_min, pos_dt = check_index_table(tag, p, start)
        log("%s: setup %.2f s, chromosome start %d, %d units, planes %s "
            "(%d B), least index position %d (%s)"
            % (tag, t_setup, start, p.ref.n_units, list(planes.shape),
               planes.nbytes, pos_min, pos_dt))
        with row_reach() as seen:
            out, t_run, launches = _run_on(p, reads_p)
        check_launches(tag, launches, p.ctx.stats)
        check(launches["expand_votes"] == 0
              and all(launches[k] > 0 for k in HIGH_WRAPPERS),
              "%s: launches %s" % (tag, launches))
        reach = reach_of(seen)
        last = UNITS_PAST_2_32 - 1
        for name, r in reach.items():
            check(r["rows"] > 0 and r["units"] == [last, last],
                  "%s: %s was handed %d rows of units %s, not all of unit %d"
                  % (tag, name, r["rows"], r["units"], last))
        reads, mapped = p.stats["reads"], p.stats["mapped"]
        summary = dict(
            gap_len=GAP_LEN_32, chromosome_start=start,
            genome_bytes=int(len(p.ref.codes)), units=p.ref.n_units,
            planes_shape=list(planes.shape), planes_bytes=planes.nbytes,
            least_index_position=pos_min, positions_dtype=pos_dt,
            write_s=t_write, setup_s=t_setup, map_s=t_run,
            reads=reads, mapped=mapped, reads_per_s=reads / t_run,
            primary_near_origin=near_origin(out, origin),
            score_waves=p.ctx.stats["score_waves"],
            align_waves=p.ctx.stats["align_waves"], launches=launches,
            rows=reach, max_memory_allocated=torch.cuda.max_memory_allocated(),
            sam_body_equal_to_phase_4=_body(out) == _body(main_sam))
        log("%s: %s" % (tag, json.dumps(summary)))
        check(summary["sam_body_equal_to_phase_4"],
              "%s: the SAM body differs from phase 4's" % tag)
        check(mapped >= 0.95 * reads, "%s: only %d of %d reads mapped"
              % (tag, mapped, reads))
        check(summary["primary_near_origin"] >= 0.9,
              "%s: only %.3f of the primary records lie near their source"
              % (tag, summary["primary_near_origin"]))
        log("%s: setup %.2f s, map %.3f s (%.1f reads/s), peak device memory "
            "%d B, every kernel row in unit %d, SAM body equal to phase 4's"
            % (tag, t_setup, t_run, summary["reads_per_s"],
               summary["max_memory_allocated"], last))
        del p, planes
    finally:
        _env("NGMLR_TPU_UNIT_SLAB_BITS", old[0])
        _env("NGMLR_TPU_STRICT", old[1])
        os.remove(ref10)
        torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 11: the bench on the card (scripts/torch_bench.py, bench.py's port)
# ---------------------------------------------------------------------------

# the ladder's first scale, bench.py's 576 + 16 reads of ~9 kb
BENCH_MBP = 30.0
BENCH_PASSES = 3
BENCH_DEADLINE_S = 300


def run_bench(workdir, genome_mbp, passes=BENCH_PASSES, **extra):
    """scripts/torch_bench.py pinned at one scale, in a subprocess on the
    card (NGMLR_TORCH_DEVICE and every other BENCH_* variable unset), its
    work directory under workdir. Returns the finished process."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")
           and k not in ("NGMLR_TORCH_DEVICE", "NGMLR_TPU_DEVICE_SEARCH")}
    env.update(TMPDIR=workdir, BENCH_GENOME_MBP=str(genome_mbp),
               BENCH_PASSES=str(passes),
               BENCH_DEADLINE_S=str(BENCH_DEADLINE_S), **extra)
    os.makedirs(workdir, exist_ok=True)
    try:
        return subprocess.run(
            [sys.executable, os.path.join(HERE, "scripts", "torch_bench.py")],
            cwd=HERE, env=env, capture_output=True, text=True,
            timeout=BENCH_DEADLINE_S + 60)
    except subprocess.TimeoutExpired as e:
        raise PhaseError("the bench outlived its %d s deadline: %s"
                         % (BENCH_DEADLINE_S, e)) from None


def check_bench_line(tag, proc, card):
    """The bench's run: exit code 0 and exactly one JSON line on stdout,
    without an error, with reads/s, >= 0.95 of the reads mapped, useful
    GCUPS above 0 and at most the padded, native-engine waves, every kernel
    launched in the best pass (the bench itself holds the pass's launches
    to its engine's record with check_launches and sets `error` where they
    differ), and the card phase 1 read. Returns the line."""
    lines = proc.stdout.splitlines()
    check(proc.returncode == 0 and len(lines) == 1,
          "%s: exit code %d, %d stdout lines; stderr ends %s"
          % (tag, proc.returncode, len(lines), proc.stderr[-2000:]))
    line = json.loads(lines[-1])
    check("error" not in line, "%s: %s" % (tag, line.get("error")))
    check(line["value"] > 0 and line["mapped_frac"] >= 0.95,
          "%s: %r reads/s, %r mapped" % (tag, line["value"],
                                         line["mapped_frac"]))
    check(0 < line["gcups_convex_dp"] <= line["gcups_convex_dp_padded"],
          "%s: GCUPS useful %r, padded %r"
          % (tag, line["gcups_convex_dp"], line["gcups_convex_dp_padded"]))
    launches = line["kernel_launches"]
    check(line["stage_counts"].get("engine_waves", 0) > 0,
          "%s: the native engine ran no wave" % tag)
    check(all(launches[k] > 0 for k in KERNELS),
          "%s: a kernel was not launched: %s" % (tag, launches))
    check(line["device"] == card, "%s: the bench ran on %r, phase 1 read %r"
          % (tag, line["device"], card))
    return line


def phase_bench(card, workdir):
    """Phase 11: scripts/torch_bench.py at BENCH_MBP, BENCH_PASSES passes,
    its line checked by check_bench_line and logged; then its timed reads
    mapped once in this process (the device search, on the bench's caches)
    and held to the JAX package's bench30 digests (bench_identity)."""
    import shutil
    try:
        proc = run_bench(workdir, BENCH_MBP)
        log("bench line: %s" % (proc.stdout.strip().splitlines() or [""])[-1])
        line = check_bench_line("bench", proc, card)
        line["jax"] = bench_identity(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("bench: %g Mbp, %d reads, best of %s s: %r reads/s, setup %.2f s, "
        "peak device memory %d B" % (
            line["genome_mbp"], line["n_reads"], line["pass_s"],
            line["value"], line["setup_s"], line["peak_device_bytes"]))
    return line


def bench_identity(workdir):
    """The bench's timed reads (its work directory under workdir, its
    caches) mapped once through the port on the card under
    NGMLR_TPU_STRICT=1, with the gate's device search and the native
    engine, the SAM held to the JAX package's bench30 digests."""
    import torch
    from ngmlr_tpu_torch.ops import device_engine
    S = _script("torch_scale_vs_jax")
    d = os.path.join(workdir, os.path.basename(
        S.bench.workdir_for(BENCH_MBP)))
    ref_p, reads_p = os.path.join(d, "ref.fa"), os.path.join(d, "reads.fa")
    old = _env("NGMLR_TPU_DEVICE_SEARCH", None)
    try:
        p, setup_s = S.port_pipeline(ref_p)
    finally:
        _env("NGMLR_TPU_DEVICE_SEARCH", old)
    try:
        check(p.dev_search is not None, "bench, in process: the gate left "
              "the device search off")
        run = S.map_once("bench, in process", p, reads_p)
        S.check_native("bench, in process", p, run)
        rec = hold_to_jax("bench, in process", "bench%d" % BENCH_MBP,
                          run["sam"], reads_p)
        rec.update(setup_s=setup_s, map_s=run["map_s"],
                   launches=run["launches"],
                   lane_classes=run["lane_classes"])
        log("bench, in process: setup %.2f s (its caches), map %.2f s, "
            "launches %s" % (setup_s, run["map_s"],
                             json.dumps(run["launches"])))
    finally:
        device_engine.set_current(None)
        del p
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 12: the SV-rich fuzz (scripts/torch_fuzz_vs_jax.py) against the JAX
# package's SAMs committed in tests/golden/torch_fuzz
# ---------------------------------------------------------------------------

def phase_fuzz():
    """Phase 12: each committed seed of scripts/torch_fuzz_vs_jax.py
    (seeds 501-505 with -x pacbio, 506 with -x ont, 150 SV-rich reads on a
    500 kbp genome of two chromosomes) through its fuzz_seeds on the card:
    the default gate (the device search), the host search on the same
    Pipeline and the device search at its small batches (two batches in
    flight), each SAM equal to the committed JAX SAM byte for byte (@PG
    aside), each mapping's launches its engine's record. Over the
    device-search runs all five kernels launch. Returns the numbers of each
    seed."""
    import torch
    F = _script("torch_fuzz_vs_jax")
    old = _env("NGMLR_TPU_DEVICE_SEARCH", None)
    try:
        code, seeds = F.fuzz_seeds(F.SAM_SEEDS, F.N_READS, "cuda", False)
    finally:
        _env("NGMLR_TPU_DEVICE_SEARCH", old)
        torch.cuda.empty_cache()
    check(code == 0, "the fuzz exited %d: %s" % (code, "; ".join(
        f for r in seeds.values() for f in r["failures"]) or "see above"))
    launched = dict.fromkeys(KERNELS, 0)
    for rec in seeds.values():
        for run in rec["runs"].values():
            if run["search"] == "device":
                for k in KERNELS:
                    launched[k] += run["launches"][k]
    check(all(launched[k] > 0 for k in KERNELS),
          "the fuzz's device-search runs left a kernel unlaunched: %s"
          % launched)
    return {"seeds": seeds, "device_search_launches": launched}


# ---------------------------------------------------------------------------
# phases 13 and 14: long SV reads and ultra-long reads on phase 4's genome
# (scripts/torch_scale_vs_jax.py's svlong and ultralong) against the JAX
# package's committed digests
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def largest_align_launch():
    """Keeps, while inside, the arguments and outputs of the largest call
    of device_engine._convex_kernel (by its B x (Wp + Hp) x L direction
    bytes). Yields {"bytes", "args", "out"}."""
    from ngmlr_tpu_torch.ops import device_engine
    seen = {"bytes": 0}
    orig = device_engine._convex_kernel
    lock = threading.Lock()

    def ck(genome, readbuf, pk, params, Wp, Hp, L, plain=False):
        out = orig(genome, readbuf, pk, params, Wp=Wp, Hp=Hp, L=L,
                   plain=plain)
        n = int(pk.shape[0]) * (Wp + Hp) * L
        with lock:
            if n > seen["bytes"]:
                seen.update(bytes=n, out=out,
                            args=(genome, readbuf, pk, params, Wp, Hp, L))
        return out
    device_engine._convex_kernel = ck
    try:
        yield seen
    finally:
        device_engine._convex_kernel = orig


def replay_rows(seen):
    """The largest align launch's first row (a real one: the slots past a
    wave's rows are the padding) copied into each of its B slots and
    launched again: past B x TpP x L = 2^31 the rows at the end address
    direction bytes past 2^31 in convex_fill and convex_backtrack. Every
    row's packed ops and scalars must equal the first row's in the
    mapping's own launch. Returns the launch's numbers."""
    import torch
    from ngmlr_tpu_torch.ops import device_engine
    genome, readbuf, pk, params, Wp, Hp, L = seen["args"]
    B = int(pk.shape[0])
    packed, scalars = device_engine._convex_kernel(
        genome, readbuf, pk[:1].repeat(B, 1), params, Wp=Wp, Hp=Hp, L=L)
    packed = packed.reshape(B, -1)
    want_p = seen["out"][0].reshape(B, -1)[0]
    want_s = seen["out"][1][0]
    bad = [b for b in range(B) if not (torch.equal(packed[b], want_p)
                                       and torch.equal(scalars[b], want_s))]
    rec = {"shape": [B, Wp + Hp, L], "dirs_bytes": seen["bytes"],
           "last_row_from": (B - 1) * (Wp + Hp) * L,
           "rows_equal": B - len(bad)}
    check(not bad, "the largest align launch's row, copied into slots %s of "
          "%s, gave other ops or scalars" % (bad, rec["shape"]))
    return rec


def phase_long_reads(main_path, workdir, dataset):
    """Phases 13 and 14: a dataset of scripts/torch_scale_vs_jax.py on phase
    4's genome (svlong: 64 SV reads of 10-40 kb; ultralong: 36 reads of
    50-250 kb, the same kinds), written from its seed, through the
    script's map_both on a new Pipeline: the device search, then the host
    search, each under NGMLR_TPU_STRICT=1 with its launches its engine's
    record and the native engine's waves, every read and the whole file
    equal to the JAX package's digests; then replay_rows on the largest
    align launch of the two. Returns each mapping's numbers and the
    replay's."""
    import torch
    from ngmlr_tpu_torch.ops import device_engine
    S = _script("torch_scale_vs_jax")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    fname = S.DATASETS[dataset][1]
    reads_p = dict(S.PHASE4_EXTRA)[fname](os.path.join(workdir, fname))
    log("%s: %d reads written in %.2f s"
        % (dataset, len(S.read_names(reads_p)), time.perf_counter() - t0))
    p, t_setup = _pipeline(main_path[0], reads_p)
    want = S.load_digests()[dataset]
    try:
        with largest_align_launch() as largest:
            runs, failures = S.map_both(p, dataset, reads_p, want)
        rec = {m: S.report(r, t_setup) for m, r in runs.items()}
        for m, r in rec.items():
            log("%s, %s: %s" % (dataset, m, json.dumps(r)))
            if runs[m]["diff"]:
                log(S.diff_text(dataset, want, runs[m]["sam"],
                                runs[m]["diff"]).rstrip())
        if not failures:
            rec["replay"] = replay_rows(largest)
            log("%s, the largest align launch's first row in all its "
                "slots: %s" % (dataset, json.dumps(rec["replay"])))
    finally:
        largest.clear()
        device_engine.set_current(None)
        del p
        torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return rec


# ---------------------------------------------------------------------------
# phase 15: the CLI's option sets over FASTQ input (scripts/
# torch_options_vs_jax.py) against the JAX package's committed digests
# ---------------------------------------------------------------------------

def phase_options(workdir):
    """Phase 15: fuzzq under every set that maps it (all but bamfix)
    through the script's options_run on the card: a new Pipeline per pair
    from the set's argv, the gate's search (the device search but for
    sub512) and the other search (sub512: the host search at 20-read
    batches), readgroup also through the CLI's -o *.sam.gz, each under
    NGMLR_TPU_STRICT=1 with its launches its engine's record, every read
    and each file equal to the JAX package's digests. Returns each pair's
    numbers and the phase's launches."""
    O = _script("torch_options_vs_jax")
    old = _env("NGMLR_TPU_DEVICE_SEARCH", None)
    try:
        code, pairs = O.options_run(
            [k for k in O.pairs() if k[1] == "fuzzq"], "cuda", None,
            workdir, O.load_digests(), n_mappings=2)
    finally:
        _env("NGMLR_TPU_DEVICE_SEARCH", old)
    check(code == 0, "the option sets exited %d (see the FAIL lines above)"
          % code)
    launched = dict.fromkeys(KERNELS, 0)
    for rec in pairs.values():
        for m, run in rec.items():
            if m not in ("setup", "cross_check"):
                for k in KERNELS:
                    launched[k] += run["launches"][k]
    check(all(launched.values()), "phase 15 left a kernel unlaunched: %s"
          % launched)
    return {"pairs": pairs, "launches": launched}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for a JSON record of every number")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace phases 4 and 5 with torch.profiler into DIR")
    args = ap.parse_args()
    # the scripts this imports (phases 4, 5 and 11-15) import chip_smoke:
    # let them find this module rather than load a second copy
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
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
        record["mapping"], main_path = phase_mapping(
            GENOME_MBP, N_READS, READ_LEN,
            os.path.join(HERE, "ngmlr_tpu_torch", "_build", "smoke"),
            args.profile)
        log("phase 4 (mapping): %.2f s" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["large_genome"] = phase_large_genome(
            LARGE_GENOME_MBP, N_READS, READ_LEN,
            os.path.join(HERE, "ngmlr_tpu_torch", "_build", "smoke_large"),
            args.profile and os.path.join(args.profile, "large_genome"))
        log("phase 5 (large genome): %.2f s" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["scaleout"] = phase_scaleout(
            main_path, os.path.join(HERE, "ngmlr_tpu_torch", "_build",
                                    "smoke_scaleout"))
        log("phase 6 (scale-out and dumps): %.2f s"
            % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["table_units"] = phase_table_units(
            main_path, os.path.join(HERE, "ngmlr_tpu_torch", "_build",
                                    "smoke_units"))
        log("phase 7 (table units): %.2f s" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["nosse"] = phase_nosse(
            main_path, os.path.join(HERE, "ngmlr_tpu_torch", "_build",
                                    "smoke_nosse"))
        log("phase 8 (--nosse and the oracles): %.2f s"
            % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["high_genome"] = phase_high_genome(
            main_path, os.path.join(HERE, "ngmlr_tpu_torch", "_build",
                                    "smoke_high"))
        log("phase 9 (past 2^31): %.2f s" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["units_past_2_32"] = phase_units_past_2_32(
            main_path, os.path.join(HERE, "ngmlr_tpu_torch", "_build",
                                    "smoke_past32"))
        log("phase 10 (past 2^32, three real slabs): %.2f s"
            % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["bench"] = phase_bench(
            card, os.path.join(HERE, "ngmlr_tpu_torch", "_build",
                               "smoke_bench"))
        log("phase 11 (the bench): %.2f s" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["fuzz"] = phase_fuzz()
        log("phase 12 (the SV-rich fuzz): %.2f s"
            % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["svlong"] = phase_long_reads(
            main_path, os.path.join(HERE, "ngmlr_tpu_torch", "_build",
                                    "smoke_svlong"), "svlong")
        log("phase 13 (long SV reads against the JAX package): %.2f s"
            % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["ultralong"] = phase_long_reads(
            main_path, os.path.join(HERE, "ngmlr_tpu_torch", "_build",
                                    "smoke_ultralong"), "ultralong")
        launched = {k: sum(record["ultralong"][m]["launches"][k]
                           for m in ("gate", "other search"))
                    for k in KERNELS}
        check(all(launched.values()), "phase 14 left a kernel unlaunched: "
              "%s" % launched)
        log("phase 14 (ultra-long reads against the JAX package): %.2f s"
            % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        record["options"] = phase_options(
            os.path.join(HERE, "ngmlr_tpu_torch", "_build", "smoke_options"))
        log("phase 15 (the option sets over FASTQ against the JAX "
            "package): %.2f s" % (time.perf_counter() - t0))
        # the launches of the one-chromosome run, the main path
        launches = record["mapping"]["launches"]
    except PhaseError as e:
        log("FAIL: %s" % e)
        _dump(args.out, record)
        return 1
    line = {"kernels": []}
    for name in KERNELS:
        r = dict(kern[name])
        r["launches"] = launches[name]
        r["ultralong_launches"] = launched[name]
        r["options_launches"] = record["options"]["launches"][name]
        line["kernels"].append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "ultralong_launches", "options_launches")})
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
