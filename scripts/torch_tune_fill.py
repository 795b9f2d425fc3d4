#!/usr/bin/env python3
"""Time the port's convex_fill kernel on a CUDA card against other
checkouts' builds of it, at chip_smoke.py's phase-2 shapes and at the launch
shapes of its phase-4 mapping run.

    python3 scripts/torch_tune_fill.py --parent DIR [--parent DIR ...] [--out DIR]

Builds this checkout's kernel library, and beside it a library of
csrc/convex_fill.cu alone from this checkout and from each --parent (for
example the parent commit unpacked with git archive into a directory
.gitignore lists), each with ptxas' register and spill report, which it
prints. Each other build is held against this checkout's kernel (every live
direction byte, best bits, by, bx), and this checkout's kernel against the
plain version at the phase-2 shapes other than the (slow) main path. Each
is then timed by CUDA events, three launches a reading, in turns (all
builds, then all in reverse); the least reading counts. Prints one line per
shape: its wavefronts (the longest problem's count of ymin < H), ms and us
per wavefront for each build; with --out, writes them, the ptxas reports
and each build's SASS there.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

PARAMS = [2.0, -5.0, -5.0, -5.0, -1.0, 0.15]
# launch shapes (B, TpP, L) of the phase-4 mapping run's convex_fill
PHASE4_SHAPES = ((8, 32768, 1024), (8, 16384, 768), (8, 16384, 640),
                 (8, 8192, 512), (8, 8192, 384), (64, 32768, 256),
                 (192, 32768, 256))


def log(*a):
    print(*a, flush=True)


def bind(path):
    lib = ctypes.CDLL(path)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ngt_convex_fill.argtypes = [p, i64, p, i64, p, p, p, p, i32, i32, i32,
                                    p, p, p, p, p, p]
    lib.ngt_convex_fill.restype = ctypes.c_int
    lib.ngt_convex_fill_state_bytes.argtypes = [i32]
    lib.ngt_convex_fill_state_bytes.restype = i64
    lib.ngt_convex_fill_smem_cap.restype = i64
    return lib


def build_variants(build, jobs, out):
    """{tag: lib} of convex_fill.cu builds, all nvcc processes together;
    jobs: {tag: source}. Prints each build's ptxas register and spill
    lines."""
    nvcc = build._nvcc()
    bdir = os.path.join(build.BUILD_DIR, "tune")
    os.makedirs(bdir, exist_ok=True)
    procs = {}
    for tag, src in jobs.items():
        so = os.path.join(bdir, "fill_%s.so" % tag)
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               "-I", os.path.dirname(src), src, "-o", so]
        procs[tag] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT))
    libs = {}
    for tag, (so, p) in procs.items():
        txt = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (tag, txt[-3000:]))
        libs[tag] = bind(so)
        for ln in txt.splitlines():
            if "Compiling entry" in ln or "spill" in ln or "registers" in ln:
                log("ptxas %s: %s" % (tag, ln.split(": ", 1)[-1].strip()))
        if out:
            with open(os.path.join(out, "ptxas_%s.txt" % tag), "w") as f:
                f.write(txt)
            sass = subprocess.run(
                [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
                capture_output=True, text=True).stdout
            with open(os.path.join(out, "sass_%s.txt" % tag), "w") as f:
                f.write(sass)
    return libs


def fill_with(lib, genome, readbuf, pk, params, ymin, ymax, L):
    import torch
    B, TpP = ymin.shape
    dev = pk.device
    dirs = torch.empty((B, TpP, L), dtype=torch.uint8, device=dev)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    by = torch.empty(B, dtype=torch.int32, device=dev)
    bx = torch.empty(B, dtype=torch.int32, device=dev)
    st = lib.ngt_convex_fill_state_bytes(L)
    scratch = None
    if st > lib.ngt_convex_fill_smem_cap():
        scratch = torch.empty(B * st, dtype=torch.uint8, device=dev)
    rc = lib.ngt_convex_fill(
        genome.data_ptr(), genome.numel(), readbuf.data_ptr(), readbuf.numel(),
        pk.data_ptr(), params.data_ptr(), ymin.data_ptr(), ymax.data_ptr(), B,
        TpP, L, dirs.data_ptr(), best.data_ptr(), by.data_ptr(), bx.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError("convex_fill launch failed (cudaError %d)" % rc)
    return dirs, best, by, bx


def same(a, b, live):
    import torch
    return (torch.equal(a[0][live], b[0][live])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
            and torch.equal(a[2], b[2]) and torch.equal(a[3], b[3]))


def shapes():
    """(tag, Wp, Hp, L, align rows, read buffer) of phase 2's convex shapes,
    drawn in chip_smoke.phase_kernels' order from its seed, and of the
    phase-4 launch shapes (planted PacBio-like reads of ~0.55-0.6 TpP / 2
    bases in a second read buffer, ENDPOINTS and ANCHORS corridors)."""
    rng = np.random.default_rng(7)
    G, R = 4_000_000, 1 << 20
    genome = rng.integers(0, 5, G).astype(np.uint8)
    readbuf = rng.integers(0, 5, R).astype(np.uint8)
    main_pk = cs.align_rows(rng, genome, readbuf, 32, (9000, 10000), (0, 1),
                            (200, 400), (2, 3), plant=True)
    cs.score_rows(rng, G, R, 4096)
    cs.cw_rows(rng, 128)
    out = [("p2-all-modes", 1024, 1024, 128, cs.align_rows(
               rng, genome, readbuf, 32, (200, 1000), (100, 1000), (24, 120),
               (0, 1, 2, 3)), readbuf),
           ("p2-main-path", 16384, 16384, 256, main_pk, readbuf),
           ("p2-wide-1536", 4096, 3072, 1536, cs.align_rows(
               rng, genome, readbuf, 8, (2000, 4000), (1000, 3000),
               (1536 - 200, 1536 - 3), (2,)), readbuf),
           ("p2-wide-2560", 4096, 3072, 2560, cs.align_rows(
               rng, genome, readbuf, 8, (2000, 4000), (1000, 3000),
               (2560 - 200, 2560 - 3), (2,)), readbuf)]
    rng2 = np.random.default_rng(11)
    rb2 = rng2.integers(0, 5, 8 << 20).astype(np.uint8)
    for B, TpP, L in PHASE4_SHAPES:
        half = TpP // 2
        pk = cs.align_rows(rng2, genome, rb2, B,
                           (int(half * 0.55), int(half * 0.6)), (0, 1),
                           (max(L, 200), 2 * L - 10), (2, 3), plant=True)
        out.append(("p4-%dx%dx%d" % (B, TpP, L), half, half, L, pk, rb2))
    return genome, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="another checkout whose convex_fill.cu is timed "
                    "beside this one (tagged by its directory's name)")
    ap.add_argument("--out", help="directory for the records")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        log("FAIL: needs a CUDA card")
        return 2
    from ngmlr_tpu_torch.ops import build, kernels as K
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    log("card:", subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    t0 = time.perf_counter()
    build.get_lib()
    jobs = {"this": os.path.join(build.CSRC, "convex_fill.cu")}
    for d in args.parent:
        jobs[os.path.basename(os.path.normpath(d))] = os.path.join(
            d, "ngmlr_tpu_torch", "csrc", "convex_fill.cu")
    libs = build_variants(build, jobs, args.out)
    del libs["this"]    # timed through its wrapper
    log("built in %.1f s: this checkout, %s" % (time.perf_counter() - t0,
                                                sorted(libs)))
    dev = torch.device("cuda")
    genome_np, cases = shapes()
    genome = torch.from_numpy(genome_np).to(dev)
    params = torch.tensor(PARAMS, dtype=torch.float32, device=dev)
    rows = []
    for tag, Wp, Hp, L, pk_np, rb_np in cases:
        rb = torch.from_numpy(rb_np).to(dev)
        pk = torch.from_numpy(pk_np).to(dev)
        ymin, ymax, _ = K.corridor_windows(pk, Wp + Hp)
        live_t = ymin < pk[:, 5:6]
        live = live_t[:, :, None].expand(-1, -1, L)
        rec = {"shape": tag, "wavefronts": int(live_t.sum(dim=1).max())}
        ref = K.convex_fill(genome, rb, pk, params, ymin, ymax, L)
        if tag.startswith("p2-") and tag != "p2-main-path":
            rec["equal_plain"] = same(ref, K.convex_fill_plain(
                genome, rb, pk, params, ymin, ymax, L), live)
        fns = {"this": lambda: K.convex_fill(genome, rb, pk, params, ymin,
                                             ymax, L)}
        for v, lib in sorted(libs.items()):
            rec["equal_" + v] = same(fill_with(lib, genome, rb, pk, params,
                                               ymin, ymax, L), ref, live)
            fns[v] = (lambda lib=lib: fill_with(lib, genome, rb, pk, params,
                                                ymin, ymax, L))
        times = {}
        for v in list(fns) + list(reversed(list(fns))):
            times.setdefault(v, []).append(cs.cuda_ms(fns[v], reps=3))
        for v, ts in times.items():
            rec["ms_" + v] = min(ts)
            rec["us_per_wavefront_" + v] = min(ts) * 1e3 / max(rec["wavefronts"], 1)
        log("fill " + json.dumps(rec))
        rows.append(rec)
        del ref, rb, pk, ymin, ymax
        torch.cuda.empty_cache()
    if args.out:
        with open(os.path.join(args.out, "tune_fill.json"), "w") as f:
            json.dump(rows, f, indent=1)
    bad = [r["shape"] for r in rows
           if not all(v for k, v in r.items() if k.startswith("equal_"))]
    if bad:
        log("FAIL: builds differ at %s" % bad)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
