"""The five CUDA kernels of the port against their plain PyTorch versions,
the device candidate search against the host search, --nosse against the
kernels' run, the oracle modules (ops/convex.py, ops/ungapped.py,
ops/convex_ref.py) against the CPU and the engine, the SV case of
tests/test_native_engine.py:118, scripts/torch_bench.py, the SV-rich
fuzz (scripts/torch_fuzz_vs_jax.py) against the JAX package's committed
SAM, and phase 4's reads, the long SV reads and the ultra-long reads on
its genome (scripts/torch_scale_vs_jax.py) and the CLI's option sets
over FASTQ input (scripts/torch_options_vs_jax.py) against the JAX
package's committed digests, and the native wave's round trip
(pipeline/native_engine.NativeWave, csrc/wave.cu) against the Python
wave's, on the card. Marked ``cuda``: every
test skips where torch sees no card. The file imports neither jax nor the test conftest, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ngmlr_tpu_torch.ops import device_engine as tde  # noqa: E402
from ngmlr_tpu_torch.ops import kernels as K  # noqa: E402
from ngmlr_tpu_torch.ops.device_engine import _convex_kernel  # noqa: E402
from chip_smoke import (BT_EDGES, CW_EDGES, FILL_EDGES,  # noqa: E402
                        UNIT_PLANE, UNIT_PLANES, bt_edge_case, card_line,
                        check_bench_line, cw_edge_case, fill_edge_err,
                        run_bench, table_unit_files, unit_rows)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = [2.0, -5.0, -5.0, -5.0, -1.0, 0.15]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bufs(dev, seed, G=200_000, R=1 << 15):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.integers(0, 5, G).astype(np.uint8)).to(dev)
    r = torch.from_numpy(rng.integers(0, 5, R).astype(np.uint8)).to(dev)
    return rng, g, r


def _align_rows(rng, B, G, R, Wr, Hr, widths):
    pk = np.zeros((B, 12), np.int32)
    pkf = pk.view(np.float32)
    for b in range(B):
        W, H = int(rng.integers(*Wr)), int(rng.integers(*Hr))
        ds = int(rng.integers(0, G - W - 1))
        mode = b % 4
        width = int(rng.integers(*widths))
        ci, cf = 0, (float(np.float32(H) / np.float32(W)),
                     float(np.float32(width) / np.float32(2.0)))
        if mode == 0:
            ci = int(np.float32(W + 1) * np.float32(-0.2))
            width = W + 1 + int(np.float32(W + 1) * np.float32(0.2))
            cf = (1.0, 0.0)
        elif mode == 1:
            ci, cf = width // 2, (1.0, 0.0)
        pk[b, :10] = (ds, ds + W, 0, W, int(rng.integers(0, R - H - 1)), H,
                      b & 1, mode, ci, width)
        pkf[b, 10:12] = cf
    return pk


def test_score_fill_kernel_matches_plain(dev):
    rng, g, r = _bufs(dev, 1)
    # the hot bucket, a small one, one with several query rows per thread,
    # and one whose reference window passes the default 48 KB of shared
    # memory (the kernel raises its opt-in limit)
    for W, qlen, Rp, Qp, P in ((306, 256, 320, 256, 96), (40, 50, 64, 64, 96),
                               (700, 1500, 1024, 2048, 96),
                               (60000, 300, 65536, 512, 4)):
        pk = np.zeros((P, 7), np.int32)
        pk[:, 0] = rng.integers(0, g.numel() - W - 8, P)
        pk[:, 1] = pk[:, 0] + W
        pk[:, 2] = rng.integers(0, 6, P)
        pk[:, 3], pk[:, 5] = W, qlen
        pk[:, 4] = rng.integers(0, r.numel() - qlen, P)
        pk[:, 6] = np.arange(P) & 1
        pkt = torch.from_numpy(pk).to(dev)
        n0 = K.launches["score_fill"]
        got = K.score_fill(g, r, pkt, Rp, Qp)
        assert K.launches["score_fill"] == n0 + 1
        want = K.score_fill_plain(g, r, pkt, Rp, Qp)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (W, qlen)


def _original_cw_case():
    rng = np.random.default_rng(2)
    B, TpP = 100, 2048
    pk = np.zeros((B, 12), np.int32)
    pk[:, 3] = rng.integers(1, 900, B)
    pk[:, 5] = rng.integers(0, 900, B)
    pk[:, 7] = rng.integers(0, 4, B)
    pk[:, 8] = rng.integers(-50, 200, B)
    pk[:, 9] = rng.integers(-20, 400, B)
    pk.view(np.float32)[:, 10] = rng.uniform(0.05, 3.0, B)
    pk.view(np.float32)[:, 11] = rng.uniform(-100, 100, B)
    return pk, TpP


@pytest.mark.parametrize("case", ["random"] + list(CW_EDGES))
def test_corridor_windows_kernel_matches_plain(dev, case):
    """The tiled kernel's edges (chip_smoke.cw_edge_case): TpP below one
    tile, a ragged last tile, first keys several tiles up, H past TpP, one
    problem and an odd B; all four modes, H = 0 and width <= 0 rows."""
    pk, TpP = _original_cw_case() if case == "random" else cw_edge_case(case)
    pkt = torch.from_numpy(pk).to(dev)
    n0 = K.launches["corridor_windows"]
    got = K.corridor_windows(pkt, TpP)
    assert K.launches["corridor_windows"] == n0 + 1
    want = K.corridor_windows_plain(pkt, TpP)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(BT_EDGES))
def test_convex_backtrack_edges_match_plain(dev, case):
    """The tiled walk's edges (chip_smoke.bt_edge_case): a walk from the top
    wavefront, by <= 0, a STOP on a tile boundary, a validPath exit, steps
    off the matrix in x and in y, a DEL run across tiles (leaving each tile
    at its widest reach), L = 128, 1536, 12288 and 130 (not a
    multiple of 4), B = 1 and odd B."""
    *arrays, expect = bt_edge_case(case)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    n0 = K.launches["convex_backtrack"]
    got = K.convex_backtrack(*args)
    assert K.launches["convex_backtrack"] == n0 + 1
    want = K.convex_backtrack_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for b, (state, sx, sy) in expect.items():
        assert (int(want[3][b]), int(want[1][b]), int(want[2][b])) \
            == (state, sx, sy), b


@pytest.mark.parametrize("case", list(FILL_EDGES))
def test_convex_fill_edges_match_plain(dev, case):
    """The tiled fill's edges (chip_smoke.fill_edge_case), bit for bit:
    ymin steps of 0 and 1 across tiles and lane edges, windows emptying
    before TpP and problems ending far apart, H = 0, W and H below one
    tile, ties across lanes, an all-N query, 'x' at both reference ends,
    reverse rows, a DEL run reaching gemin, L = 128 to 1536, and 6144 and
    12288 (the wide kernel's shared-memory and global-scratch rings), B = 1
    and odd B."""
    n0 = K.launches["convex_fill"]
    err, rows = fill_edge_err(case, dev)
    torch.cuda.synchronize()
    assert K.launches["convex_fill"] == n0 + 1
    assert err == 0 and rows > 0


@pytest.mark.parametrize("Wp,Hp,L", [(1024, 1024, 128), (2048, 1024, 1536),
                                     (512, 512, 12288)])
def test_convex_chain_kernels_match_plain(dev, Wp, Hp, L):
    """L = 12288 keeps the fill's ring buffers in global scratch: they no
    longer fit shared memory."""
    rng, g, r = _bufs(dev, 3)
    pk = _align_rows(rng, 16, g.numel(), r.numel(), (200, Wp),
                     (100, Hp), (24, min(L - 3, 400)))
    pkt = torch.from_numpy(pk).to(dev)
    params = torch.tensor(PARAMS, dtype=torch.float32, device=dev)
    ymin, ymax, hmax = K.corridor_windows(pkt, Wp + Hp)
    dirs, best, by, bx = K.convex_fill(g, r, pkt, params, ymin, ymax, L)
    w_dirs, w_best, w_by, w_bx = K.convex_fill_plain(g, r, pkt, params,
                                                     ymin, ymax, L)
    live = (ymin < pkt[:, 5:6])[:, :, None].expand(-1, -1, L)
    assert torch.equal(dirs[live], w_dirs[live])
    assert torch.equal(best.view(torch.int32), w_best.view(torch.int32))
    assert torch.equal(by, w_by) and torch.equal(bx, w_bx)
    got = K.convex_backtrack(dirs, ymin, pkt, bx, by)
    want = K.convex_backtrack_plain(dirs, ymin, pkt, bx, by)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    packed, scalars = _convex_kernel(g, r, pkt, params, Wp=Wp, Hp=Hp, L=L)
    assert torch.equal(packed, got[0].reshape(-1))
    assert torch.equal(scalars[:, 6], hmax)


def _unit_inputs(dev, seed):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 5, (UNIT_PLANES, UNIT_PLANE)).astype(np.uint8)
    readbuf = rng.integers(0, 5, 1 << 20).astype(np.uint8)
    return rng, planes, readbuf


def test_score_fill_on_unit_rows_matches_plain(dev):
    """Score rows over five genome planes, their windows ending at, running
    past and lying in the halo of their plane's end: the kernel reads each
    row's plane as the plain version does."""
    rng, planes, readbuf = _unit_inputs(dev, 61)
    pk = np.ascontiguousarray(unit_rows(rng, planes, readbuf, 300, (306, 307),
                                        (1, 2), (1,), H_max=256)[:, :7])
    g, r, pkt = (torch.from_numpy(a).to(dev) for a in (planes, readbuf, pk))
    n0 = K.launches["score_fill"]
    got = K.score_fill(g, r, pkt, 320, 256)
    assert K.launches["score_fill"] == n0 + 1
    want = K.score_fill_plain(g, r, pkt, 320, 256)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(got.median()) >= 15


def test_kernels_past_2_31_match_plain(dev):
    """The four alignment kernels on rows past 2^31 of a flat genome of
    2^31 + 2^26 bytes (windows ending at and running past its last byte),
    bit for bit against their plain versions (chip_smoke.py phase 2)."""
    from chip_smoke import high_kernel_errs
    errs = high_kernel_errs(dev)
    assert sorted(errs) == ["convex_backtrack", "convex_fill",
                            "corridor_windows", "score_fill"]
    assert all(e == 0 for e in errs.values()), errs


def test_kernels_on_real_slab_planes_match_plain(dev):
    """score_fill and convex_fill (with corridor_windows and
    convex_backtrack on their outputs) on unit_rows over a [3, 2^31 + 2^30]
    plane tensor, the planes of a genome above 4.29 Gbp at the 2^31 slab
    and its 2^24 halo (plane 2 from byte 6,442,450,944; local ds past 2^31
    in the halo), bit for bit against their plain versions (chip_smoke.py
    phase 2)."""
    from chip_smoke import real_slab_errs
    errs, ms = real_slab_errs(dev)
    assert sorted(errs) == sorted(ms) == ["convex_backtrack", "convex_fill",
                                          "corridor_windows", "score_fill"]
    assert all(e == 0 for e in errs.values()), errs


@pytest.mark.parametrize("L", [256, 6144], ids=["tiled", "wide"])
def test_convex_fill_on_unit_rows_matches_plain(dev, L):
    """Align rows over five genome planes through the tiled (L = 256) and
    the wide (L = 6144) fill, then the backtrack, against the plain
    versions."""
    rng, planes, readbuf = _unit_inputs(dev, 63 + L)
    pk = unit_rows(rng, planes, readbuf, 10, (500, 1500),
                   (100, 300) if L == 256 else (800, 1600),
                   (1, 2, 3) if L == 256 else (0, 2, 3), H_max=2047)
    g, r, pkt = (torch.from_numpy(a).to(dev) for a in (planes, readbuf, pk))
    params = torch.tensor(PARAMS, dtype=torch.float32, device=dev)
    ymin, ymax, _ = K.corridor_windows(pkt, 4096)
    n0 = K.launches["convex_fill"]
    dirs, best, by, bx = K.convex_fill(g, r, pkt, params, ymin, ymax, L)
    assert K.launches["convex_fill"] == n0 + 1
    w_dirs, w_best, w_by, w_bx = K.convex_fill_plain(g, r, pkt, params,
                                                     ymin, ymax, L)
    live = (ymin < pkt[:, 5:6])[:, :, None].expand(-1, -1, L)
    assert torch.equal(dirs[live], w_dirs[live])
    assert torch.equal(best.view(torch.int32), w_best.view(torch.int32))
    assert torch.equal(by, w_by) and torch.equal(bx, w_bx)
    got = K.convex_backtrack(dirs, ymin, pkt, bx, by)
    want = K.convex_backtrack_plain(dirs, ymin, pkt, bx, by)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3].eq(K.DONE).sum()) >= 5


def test_three_unit_pipeline_matches_flat_on_the_card(dev, tmp_path,
                                                      monkeypatch):
    """tests/test_table_units.py:69 on the card: at 2^22-base slabs its
    10 Mbp genome is 3 units, mapped through the host search and the Python
    assembly path, launching score_fill and the convex kernels and no
    expand_votes; the SAM equals the flat run's."""
    from ngmlr_tpu_torch.config import Config
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    ref_p, reads_p = table_unit_files(str(tmp_path))
    monkeypatch.setenv("NGMLR_TPU_STRICT", "1")
    sams = []
    for bits in (None, "22"):
        if bits:
            monkeypatch.setenv("NGMLR_TPU_UNIT_SLAB_BITS", bits)
        else:
            monkeypatch.delenv("NGMLR_TPU_UNIT_SLAB_BITS", raising=False)
        p = Pipeline(Config(), ref_p, use_cache=False, device=dev)
        buf = io.BytesIO()
        K.reset_launches()
        st = p.run(reads_p, buf)
        torch.cuda.synchronize()
        assert st["mapped"] == 14
        sams.append([l for l in buf.getvalue().split(b"\n")
                     if not l.startswith(b"@PG")])
    assert p.ref.n_units == 3 and p.ctx.genome.dim() == 2
    assert p.native is None and p.dev_search is None
    assert K.launches["expand_votes"] == 0
    assert K.launches["score_fill"] == p.ctx.stats["score_launches"] > 0
    assert K.launches["convex_fill"] == p.ctx.stats["align_launches"] > 0
    assert sams[0] == sams[1]


def _map_test2(device):
    """test_2 through a Pipeline on `device` (one device or the mesh's
    list): (pipeline, SAM records, the run's kernel launches, golden
    records)."""
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    data = os.path.join(REPO, "tests", "data", "test_2")
    argv = ["-r", os.path.join(data, "ref_chr21_20kb.fa"),
            "-q", os.path.join(data, "reads_100_2200bp.fa")]
    args = build_parser().parse_args(argv)
    p = Pipeline(config_from_args(args, argv), args.reference,
                 use_cache=False, device=device)
    buf = io.BytesIO()
    K.reset_launches()
    p.run(args.query, buf)
    torch.cuda.synchronize()
    with open(os.path.join(REPO, "tests", "golden", "test_2.sam"), "rb") as f:
        want = f.read()

    def rec(b):
        return [l for l in b.split(b"\n") if not l.startswith(b"@PG")]
    return p, rec(buf.getvalue()), dict(K.launches), rec(want)


def test_golden_test2_on_the_card(dev):
    p, out, launches, want = _map_test2(dev)
    assert out == want
    # the card searches candidates itself, at any genome size
    assert p.dev_search is not None
    assert launches["expand_votes"] == p.ctx.stats["search_v2_launches"]
    assert all(launches[k] > 0 for k in launches), launches
    # every engine wave's device round trip ran in native code, which
    # counts each kernel where it launched: as many as the plans' chains
    # and buckets
    st = p.ctx.stats
    assert st["native_waves"] == st["engine_waves"] > 0
    assert launches["score_fill"] == st["score_launches"]
    for k in ("corridor_windows", "convex_fill", "convex_backtrack"):
        assert launches[k] == st["align_launches"], (k, launches, st)


# one synthetic wave per case: align rows (_align_rows' geometry) and score
# rows, some past the ssw guard; cap and lanes force DIRS_CAP's splits and
# refusals and the lane-bound retry
NATIVE_WAVES = {
    "modes": dict(n=48, W=(200, 3000), H=(200, 3000), widths=(24, 400)),
    "wide": dict(n=6, W=(12000, 16000), H=(12000, 16000),
                 widths=(9000, 24000)),
    "cap_split": dict(n=24, W=(2100, 4000), H=(2100, 4000), widths=(24, 100),
                      cap=16 << 20),
    "cap_refusal": dict(n=24, W=(300, 9000), H=(300, 9000),
                        widths=(24, 400), cap=4 << 20),
    "lane_retry": dict(n=24, W=(400, 600), H=(300, 500), widths=(24, 60),
                       lanes=128),
}


def _native_wave_inputs(case):
    c = NATIVE_WAVES[case]
    rng = np.random.default_rng(sorted(NATIVE_WAVES).index(case) + 40)
    G, R = 1 << 21, 1 << 20
    genome = rng.integers(0, 5, G).astype(np.uint8)
    reads = rng.integers(0, 5, R).astype(np.uint8)
    apk = _align_rows(rng, c["n"], G, R, c["W"], c["H"], c["widths"])
    ns = 40
    spk = np.zeros((ns, 7), np.int32)
    W = rng.choice([306, 700, 2000, 99999], ns)
    q = rng.choice([256, 300, 1500], ns)
    spk[:, 0] = rng.integers(0, G - 100000, ns)
    spk[:, 1] = spk[:, 0] + W
    spk[:, 2] = rng.integers(0, 6, ns)
    spk[:, 3], spk[:, 5] = W, q
    spk[:, 4] = rng.integers(0, R - 2000, ns)
    spk[:, 6] = np.arange(ns) & 1
    return c, genome, reads, apk, spk


def _posted(a_scores, bx, by, ok, ops, s_results, na, ns):
    """The posted arrays as bytes: scores by their bits, ops rows as the
    bytes their pointers name (None for a null pointer)."""
    return (np.asarray(a_scores[:na], np.float32).view(np.int32).tolist(),
            list(bx[:na]), list(by[:na]), list(ok[:na]), ops,
            np.asarray(s_results[:ns], np.float32).view(np.int32).tolist())


@pytest.mark.parametrize("case", list(NATIVE_WAVES))
def test_native_wave_posts_the_python_waves_arrays(dev, case, monkeypatch):
    """One synthetic wave through the Python wave (align_dispatch_pk,
    score_dispatch_np, fetch_waves_np, post_arrays) and through the native
    round trip (NativeWave.launch, fetch): the arrays handed to
    engine_post_results byte for byte, the counters and the launches."""
    import ctypes
    from ngmlr_tpu_torch.pipeline import native_engine as NE
    c, genome, reads, apk, spk = _native_wave_inputs(case)
    na, ns = len(apk), len(spk)
    if "cap" in c:
        monkeypatch.setattr(tde, "dirs_cap", lambda: c["cap"])
    if "lanes" in c:
        orig = tde.align_lanes
        monkeypatch.setattr(tde, "align_lanes", lambda pk, cons: (
            orig(pk, cons) if cons else np.full(len(pk), c["lanes"])))
    ctx = tde.DeviceContext(genome, device=dev)
    rb = ctx.upload_reads(reads)
    params = tuple(PARAMS)
    keys = NE.COUNT_KEYS[:-1]

    st0, k0 = dict(ctx.stats), dict(K.launches)
    apend = ctx.align_dispatch_pk(apk, params, readbuf=rb)
    a_res, s_np = ctx.fetch_waves_np(apend,
                                     ctx.score_dispatch_np(spk, readbuf=rb))
    sc, bx, by, ok, ptrs, lens, s_res, keep = NE.post_arrays(na, ns, a_res,
                                                             s_np)
    want = _posted(sc, bx, by, ok, [
        ctypes.string_at(ptrs[i], int(lens[i])) if ptrs[i] else None
        for i in range(na)], s_res, na, ns)
    want_n = {k: ctx.stats[k] - st0[k] for k in keys}
    want_k = {k: K.launches[k] - k0[k] for k in K.launches}

    wave = NE.NativeWave(ctx, params)
    wave.bind(rb)
    if "lanes" in c:
        wave.cfg[NE._C["lanes"]] = c["lanes"]
    apk_c, spk_c = np.ascontiguousarray(apk), np.ascontiguousarray(spk)
    st1, k1 = dict(ctx.stats), dict(K.launches)
    wave.launch(apk_c.ctypes.data, na, spk_c.ctypes.data, ns)
    launched, refused = wave.launched()
    out = wave.fetch()
    # each chain's results in the wave's arena, read before flush hands a
    # large arena back (and not after a retry, which reuses the arena)
    arena = [] if case == "lane_retry" else [
        (x, wave.chain_results(x[5], len(x[1])))
        for x in launched if x[0] == "align"]

    def arr(i, ct, n):
        return np.ctypeslib.as_array(ctypes.cast(out[i], ctypes.POINTER(ct)),
                                     shape=(n,)).copy()
    lens = arr(5, ctypes.c_int64, na)
    table = ctypes.cast(out[4], ctypes.POINTER(ctypes.c_void_p))
    got = _posted(arr(0, ctypes.c_float, na), arr(1, ctypes.c_int32, na),
                  arr(2, ctypes.c_int32, na), arr(3, ctypes.c_uint8, na),
                  [ctypes.string_at(table[i], int(lens[i])) if table[i]
                   else None for i in range(na)],
                  arr(6, ctypes.c_float, ns), na, ns)
    wave.flush([("engine_waves", 1)])
    torch.cuda.synchronize()
    assert got == want
    assert {k: ctx.stats[k] - st1[k] for k in keys} == want_n
    assert ctx.stats["native_waves"] - st1["native_waves"] == 1
    assert ctx.stats["engine_waves"] - st1["engine_waves"] == 1
    assert {k: K.launches[k] - k1[k] for k in K.launches} == want_k
    assert want_n["score_problems"] == ns and -1.0 in s_np
    assert sum(o is not None for o in want[4]) > 0
    chunks = tde.plan_align_rows(apk, False, tde.dirs_cap())[0]
    # what the native wave reports it launched: the Python plan's blocks
    # and shapes, in its order
    buckets = tde.plan_score_rows(spk)[1]
    assert [(k, b.tolist(), *sh[:3]) for k, b, *sh in launched] == [
        ("align", tde.align_block(apk, idxs, tde._pad_align(len(idxs))
                                  ).tolist(), Wp, Hp, L)
        for L, Wp, Hp, idxs in chunks] + [
        ("score", tde.score_block(spk, idxs, tde._pad_score(len(idxs))
                                  ).tolist(), Rp, Qp)
        for Rp, Qp, idxs in buckets]
    assert refused.tolist() == apk[apend[4]].tolist()
    # the arena's results are the wrappers' launch of the same block
    for (_, blk, Wp, Hp, L, _), (got_p, got_s) in arena:
        packed, scalars = tde._convex_kernel(
            ctx.genome, wave.readbuf, torch.from_numpy(blk).to(dev),
            wave.params, Wp=Wp, Hp=Hp, L=L)
        assert torch.equal(got_p, packed.reshape(len(blk), -1))
        assert torch.equal(got_s, scalars)
    assert len(arena) == (0 if case == "lane_retry" else len(chunks))
    assert (want_n["lane_bound_retries"] > 0) == (case == "lane_retry")
    assert want_n["align_rows_refused"] == len(apend[4])
    if case == "cap_refusal":
        assert apend[4]
    elif case != "cap_split":
        assert not apend[4]
    if case == "cap_split":
        shapes = [ch[:3] for ch in chunks]
        assert len(shapes) > len(set(shapes))
    if case == "wide":
        # the wide fill, its ring buffers in shared memory and in global
        # scratch
        assert {L for L, *_ in chunks} >= {6144, 16384}


def _check_mesh_run(p, launches, devices):
    st = p.ctx.stats
    assert p.ctx.devices == devices and p.ctx.mesh is not None
    assert launches["score_fill"] == st["score_launches"]
    for k in ("corridor_windows", "convex_fill", "convex_backtrack"):
        assert launches[k] == st["align_launches"], (k, launches, st)
    assert launches["expand_votes"] == st["search_v2_launches"] > 0
    assert st["score_launches"] > st["score_waves"]
    assert st["mesh_problems_psum"] > 0
    assert p.dev_search.device == devices[0]


def test_golden_test2_on_a_two_shard_mesh(dev):
    """-t 2's mesh as two shards sharing the one card: the golden bytes,
    each wave's shards launched one by one."""
    mesh = [torch.device("cuda", 0)] * 2
    p, out, launches, want = _map_test2(mesh)
    assert out == want
    _check_mesh_run(p, launches, mesh)


@pytest.fixture
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_golden_test2_over_two_cards(two_cards):
    p, out, launches, want = _map_test2(two_cards)
    assert out == want
    _check_mesh_run(p, launches, two_cards)
    assert set(p.ctx.genomes) == set(two_cards)


def test_wrappers_raise_on_inputs_split_across_cards(two_cards):
    """No wrapper launches, or runs its plain version, on inputs that lie
    on two cards (corridor_windows takes one tensor)."""
    d0, d1 = two_cards
    g = torch.zeros(4096, dtype=torch.uint8, device=d0)
    r = torch.zeros(4096, dtype=torch.uint8, device=d1)
    spk = torch.zeros((8, 7), dtype=torch.int32, device=d0)
    apk = torch.zeros((8, 12), dtype=torch.int32, device=d1)
    par = torch.zeros(6, dtype=torch.float32, device=d0)
    y = torch.zeros((8, 512), dtype=torch.int32, device=d0)
    dirs = torch.zeros((8, 512, 128), dtype=torch.uint8, device=d0)
    b = torch.zeros(8, dtype=torch.int32, device=d0)
    cum = torch.zeros((8, 16), dtype=torch.int32, device=d0)
    tab = torch.zeros((8, 17), dtype=torch.int32, device=d1)
    K.reset_launches()
    calls = [lambda: K.score_fill(g, r, spk, 64, 64),
             lambda: K.convex_fill(g, g, apk, par, y, y, 128),
             lambda: K.convex_backtrack(dirs, y, apk, b, b),
             lambda: K.expand_votes(cum, tab, tab, 64)]
    for call in calls:
        with pytest.raises(ValueError, match="one CUDA device"):
            call()
    assert sum(K.launches.values()) == 0


def test_stdout_dump_on_the_card(dev):
    """--stdout 5 (mapped segments) through the CLI on the card: the
    serial path's one-problem waves, byte for byte against the reference
    binary's dump."""
    import gzip
    import subprocess
    data = os.path.join(REPO, "tests", "data", "test_2")
    env = dict(os.environ, NGMLR_TORCH_DEVICE="cuda", NGMLR_TPU_STRICT="1")
    r = subprocess.run(
        [sys.executable, "-m", "ngmlr_tpu_torch",
         "-r", os.path.join(data, "ref_chr21_20kb.fa"),
         "-q", os.path.join(data, "reads_100_2200bp.fa"), "-x", "pacbio",
         "--stdout", "5", "-o", os.devnull],
        capture_output=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    golden = os.path.join(REPO, "tests", "golden", "dumps",
                          "test_2_stdout5.txt.gz")
    with gzip.open(golden, "rb") as f:
        assert r.stdout == f.read()


@pytest.mark.parametrize("B,L", [(256, 768), (8, 32768)])
def test_expand_votes_kernel_matches_plain(dev, B, L):
    """Rows with no vote, exactly L votes, and all votes in one slot."""
    from chip_smoke import slot_tables
    t = [torch.from_numpy(x).to(dev) for x in slot_tables(
        np.random.default_rng(B), B, L, 1 << 28, ragged=True)]
    n0 = K.launches["expand_votes"]
    got = K.expand_votes(*t, L)
    assert K.launches["expand_votes"] == n0 + 1
    want = K.expand_votes_plain(*t, L)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_device_search_on_the_card_matches_host(dev, tmp_path):
    """The seed-0 input of tests/test_device_search.py (400 kb, 300 mutated
    subreads and two without hits) through DeviceSearch on the card; every
    row-local launch is one expand_votes launch."""
    from ngmlr_tpu_torch.index.kmer_index import KmerIndex
    from ngmlr_tpu_torch.io.reference import ReferenceGenome
    from ngmlr_tpu_torch.seed.candidates import search_batch
    from ngmlr_tpu_torch.seed.device_search import DeviceSearch
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=400_000)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    seqs = []
    for _ in range(300):
        L = int(rng.integers(40, 257))
        pos = int(rng.integers(0, len(genome) - L))
        s = bytearray(genome[pos:pos + L].tobytes())
        for _ in range(L // 10):
            s[int(rng.integers(0, L))] = b"ACGT"[int(rng.integers(0, 4))]
        s = bytes(s)
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        if rng.random() < 0.05:
            s = s[:10] + b"N" * int(rng.integers(1, 5)) + s[10:]
        seqs.append(s)
    seqs += [b"N" * 60, b"ACGT" * 3]
    fa = tmp_path / "ref.fa"
    g = genome.tobytes()
    fa.write_bytes(b">chr1\n" + b"".join(g[i:i + 70] + b"\n"
                                         for i in range(0, len(g), 70)))
    ref = ReferenceGenome.from_fasta(str(fa), use_cache=False)
    idx = KmerIndex.build(ref)
    want = search_batch(idx, seqs)
    ctx = tde.DeviceContext(ref.codes, device=dev)
    tde.set_current(ctx)
    try:
        n0 = K.launches["expand_votes"]
        got = DeviceSearch(idx, device=dev).search_batch(seqs)
        torch.cuda.synchronize()
        n_launch = K.launches["expand_votes"] - n0
    finally:
        tde.set_current(None)
    assert got is not None and len(got) == len(want)
    for i, (h, d) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(h.locations, d.locations, err_msg=str(i))
        np.testing.assert_array_equal(h.reverse, d.reverse, err_msg=str(i))
        np.testing.assert_array_equal(h.counts, d.counts, err_msg=str(i))
        assert h.mq_zero == d.mq_zero, i
    assert n_launch == ctx.stats["search_v2_launches"] > 0


def _search_on_card(dev, idx, seqs, ref_codes):
    """DeviceSearch on the card with a fresh context: (candidates, stats,
    expand_votes launches)."""
    from ngmlr_tpu_torch.seed.device_search import DeviceSearch
    ctx = tde.DeviceContext(ref_codes, device=dev)
    tde.set_current(ctx)
    try:
        n0 = K.launches["expand_votes"]
        got = DeviceSearch(idx, device=dev).search_batch(seqs)
        torch.cuda.synchronize()
        return got, ctx.stats, K.launches["expand_votes"] - n0
    finally:
        tde.set_current(None)


def _assert_same(want, got):
    assert got is not None and len(got) == len(want)
    for i, (h, d) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(h.locations, d.locations, err_msg=str(i))
        np.testing.assert_array_equal(h.reverse, d.reverse, err_msg=str(i))
        np.testing.assert_array_equal(h.counts, d.counts, err_msg=str(i))
        assert h.mq_zero == d.mq_zero, i


def test_device_search_escape_paths_stay_on_the_card(dev, tmp_path,
                                                     monkeypatch):
    """Every path that once handed a batch back to the host now runs on the
    card: with tiny caps (the overflow input of tests/test_device_search.py:
    a 171 bp tandem repeat x 100), rows past E_CAP / NE2 rerun through v1,
    subreads past L_V2_MAX go to v1, and v1 runs past NE_CAP rerun with room
    for all their entries; a group of more than 2^16 votes counts exactly;
    a subread longer than SL raises rather than leave the card."""
    from ngmlr_tpu_torch.index.kmer_index import KmerIndex
    from ngmlr_tpu_torch.io.reference import ReferenceGenome
    from ngmlr_tpu_torch.seed import device_search as tds
    from ngmlr_tpu_torch.seed.candidates import search_batch
    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=200_000)]
    genome[50_000:50_000 + 171 * 100] = np.tile(
        bases[rng.integers(0, 4, size=171)], 100)
    seqs = []
    for _ in range(60):
        L = int(rng.integers(100, 257))
        pos = int(rng.integers(0, len(genome) - L))
        seqs.append(genome[pos:pos + L].tobytes())
    for _ in range(6):
        pos = 50_000 + int(rng.integers(0, 171 * 90))
        seqs.append(genome[pos:pos + 256].tobytes())
    fa = tmp_path / "ref.fa"
    g = genome.tobytes()
    fa.write_bytes(b">chr1\n" + b"".join(g[i:i + 70] + b"\n"
                                         for i in range(0, len(g), 70)))
    ref = ReferenceGenome.from_fasta(str(fa), use_cache=False)
    idx = KmerIndex.build(ref)
    want = search_batch(idx, seqs)
    for caps in ({"E_CAP": 4, "NE2": 64},
                 {"E_CAP": 4, "NE2": 64, "L_V2_MAX": 2048, "NE_CAP": 8}):
        with monkeypatch.context() as m:
            for k, v in caps.items():
                m.setattr(tds, k, v)
            got, st, n_launch = _search_on_card(dev, idx, seqs, ref.codes)
        _assert_same(want, got)
        assert not [k for k in st if k.startswith("search_fallback_")], st
        assert n_launch == st["search_v2_launches"] > 0
        if "L_V2_MAX" in caps:
            assert st["search_v1_outliers"] > 0 and st["search_v1_rerun"] > 0
        else:
            assert st["search_v2_retry"] > 0
        assert st["search_v1_launches"] > 0

    # one group of 253 x 300 = 75,900 votes (k = 4, AAAA at 300 positions
    # inside one 4096-wide bin)
    bs = np.zeros(4 ** 4 + 1, np.int64)
    bs[1:] = 300
    big = KmerIndex(4, bs, np.arange(1000, 1300, dtype=np.uint32), 12, 2)
    seqs = [b"A" * 256, b"ACGT" * 40]
    got, st, _ = _search_on_card(dev, big, seqs, ref.codes)
    _assert_same(search_batch(big, seqs), got)
    assert got[0].counts.max() == 253 * 300

    with pytest.raises(ValueError, match="longer than"):
        _search_on_card(dev, idx, [b"A" * (tds.SL + 1)], ref.codes)


# ---------------------------------------------------------------------------
# --nosse and the oracle modules on the card
# ---------------------------------------------------------------------------

ALIGN4 = ("score_fill", "corridor_windows", "convex_fill", "convex_backtrack")


def _cli_test2(tmp_path, name, extra):
    """test_2 pacbio through cli.main on the card; returns (SAM records,
    the run's kernel launches, the context's stats)."""
    from ngmlr_tpu_torch import cli
    data = os.path.join(REPO, "tests", "data", "test_2")
    out = str(tmp_path / name)
    K.reset_launches()
    rc = cli.main(["-r", os.path.join(data, "ref_chr21_20kb.fa"),
                   "-q", os.path.join(data, "reads_100_2200bp.fa"),
                   "-x", "pacbio", "--no-progress", "-o", out] + extra)
    torch.cuda.synchronize()
    assert rc == 0
    with open(out, "rb") as f:
        recs = [l for l in f.read().split(b"\n") if not l.startswith(b"@PG")]
    return recs, dict(K.launches), dict(tde.current().stats)


def test_nosse_test2_on_the_card(dev, tmp_path, monkeypatch):
    """--nosse maps through the plain versions on the card's own tensors:
    the kernels' SAM (the golden), no alignment kernel launched, the
    device search's expand_votes as in the kernels' run."""
    monkeypatch.setenv("NGMLR_TORCH_DEVICE", "cuda")
    monkeypatch.setenv("NGMLR_TPU_STRICT", "1")
    monkeypatch.delenv("NGMLR_TPU_NO_PALLAS", raising=False)
    want, k_launches, k_stats = _cli_test2(tmp_path, "kernels.sam", [])
    assert k_stats["plain_kernels"] == 0
    assert all(k_launches[k] > 0 for k in k_launches), k_launches
    # cli.main sets the variable for the process: undone after the test
    monkeypatch.setenv("NGMLR_TPU_NO_PALLAS", "")
    got, launches, stats = _cli_test2(tmp_path, "nosse.sam", ["--nosse"])
    assert os.environ["NGMLR_TPU_NO_PALLAS"] == "1"
    assert stats["plain_kernels"] == 1 and stats["align_waves"] > 0
    assert got == want
    with open(os.path.join(REPO, "tests", "golden", "test_2.sam"), "rb") as f:
        assert got == [l for l in f.read().split(b"\n")
                       if not l.startswith(b"@PG")]
    assert {k: launches[k] for k in ALIGN4} == dict.fromkeys(ALIGN4, 0)
    assert launches["expand_votes"] == k_launches["expand_votes"] > 0


def test_run_batch_on_the_card_matches_cpu_and_the_scalar_oracle(dev):
    """tests/test_convex.py:52's 12 problems: run_batch on the card equals
    fill_matrix (score, best cell, every direction in the band) and
    run_batch on the CPU bit for bit."""
    from chip_smoke import fill_cases, fill_diffs
    from ngmlr_tpu_torch.ops.convex import BandSpec, run_batch
    for trial, (ref, qry, offs, width) in enumerate(fill_cases()):
        res, diffs = fill_diffs(ref, qry, offs, width, dev)
        assert diffs == [], trial
        cpu = run_batch([BandSpec(ref, qry, offs, width)], device="cpu")[0]
        assert np.array_equal(res.dirs, cpu.dirs), trial
        assert (res.score, res.best_x, res.best_y) == (
            cpu.score, cpu.best_x, cpu.best_y), trial


def test_engine_matches_the_oracle_on_the_card(dev):
    """tests/test_convex.py:75's 10 problems: align_banded through a
    context on the card (the four CUDA kernels) equals run_batch on the
    card + the host backtrack + convert_cigar."""
    from chip_smoke import align_cases, align_diffs
    K.reset_launches()
    for trial, case in enumerate(align_cases()):
        assert align_diffs(*case, device=dev) == [], trial
    assert all(K.launches[k] > 0 for k in ALIGN4[1:]), K.launches
    assert K.launches["score_fill"] == 0


def test_score_batch_on_the_card(dev):
    from chip_smoke import score_pairs
    from ngmlr_tpu_torch.ops.ungapped import score_batch, score_pair_numpy
    pairs = score_pairs(np.random.default_rng(12), 64)
    got = score_batch([r for r, _ in pairs], [q for _, q in pairs],
                      device=dev)
    want = [score_pair_numpy(r, q) for r, q in pairs]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_native_engine_matches_python_sv(dev, tmp_path, monkeypatch):
    """tests/test_native_engine.py:118 on the card (about 4 minutes on the
    CPU): the first 12 reads of test_3, long noisy reads whose split and
    realign paths run through the engine's waves, give the same bytes
    through the native engine and the Python path."""
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.io.fastx import parse_fastx
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    data = os.path.join(REPO, "tests", "data", "test_3")
    reads_p = str(tmp_path / "sv12.fa")
    with open(reads_p, "wb") as f:
        for i, rec in enumerate(parse_fastx(os.path.join(data,
                                                         "read.fa.gz"))):
            if i >= 12:
                break
            f.write(b">" + rec.name + b"\n" + rec.seq + b"\n")
    argv = ["-r", os.path.join(data, "reference.fasta.gz"), "-q", reads_p]
    outs = []
    for native in ("1", "0"):
        monkeypatch.setenv("NGMLR_TPU_NATIVE", native)
        args = build_parser().parse_args(argv)
        p = Pipeline(config_from_args(args, argv), args.reference,
                     use_cache=False, device=dev)
        assert (p.native is not None) == (native == "1")
        buf = io.BytesIO()
        p.run(reads_p, buf)
        assert p.ctx.stats.get("native_failed", 0) == 0
        outs.append([l for l in buf.getvalue().split(b"\n")
                     if not l.startswith(b"@PG")])
    assert outs[0] == outs[1]
    assert len(outs[0]) > 12


def test_bench_on_the_card(dev, tmp_path):
    """scripts/torch_bench.py pinned at 1 Mbp with 32 reads, its line held
    as chip_smoke.py's phase 11 holds it."""
    proc = run_bench(str(tmp_path), 1.0, BENCH_READS="32")
    line = check_bench_line("bench", proc, card_line())
    assert line["genome_mbp"] == 1.0 and line["n_reads"] == 32
    assert len(line["pass_s"]) == 3 and line["peak_device_bytes"] > 0


def test_fuzz_seed_501_on_the_card(dev, tmp_path, monkeypatch):
    """The first 48 reads of the SV-rich fuzz's seed 501, mapped three
    ways on one Pipeline (the device search, the host search, the device
    search at 20-read batches), each SAM equal to the committed JAX SAM's
    prefix; map_seed holds each mapping's launches to its engine's
    record."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_fuzz_vs_jax as F
    monkeypatch.delenv("NGMLR_TPU_DEVICE_SEARCH", raising=False)
    want = F.committed_sam(501, "pacbio", 48)
    ref, reads = F.dataset(501, 48, str(tmp_path))
    p, _ = F.port_pipeline(ref, "pacbio")
    assert p.dev_search is not None
    runs = F.map_seed(p, reads)
    assert [r["search"] for r in runs.values()] == ["device", "host",
                                                     "device"]
    for name, run in runs.items():
        assert run["sam"] == want, name
        st = run["stats"]
        assert st["native_waves"] == st["engine_waves"] > 0, name
    assert runs["gate"]["launches"]["expand_votes"] > 0


def test_scale_script_holds_phase4_and_svlong_on_the_card(dev, tmp_path,
                                                         monkeypatch):
    """scripts/torch_scale_vs_jax.py's card mode on phase4 and svlong: each
    mapped with the device search and the host search on one Pipeline,
    every read and the whole file equal to the JAX package's digests, the
    native engine's waves, launches its engine's record."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_scale_vs_jax as S
    monkeypatch.delenv("NGMLR_TPU_DEVICE_SEARCH", raising=False)
    code, rec = S.scale_datasets({"phase4", "svlong"}, "cuda", None,
                                 str(tmp_path), S.load_digests())
    assert code == 0
    for name in ("phase4", "svlong"):
        runs = rec[name]
        assert [r["search"] for r in runs.values()] == ["device", "host"]
        for r in runs.values():
            assert r["diff"] == 0 and r["file_identical"]
            assert r["identical"] == r["reads"] > 0
            assert r["native_waves"] == r["engine_waves"] > 0
        assert runs["gate"]["launches"]["expand_votes"] > 0


def test_scale_script_holds_ultralong_on_the_card(dev, tmp_path,
                                                  monkeypatch):
    """scripts/torch_scale_vs_jax.py's card mode on ultralong (36 reads of
    50-250 kb): mapped with the device search and the host search on one
    Pipeline, every read and the whole file equal to the JAX package's
    digests, with the fill's lane classes, the largest launch's direction
    bytes (at most DIRS_CAP's 4 GiB), the refused rows and the peak device
    memory reported; then tests/data/test_8 (--test8) held to its golden
    with the same numbers."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_scale_vs_jax as S
    monkeypatch.delenv("NGMLR_TPU_DEVICE_SEARCH", raising=False)
    monkeypatch.delenv("NGMLR_TPU_DIRS_CAP_GB", raising=False)
    code, rec = S.scale_datasets({"ultralong"}, "cuda", None, str(tmp_path),
                                 S.load_digests())
    assert code == 0
    runs = rec["ultralong"]
    assert [r["search"] for r in runs.values()] == ["device", "host"]
    for r in runs.values():
        assert r["diff"] == 0 and r["file_identical"]
        assert r["identical"] == r["reads"] == S.UL_READS
        assert 0 < r["dirs_max_bytes"] <= 4 << 30
        assert r["peak_device_bytes"] > r["dirs_max_bytes"]
        assert sum(r["lane_classes"].values()) == r["launches"]["convex_fill"]
        assert r["dirs_cap_refused"] == len(r["refused_rows"])
        assert r["native_waves"] == r["engine_waves"] > 0
    assert runs["gate"]["launches"]["expand_votes"] > 0
    rec, held = S.test8_lanes("cuda")
    assert held and rec["identical"] == rec["reads"] > 0
    assert rec["native_waves"] == rec["engine_waves"] > 0
    assert sum(rec["lane_classes"].values()) == rec["launches"]["convex_fill"]


def test_options_script_holds_the_fuzzq_sets_on_the_card(dev, tmp_path,
                                                         monkeypatch):
    """scripts/torch_options_vs_jax.py's card mode on fuzzq (seed 501's
    fuzz dataset as FASTQ.gz) under every set that maps it: the gate's
    search (the device search; sub512 the host search), the other search
    (sub512: 20-read batches) and 20-read batches, readgroup also through
    the CLI's -o *.sam.gz, every read, QUAL included, and each file equal
    to the JAX package's digests; the default set's cross-check against
    seed 501's committed SAM with QUAL masked."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_options_vs_jax as O
    monkeypatch.delenv("NGMLR_TPU_DEVICE_SEARCH", raising=False)
    keys = [k for k in O.pairs() if k[1] == "fuzzq"]
    code, rec = O.options_run(keys, "cuda", None, str(tmp_path),
                              O.load_digests())
    assert code == 0
    for name, _ in keys:
        runs = {m: r for m, r in rec["%s/fuzzq" % name].items()
                if m not in ("setup", "cross_check")}
        gate = "host" if name == O.HOST_GATE else "device"
        assert runs["gate"]["search"] == gate
        for r in runs.values():
            assert r["diff"] == 0 and r["file_identical"]
            assert r["identical"] == r["reads"] == 150
            assert r["native_waves"] == r["engine_waves"] > 0
        if gate == "device":
            assert runs["other search"]["search"] == "host"
            assert runs["gate"]["launches"]["expand_votes"] > 0
    assert rec["default/fuzzq"]["cross_check"][
        "fuzzq_default_vs_seed501"]["diff"] == []
