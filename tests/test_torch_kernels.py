"""The port's kernel path (ngmlr_tpu_torch.ops, plain PyTorch versions on
the CPU) against the JAX reference (ngmlr_tpu.ops.device_engine), bit for
bit: the score fill against _score_kernel(impl="scan"), the corridor
windows against the Pallas kernel in interpret mode and the histogram twin,
and the fused convex chain (windows -> fill -> backtrack + 2-bit pack)
against _convex_kernel(impl="scan") on the [B, 7] scalars and the flat
packed ops. Inputs are made from numpy seeds and handed to both packages.
"""

import io
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ngmlr_tpu.align import aligner as jal
from ngmlr_tpu.ops import device_engine as jde
from ngmlr_tpu.ops.pallas_kernels import corridor_windows as pallas_cw
from ngmlr_tpu_torch.align import aligner as tal
from ngmlr_tpu_torch.ops import device_engine as tde
from ngmlr_tpu_torch.ops import kernels as K

from chip_smoke import FILL_EDGES, fill_edge_case
from test_corridor_windows import hist_windows

torch.set_num_threads(1)

PARAMS = np.asarray([2.0, -5.0, -5.0, -5.0, -1.0, 0.15], np.float32)
G = 200_000
R = 1 << 15


def _buffers(seed):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 5, size=G).astype(np.uint8)
    readbuf = rng.integers(0, 5, size=R).astype(np.uint8)
    return rng, genome, readbuf


def _mutate(rng, codes):
    """~15% PacBio-like error over codes 0..3: 10% insertions, 4%
    deletions, 1% substitutions."""
    r = rng.random(len(codes))
    out = []
    for c, v in zip(codes.tolist(), r.tolist()):
        if v < 0.10:
            out += [int(rng.integers(0, 4)), c]
        elif v < 0.14:
            continue
        elif v < 0.15:
            out.append(int(rng.integers(0, 4)))
        else:
            out.append(c)
    return np.asarray(out, np.uint8)


def _align_rows(rng, genome, readbuf, B, Wr, Hr, widths, modes, plant=()):
    """Align rows [B, 12] with the geometry of scripts/check_kernels.py;
    rows listed in `plant` get a mutated copy of their reference window
    written into readbuf (reverse-complemented for rev rows), so their
    backtrack walks a long path."""
    pk = np.zeros((B, 12), np.int32)
    pku = pk.view(np.uint32)
    pkf = pk.view(np.float32)
    q_next = 0
    for b in range(B):
        W = int(rng.integers(*Wr))
        H = int(rng.integers(*Hr))
        ds = int(rng.integers(0, G - W - 1))
        qs = int(rng.integers(0, R - H - 1))
        rev = b & 1
        if b in plant:
            q = np.minimum(_mutate(rng, np.minimum(genome[ds:ds + W], 3)),
                           3)[:Hr[1] - 1]
            H, qs = len(q), q_next
            readbuf[qs:qs + H] = (q ^ 1)[::-1] if rev else q
            q_next += H
        mode = int(modes[b % len(modes)])
        width = int(rng.integers(*widths))
        if mode == jde.CORRIDOR_FULL:
            w = W + 1
            ci = int(np.float32(w) * np.float32(-0.2))
            width = w + int(np.float32(w) * np.float32(0.2))
            cf = (1.0, 0.0)
        elif mode == jde.CORRIDOR_LINEAR:
            ci = width // 2
            cf = (1.0, 0.0)
        else:
            ci = 0
            cf = (float(np.float32(H) / np.float32(W)),
                  float(np.float32(width) / np.float32(2.0)))
        pku[b, 0], pku[b, 1] = ds, ds + W
        pk[b, 2:10] = (0, W, qs, H, rev, mode, ci, width)
        pkf[b, 10:12] = cf
    return pk


def _convex_both(genome, readbuf, pk, Wp, Hp, L):
    """(port, JAX scan) results of the fused convex chain as numpy."""
    jp, js = jde._convex_kernel(jnp.asarray(genome), jnp.asarray(readbuf),
                                jnp.asarray(pk), jnp.asarray(PARAMS),
                                Wp=Wp, Hp=Hp, L=L, impl="scan")
    tp, ts = tde._convex_kernel(torch.from_numpy(genome),
                                torch.from_numpy(readbuf),
                                torch.from_numpy(pk), torch.from_numpy(PARAMS),
                                Wp=Wp, Hp=Hp, L=L)
    return (tp.numpy(), ts.numpy()), (np.asarray(jp), np.asarray(js))


# ---------------------------------------------------------------------------
# score_fill
# ---------------------------------------------------------------------------

def _score_rows(rng, P, W, qlen):
    pk = np.zeros((P, 7), np.int32)
    pku = pk.view(np.uint32)
    ds = rng.integers(0, G - W - 8, P)
    pku[:, 0] = ds
    pku[:, 1] = ds + W - rng.integers(0, 8, P)     # a few 'x' tails
    pk[:, 2] = rng.integers(0, 6, P)               # leading 'x' codes
    pk[:, 3] = W
    pk[:, 4] = rng.integers(0, R - qlen, P)
    pk[:, 5] = qlen
    pk[:, 6] = np.arange(P) & 1
    return pk


@pytest.mark.parametrize("W,qlen,Rp,Qp", [(306, 256, 320, 256),
                                          (40, 50, 64, 64),
                                          (700, 130, 1024, 256)])
def test_score_fill_matches_jax_scan(W, qlen, Rp, Qp):
    rng, genome, readbuf = _buffers(3)
    pk = _score_rows(rng, 64, W, qlen)
    # the first query is a copy of its reference window: a long match
    ds = int(pk.view(np.uint32)[0, 0])
    readbuf[pk[0, 4]:pk[0, 4] + qlen] = np.minimum(genome[ds:ds + qlen], 3)
    pk[0, 2] = 0
    want = np.asarray(jde._score_kernel(
        jnp.asarray(genome), jnp.asarray(readbuf), jnp.asarray(pk),
        Rp=Rp, Qp=Qp, impl="scan"))
    got = K.score_fill(torch.from_numpy(genome), torch.from_numpy(readbuf),
                       torch.from_numpy(pk), Rp, Qp).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert want[0] >= 10


def test_score_wave_np_matches_jax_context():
    """Bucketing, padding and the MAX_SEQ_LEN guard of score_wave_np."""
    rng, genome, readbuf = _buffers(5)
    pk = np.concatenate([_score_rows(rng, 20, 306, 256),
                         _score_rows(rng, 7, 90, 40),
                         _score_rows(rng, 5, 600, 300)])
    pk[3, 5] = jde.MAX_SEQ_LEN            # past the ssw guard: scores -1
    pk = pk[rng.permutation(len(pk))]
    jctx = jde.DeviceContext(genome)
    jctx.upload_reads(readbuf)
    tctx = tde.DeviceContext(genome, device="cpu")
    tctx.upload_reads(readbuf)
    want = jctx.score_wave_np(pk)
    got = tctx.score_wave_np(pk)
    np.testing.assert_array_equal(got, want)
    assert (got == -1.0).sum() == 1
    assert tctx.stats["score_waves"] == 3


# ---------------------------------------------------------------------------
# corridor_windows
# ---------------------------------------------------------------------------

def test_corridor_windows_matches_pallas_and_hist():
    """The cases of tests/test_corridor_windows.py: all four modes, width
    <= 0 rows and H = 0 rows."""
    f32 = np.float32
    rng = np.random.default_rng(11)
    B, Tp = 128, 1024
    mode = rng.integers(0, 4, B).astype(np.int32)
    W = rng.integers(1, 400, B).astype(np.int32)
    H = rng.integers(0, 400, B).astype(np.int32)
    width = rng.integers(1, 300, B).astype(np.int32)
    width[64:80] = 0
    width[80:88] = -rng.integers(1, 50, 8).astype(np.int32)
    ci = rng.integers(-50, 200, B).astype(np.int32)
    k = rng.uniform(0.05, 3.0, B).astype(np.float32)
    d = rng.uniform(-100.0, 100.0, B).astype(np.float32)
    mode[:2] = (jde.CORRIDOR_ANCHORS, jde.CORRIDOR_ENDPOINTS)
    W[:2], H[:2], width[:2] = (380, 380), (350, 350), (190, 95)
    k[:2] = (f32(350) / f32(380), f32(350) / f32(380))
    d[:2] = (95.0, -10.0)

    scal = np.zeros((8, B), np.int32)
    scal[0], scal[1], scal[2], scal[3], scal[4] = mode, ci, width, W, H
    scal[5] = k.view(np.int32)
    scal[6] = d.view(np.int32)
    pal_min, pal_max = pallas_cw(jnp.asarray(scal), Tp, K=128, GU=8,
                                 interpret=True)
    hist_min, hist_max = hist_windows(mode, ci, width, W, H, k, d, Tp)

    pk = np.zeros((B, 12), np.int32)
    pk[:, 3], pk[:, 5], pk[:, 7], pk[:, 8], pk[:, 9] = W, H, mode, ci, width
    pk[:, 10], pk[:, 11] = k.view(np.int32), d.view(np.int32)
    ymin, ymax, hmax = (a.numpy() for a in
                        K.corridor_windows(torch.from_numpy(pk), Tp))
    np.testing.assert_array_equal(ymin, np.asarray(pal_min).T)
    np.testing.assert_array_equal(ymax, np.asarray(pal_max).T)
    np.testing.assert_array_equal(ymin, hist_min)
    np.testing.assert_array_equal(ymax, hist_max)
    np.testing.assert_array_equal(hmax, (hist_max - hist_min + 1).max(axis=1))


# ---------------------------------------------------------------------------
# convex fill + backtrack (the fused chain)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modes", [(0,), (1,), (2,), (3,), (0, 1, 2, 3)],
                         ids=["full", "linear", "endpoints", "anchors",
                              "mixed"])
def test_convex_matches_jax_scan(modes):
    rng, genome, readbuf = _buffers(7 + modes[0] + len(modes))
    B, Wp, Hp, L = 8, 512, 512, 128
    pk = _align_rows(rng, genome, readbuf, B, (200, 500), (100, 500),
                     (24, 120), modes, plant=range(0, B, 2))
    (tp, ts), (jp, js) = _convex_both(genome, readbuf, pk, Wp, Hp, L)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    # the planted rows really align, and some backtracks succeeded
    best = ts[:, 0].view(np.float32)
    assert best[0::2].min() > best[1::2].max()
    assert ts[:, 5].sum() >= 2


def test_convex_wide_lanes_match_jax_scan():
    """A reduced wide case (L = 1536, a retry/realign lane class): a FULL
    corridor whose windows pass 1024 rows, and an ENDPOINTS one as in
    scripts/check_kernels.py."""
    rng, genome, readbuf = _buffers(21)
    B, Wp, Hp, L = 2, 2048, 2048, 1536
    pk = _align_rows(rng, genome, readbuf, B, (1100, 1250), (1100, 2000),
                     (L - 200, L - 3), (jde.CORRIDOR_FULL,
                                        jde.CORRIDOR_ENDPOINTS), plant=(0,))
    (tp, ts), (jp, js) = _convex_both(genome, readbuf, pk, Wp, Hp, L)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    assert ts[0, 6] > 1024                # the window really is wide
    assert ts[0, 5] == 1


@pytest.mark.parametrize("case", list(FILL_EDGES))
def test_convex_fill_edges_match_jax_scan(case):
    """chip_smoke's convex_fill edge cases, which the card holds bit for bit
    against the plain fill, through the port's plain chain and the JAX scan
    chain: so the card's cases are known right, not only self-consistent."""
    genome, readbuf, pk, Wp, Hp, L = fill_edge_case(case)
    (tp, ts), (jp, js) = _convex_both(genome, readbuf, pk, Wp, Hp, L)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)


def test_convex_fill_edge_matches_pallas_interpret():
    """Eight rows of the L128 edge case (every row kind but one) through
    the Pallas chain in TPU interpret mode, as scripts/check_kernels.py runs
    it without a TPU, against the port's plain chain."""
    from jax.experimental.pallas import tpu as pltpu
    genome, readbuf, pk, Wp, Hp, L = fill_edge_case("L128")
    pk = np.ascontiguousarray(pk[:8])
    with pltpu.force_tpu_interpret_mode():
        jp, js = jde._convex_kernel(
            jnp.asarray(genome), jnp.asarray(readbuf), jnp.asarray(pk),
            jnp.asarray(PARAMS), Wp=Wp, Hp=Hp, L=L, impl="pallas", K=128, BT=8)
    tp, ts = tde._convex_kernel(torch.from_numpy(genome),
                                torch.from_numpy(readbuf),
                                torch.from_numpy(pk), torch.from_numpy(PARAMS),
                                Wp=Wp, Hp=Hp, L=L)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_align_wave_matches_jax_context():
    """align_dispatch_pk / align_finalize_pk end to end (lane classes, pow2
    buckets, padding rows) against the JAX DeviceContext."""
    rng, genome, readbuf = _buffers(13)
    pk = np.concatenate([
        _align_rows(rng, genome, readbuf, 5, (200, 500), (100, 300),
                    (24, 200), (0, 1, 2, 3), plant=(0, 1, 2)),
        _align_rows(rng, genome, readbuf, 3, (600, 900), (300, 600),
                    (200, 300), (2, 3))])
    jctx = jde.DeviceContext(genome)
    jctx.upload_reads(readbuf)
    tctx = tde.DeviceContext(genome, device="cpu")
    tctx.upload_reads(readbuf)
    params = tuple(float(p) for p in PARAMS)
    want = jctx.align_finalize_pk(jctx.align_dispatch_pk(pk, params))
    got = tctx.align_finalize_pk(tctx.align_dispatch_pk(pk, params))
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[6], want[6]):
        np.testing.assert_array_equal(g, w)
    assert tctx.stats["align_waves"] == jctx.stats["align_waves"]
    assert tctx.stats["alignment_ok"] == jctx.stats["alignment_ok"] > 0


# ---------------------------------------------------------------------------
# the lane bound and its retry
# ---------------------------------------------------------------------------

def _realized_hmax(offs, width, W, H):
    lo = np.clip(offs, 0, W)
    hi = np.maximum(np.clip(offs + width, 0, W), lo)
    y = np.arange(H, dtype=np.int64)
    t = np.arange(W + H)
    ymin = np.searchsorted(np.sort(y + hi), t, side="right")
    ymax = np.searchsorted(np.sort(y + lo), t, side="right") - 1
    return int(np.max(ymax - ymin + 1))


def _random_corridors(rng, n=40):
    """n random geometries over the four corridor generators: (W, H, the
    port's corridor, the reference's corridor)."""
    for _ in range(n):
        W = int(rng.integers(50, 4000))
        H = int(rng.integers(30, 4000))
        width = int(rng.integers(8, 1200))
        kind = rng.integers(0, 4)
        if kind == 0:
            cs = [m.corridor_full(W + 1) for m in (tal, jal)]
        elif kind == 1:
            cs = [m.corridor_linear(width) for m in (tal, jal)]
        elif kind == 2:
            fwd = bool(rng.integers(0, 2))
            cs = [m.corridor_endpoints(width, W, H, fwd) for m in (tal, jal)]
        else:
            class A:
                is_reverse = False

            class IV:
                on_ref_start = 0
                anchors = []
            iv = IV()
            for _ in range(int(rng.integers(1, 6))):
                a = A()
                a.on_ref = int(rng.integers(0, W))
                a.on_read = int(rng.integers(0, max(1, H - 256)))
                iv.anchors.append(a)
            mult = int(rng.integers(1, 4))
            cs = [m.corridor_with_anchors(iv, mult, W, H, 0, 256, H)
                  for m in (tal, jal)]
        yield (W, H) + tuple(cs)


@pytest.mark.parametrize("seed", range(5))
def test_lane_bound_covers_random_geometries(seed):
    """The port's _lane_bound upper-bounds the realized window height and
    agrees with the reference's, for every corridor generator."""
    for W, H, tc, jc in _random_corridors(np.random.default_rng(seed)):
        assert (tc.mode, tc.cf, tc.ci, tc.width) == (jc.mode, jc.cf, jc.ci,
                                                      jc.width)
        offs = tal.materialize_offsets(tc, H)
        np.testing.assert_array_equal(offs, jal.materialize_offsets(jc, H))
        tb = tde.DeviceContext._lane_bound(tde.AlignProblem(
            tde.RefDesc(0, 0, W, W), tde.QryDesc(0, H, False),
            tc.mode, tc.cf, tc.ci, tc.width))
        jb = jde.DeviceContext._lane_bound(jde.AlignProblem(
            jde.RefDesc(0, 0, W, W), jde.QryDesc(0, H, False),
            jc.mode, jc.cf, jc.ci, jc.width))
        assert tb == jb
        assert _realized_hmax(offs, tc.width, W, H) <= tb


def _assert_keys_increase(pk):
    """The precondition of the corridor_windows kernel
    (csrc/corridor_windows.cu): over y < H the keys y + lo(y) and
    y + hi(y), computed as the plain version computes them, increase
    strictly in every align row."""
    c = K._align_cols(torch.from_numpy(np.ascontiguousarray(pk)))
    Hn = max(int(c["H"].max()), 1)
    y = torch.arange(Hn, dtype=torch.int32)[None, :]
    offs = K.corridor_offs(c["mode"], c["ci"], c["k"], c["d"], y)
    W = c["W"].to(torch.int32)[:, None]
    zero = torch.zeros_like(W)
    lo = torch.clamp(offs, zero, W)
    hi = torch.maximum(torch.clamp(offs + c["width"][:, None], zero, W), lo)
    key_lo, key_hi = (y + lo).long().numpy(), (y + hi).long().numpy()
    for b, H in enumerate(c["H"].tolist()):
        for key in (key_lo[b, :H], key_hi[b, :H]):
            assert (np.diff(key) >= 1).all(), (b, pk[b].tolist())


@pytest.mark.parametrize("seed", range(5))
def test_corridor_keys_increase_for_every_generator(seed):
    """The rows of test_lane_bound_covers_random_geometries, packed as the
    engine packs them (align_dispatch)."""
    rows = []
    for W, H, tc, _ in _random_corridors(np.random.default_rng(seed)):
        row = np.zeros(12, np.int32)
        row[3], row[5], row[7:10] = W, H, (tc.mode, tc.ci, tc.width)
        row[10:12] = np.asarray(tc.cf, np.float32).view(np.int32)
        rows.append(row)
    pk = np.stack(rows)
    assert set(pk[:, 7].tolist()) == {0, 1, 2, 3}
    _assert_keys_increase(pk)


def test_corridor_keys_increase_in_every_align_wave(monkeypatch):
    """Every align wave that test_2 (pacbio) sends through the port on the
    CPU, caught at kernels.corridor_windows."""
    from conftest import DATA_DIR
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    waves = []
    cw = K.corridor_windows

    def spy(pk, TpP):
        waves.append(pk.numpy().copy())
        return cw(pk, TpP)
    monkeypatch.setattr(K, "corridor_windows", spy)
    argv = ["-r", os.path.join(DATA_DIR, "test_2/ref_chr21_20kb.fa"),
            "-q", os.path.join(DATA_DIR, "test_2/reads_100_2200bp.fa")]
    args = build_parser().parse_args(argv)
    p = Pipeline(config_from_args(args, argv), args.reference,
                 use_cache=False, device="cpu")
    p.run(args.query, io.BytesIO())
    assert len(waves) == p.ctx.stats["align_waves"] > 0
    modes = set()
    for pk in waves:
        _assert_keys_increase(pk)
        modes |= set(pk[:, 7].tolist())
    assert len(modes) >= 2, modes


def test_lane_bound_retry_reruns_conservatively():
    """A launch whose lane class is below a problem's realized window
    height (hmax > L) is re-run at the conservative width + 3 lanes, and
    the spliced result equals a conservative run and the reference's."""
    rng, genome, readbuf = _buffers(17)
    pk = _align_rows(rng, genome, readbuf, 3, (400, 500), (300, 400),
                     (24, 60), (jde.CORRIDOR_FULL, 2, 1), plant=(0, 1, 2))
    params = tuple(float(p) for p in PARAMS)
    tctx = tde.DeviceContext(genome, device="cpu")
    tctx.upload_reads(readbuf)
    Wp = Hp = 512
    L = 128                                # FULL: width ~ 1.2 W > 128
    B = 8
    blk = np.zeros((B, 12), np.int32)
    blk[:, 9] = 1
    blk.view(np.float32)[:, 10] = 1.0
    blk[:3] = pk
    packed, scalars = tde._convex_kernel(
        tctx.genome, tctx.readbuf.primary, torch.from_numpy(blk),
        tctx._params_vec(params), Wp=Wp, Hp=Hp, L=L)
    assert int(scalars[0, 6]) > L and int(scalars[1:3, 6].max()) <= L
    pend = (pk, [(np.arange(3), packed, scalars, L, (Wp + Hp) // 4, None)],
            params, tctx.readbuf, [])
    got = tctx.align_finalize_pk(pend)
    assert tctx.stats["lane_bound_retries"] == 1
    cons = tctx.align_finalize_pk(tctx.align_dispatch_pk(
        pk[:1], params, conservative_L=True))
    for g, c in zip(got[:6], cons[:6]):
        assert g[0] == c[0]
    np.testing.assert_array_equal(got[6][0], cons[6][0])
    jctx = jde.DeviceContext(genome)
    jctx.upload_reads(readbuf)
    want = jctx.align_finalize_pk(jctx.align_dispatch_pk(pk, params))
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[6], want[6]):
        np.testing.assert_array_equal(g, w)


def test_wrappers_check_their_inputs():
    """Each wrapper refuses a wrong dtype, shape or device instead of
    launching (or running its plain version) on it."""
    _, genome, readbuf = _buffers(1)
    g, r = torch.from_numpy(genome), torch.from_numpy(readbuf)
    spk = torch.zeros((8, 7), dtype=torch.int32)
    apk = torch.zeros((8, 12), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.score_fill(g, r, spk.long(), 64, 64)
    with pytest.raises(ValueError):
        K.score_fill(g, r, apk, 64, 64)
    with pytest.raises(ValueError):
        K.score_fill(g, r, apk[:, :7], 64, 64)        # not contiguous
    with pytest.raises(ValueError):
        K.corridor_windows(apk.to("meta"), 512)       # neither CPU nor CUDA
    ymin = torch.zeros((8, 512), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.convex_fill(g, r, apk, torch.from_numpy(PARAMS), ymin,
                      ymin[:4], 128)
    dirs = torch.zeros((8, 512, 128), dtype=torch.uint8)
    b = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.convex_backtrack(dirs, ymin[:, :256], apk, b, b)
    assert sum(K.launches.values()) == 0           # nothing was launched
