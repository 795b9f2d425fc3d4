"""The five hand-written CUDA kernels of the port: their wrappers, their
plain PyTorch versions and their launch counters.

  * score_fill        csrc/score_fill.cu        ungapped candidate scores
  * corridor_windows  csrc/corridor_windows.cu  per-wavefront row windows
  * convex_fill       csrc/convex_fill.cu       banded convex-gap fill
  * convex_backtrack  csrc/convex_backtrack.cu  reverse walk + 2-bit pack
  * expand_votes      csrc/expand_votes.cu      device-search vote expansion

Each wrapper takes its inputs on one device. On a CUDA tensor it launches
the kernel (built at first use by ops/build.py) with the inputs' device
current, on that device's current stream, checks the launch and adds one
to ``launches[name]``; it never falls back.
On a CPU tensor it runs the plain version, the same arithmetic written as
tensor code after the JAX reference's XLA twins
(ngmlr_tpu/ops/device_engine.py), which the CPU tests hold bit for bit
against the reference. Any other device raises.

The alignment kernels take the packed int32 problem rows of the engine:
  score rows [P, 7]:  ds u32, hi u32, diff, W, qstart, qlen, qrev
  align rows [B, 12]: the same seven, then corridor mode, ci, width,
                      k f32 bits, d f32 bits
so they gather reference and query codes from the genome and the read
buffer themselves. Bits 28+ of W name the row's genome unit: the genome
is one plane u8 [G] (unit 0) or a stack of unit planes u8 [U, planeP],
and the kernels get the plane stride, genome.shape[-1]. expand_votes
takes the per-row slot tables of the device candidate search
(seed/device_search.py).
"""

import threading

import torch
import torch.nn.functional as F

from .types import (STOP, DIAG, INS, DEL, XCODE, NCODE, CORRIDOR_FULL,
                    CORRIDOR_LINEAR, CORRIDOR_ENDPOINTS)

WALK, DONE, FAIL = 0, 1, 2
W_MASK = (1 << 28) - 1
BIG = 1 << 30

# kernel launches per wrapper since the last reset_launches(); the
# pipeline launches from several threads, so updates take the lock
launches = {"score_fill": 0, "corridor_windows": 0, "convex_fill": 0,
            "convex_backtrack": 0, "expand_votes": 0}
_launches_lock = threading.Lock()


def reset_launches():
    with _launches_lock:
        for k in launches:
            launches[k] = 0


# ---------------------------------------------------------------------------
# wrapper plumbing
# ---------------------------------------------------------------------------

def _on_cuda(name, *tensors) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on a mix, on
    inputs split across two cards or on any other device."""
    devs = {t.device for t in tensors}
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"} \
            or (kinds == {"cuda"} and len(devs) != 1):
        raise ValueError("%s: inputs must all lie on the CPU or all on one "
                         "CUDA device, got %s"
                         % (name, sorted(str(d) for d in devs)))
    return kinds == {"cuda"}


def _need(name, arg, t, dtype, ndim, cols=None):
    """ndim: the number of dims, or a tuple of the numbers allowed."""
    dims = ndim if isinstance(ndim, tuple) else (ndim,)
    if t.dtype != dtype or t.dim() not in dims:
        raise TypeError("%s: %s must be %s with %s dims, got %s %s"
                        % (name, arg, dtype, " or ".join(map(str, dims)),
                           t.dtype, tuple(t.shape)))
    if cols is not None and t.shape[-1] != cols:
        raise ValueError("%s: %s must have %d columns, got %s"
                         % (name, arg, cols, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: %s must be contiguous" % (name, arg))


def _launch(name, dev, fn, *args):
    """Launch fn(*args, stream) with dev current, on dev's current stream:
    the kernels' launches and their per-device attribute opt-ins go to the
    runtime's current device."""
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("%s: kernel launch failed (cudaError %d)"
                           % (name, rc))
    with _launches_lock:
        launches[name] += 1


def _lib():
    from .build import get_lib
    return get_lib()


# ---------------------------------------------------------------------------
# plain-version helpers (the XLA twins' gathers and corridor generators)
# ---------------------------------------------------------------------------

def _u32(col):
    return col.to(torch.int64) & 0xFFFFFFFF


def _f2i(v):
    """trunc(f32) -> int32 with XLA's saturating conversion (NaN -> 0),
    which the CUDA kernels reproduce with __float2int_rz."""
    v = torch.trunc(v)
    out = v.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    out = torch.where(v >= 2147483648.0, 2147483647, out)
    return torch.where(torch.isnan(v), 0, out)


def gather_ref(genome, ds, diff, hi, W, Wp: int, unit=None):
    """[B, Wp] reference window codes per the RefDesc rule: the code at
    ds + i - diff of the row's genome plane when diff <= i < W and below
    hi, else XCODE. genome: u8 [G], one plane, or [U, planeP], the unit
    planes; unit: each row's plane (None: plane 0). A position clamps to
    its plane's last byte, as the reference's _gather_ref clamps it."""
    plane = genome.shape[-1]
    i = torch.arange(Wp, device=genome.device)[None, :]
    rel = i - diff[:, None]
    pos = ds[:, None] + rel
    valid = (rel >= 0) & (i < W[:, None]) & (pos < hi[:, None])
    idx = pos.clamp(0, plane - 1)
    if unit is not None:
        idx = idx + unit[:, None] * plane
    codes = genome.reshape(-1)[idx]
    return torch.where(valid, codes, XCODE)


def gather_qry(readbuf, start, length, rev, Qp: int):
    """[B, Qp] query codes: the read slice, reverse-complemented iff rev,
    NCODE past its length."""
    j = torch.arange(Qp, device=readbuf.device)[None, :]
    r = rev[:, None] == 1
    src = torch.where(r, length[:, None] - 1 - j, j)
    valid = (j < length[:, None]) & (src >= 0)
    codes = readbuf[(start[:, None] + src).clamp(0, readbuf.numel() - 1)]
    codes = torch.where(r & (codes < 4), codes ^ 1, codes)
    return torch.where(valid, codes, NCODE)


def corridor_offs(mode, ci, k, d, y):
    """Per-row corridor offsets of the four affine generators, f32-exact
    vs the host generators. mode/ci int32 [B]; k/d f32 [B]; y int32 [B, n]
    (or broadcastable). Returns int32."""
    yf = y.to(torch.float32)
    m = mode[:, None]
    endpoints = _f2i((yf - d[:, None]) / k[:, None])
    anchors = _f2i(yf / k[:, None] - d[:, None])
    return torch.where(
        m == CORRIDOR_FULL, ci[:, None].to(torch.int32).expand_as(endpoints),
        torch.where(m == CORRIDOR_LINEAR, (y - ci[:, None]).to(torch.int32),
                    torch.where(m == CORRIDOR_ENDPOINTS, endpoints, anchors)))


def _unit(pk):
    """Each row's genome plane: bits 28+ of its W column."""
    return _u32(pk[:, 3]) >> 28


def _align_cols(pk):
    """Named int64 / f32 columns of align rows [B, 12]."""
    return dict(
        ds=_u32(pk[:, 0]), hi=_u32(pk[:, 1]), diff=pk[:, 2].long(),
        W=(pk[:, 3] & W_MASK).long(), unit=_unit(pk), qs=pk[:, 4].long(),
        H=pk[:, 5].long(), rev=pk[:, 6], mode=pk[:, 7], ci=pk[:, 8], width=pk[:, 9],
        k=pk[:, 10].view(torch.float32), d=pk[:, 11].view(torch.float32))


# ---------------------------------------------------------------------------
# score_fill
# ---------------------------------------------------------------------------

def score_fill(genome, readbuf, pk, Rp: int, Qp: int):
    """Best ungapped local-segment score of every score row, over the padded
    Rp x Qp bucket. genome u8 [G] or unit planes [U, planeP] (each row's
    unit, bits 28+ of its W column, below U); readbuf u8 [R]; pk int32
    [P, 7]. Returns f32 [P]."""
    name = "score_fill"
    _need(name, "pk", pk, torch.int32, 2, 7)
    _need(name, "genome", genome, torch.uint8, (1, 2))
    _need(name, "readbuf", readbuf, torch.uint8, 1)
    if not _on_cuda(name, genome, readbuf, pk):
        return score_fill_plain(genome, readbuf, pk, Rp, Qp)
    P = pk.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=pk.device)
    _launch(name, pk.device, _lib().ngt_score_fill, genome.data_ptr(),
            genome.shape[-1], readbuf.data_ptr(), readbuf.numel(),
            pk.data_ptr(), P, Rp, Qp, out.data_ptr())
    return out


def score_fill_plain(genome, readbuf, pk, Rp: int, Qp: int):
    ref = gather_ref(genome, _u32(pk[:, 0]), pk[:, 2].long(), _u32(pk[:, 1]),
                     (pk[:, 3] & W_MASK).long(), Rp, _unit(pk)
                     ).to(torch.int32)
    q = gather_qry(readbuf, pk[:, 4].long(), pk[:, 5].long(), pk[:, 6],
                   Qp).to(torch.int32)
    q_ok = q < 4
    # s per (row, possible reference code): codes are 0..5
    s_of = [torch.where((q == c) & q_ok, 1,
                        torch.where(q_ok & (c < 4), -1, 0)).to(torch.int32)
            for c in range(6)]
    h = torch.zeros_like(q)
    best = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for i in range(Rp):
        rc = ref[:, i:i + 1]
        s = s_of[0]
        for c in range(1, 6):
            s = torch.where(rc == c, s_of[c], s)
        h = (F.pad(h[:, :-1], (1, 0)) + s).clamp_min(0)
        best = torch.maximum(best, h.amax(dim=1))
    return best.to(torch.float32)


# ---------------------------------------------------------------------------
# corridor_windows
# ---------------------------------------------------------------------------

def corridor_windows(pk, TpP: int):
    """Per-wavefront row windows of every align row: ymin/ymax int32
    [B, TpP] and the realized window height hmax int32 [B]."""
    name = "corridor_windows"
    _need(name, "pk", pk, torch.int32, 2, 12)
    if not _on_cuda(name, pk):
        return corridor_windows_plain(pk, TpP)
    B = pk.shape[0]
    ymin = torch.empty((B, TpP), dtype=torch.int32, device=pk.device)
    ymax = torch.empty_like(ymin)
    hmax = torch.empty(B, dtype=torch.int32, device=pk.device)
    _launch(name, pk.device, _lib().ngt_corridor_windows, pk.data_ptr(), B,
            TpP, ymin.data_ptr(), ymax.data_ptr(), hmax.data_ptr())
    return ymin, ymax, hmax


def corridor_windows_plain(pk, TpP: int):
    """The count_leq identity as a scatter histogram + cumsum (the XLA
    twin's "hist" formulation)."""
    c = _align_cols(pk)
    B = pk.shape[0]
    Hn = max(int(c["H"].max()) if B else 0, 1)
    y = torch.arange(Hn, dtype=torch.int32, device=pk.device)[None, :]
    offs = corridor_offs(c["mode"], c["ci"], c["k"], c["d"], y)
    W = c["W"].to(torch.int32)[:, None]
    zero = torch.zeros_like(W)
    lo = torch.clamp(offs, zero, W)
    hi = torch.maximum(torch.clamp(offs + c["width"][:, None], zero, W), lo)
    row_ok = y < c["H"][:, None]
    key_lo = torch.where(row_ok, y + lo, BIG)
    key_hi = torch.where(row_ok, y + hi, BIG)

    def count_leq(key):
        kc = torch.clamp(key, max=TpP).long()
        hist = torch.zeros((B, TpP + 1), dtype=torch.int32, device=pk.device)
        hist.scatter_add_(1, kc, torch.ones_like(kc, dtype=torch.int32))
        return torch.cumsum(hist[:, :TpP], dim=1, dtype=torch.int32)

    ymin = count_leq(key_hi)
    ymax = count_leq(key_lo) - 1
    hmax = (ymax - ymin + 1).amax(dim=1).to(torch.int32)
    return ymin, ymax, hmax


# ---------------------------------------------------------------------------
# convex_fill
# ---------------------------------------------------------------------------

def convex_fill(genome, readbuf, pk, params, ymin, ymax, L: int):
    """Banded convex-gap fill of every align row over its corridor windows.
    genome u8 [G] or unit planes [U, planeP], as score_fill takes it.
    params f32 [6] = (mat, mis, go, ge, gemin, gdecay). Returns dirs u8
    [B, TpP, L] (rows past a problem's last non-empty wavefront are not
    written on the card), best f32 [B], by, bx int32 [B]."""
    name = "convex_fill"
    _need(name, "pk", pk, torch.int32, 2, 12)
    _need(name, "params", params, torch.float32, 1)
    _need(name, "ymin", ymin, torch.int32, 2)
    _need(name, "ymax", ymax, torch.int32, 2)
    _need(name, "genome", genome, torch.uint8, (1, 2))
    _need(name, "readbuf", readbuf, torch.uint8, 1)
    if params.numel() < 6 or ymin.shape != ymax.shape \
            or ymin.shape[0] != pk.shape[0]:
        raise ValueError("%s: inconsistent shapes" % name)
    if not _on_cuda(name, genome, readbuf, pk, params, ymin, ymax):
        return convex_fill_plain(genome, readbuf, pk, params, ymin, ymax, L)
    B, TpP = ymin.shape
    dev = pk.device
    lib = _lib()
    dirs = torch.empty((B, TpP, L), dtype=torch.uint8, device=dev)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    by = torch.empty(B, dtype=torch.int32, device=dev)
    bx = torch.empty(B, dtype=torch.int32, device=dev)
    state = lib.ngt_convex_fill_state_bytes(L)
    scratch = None
    if state > lib.ngt_convex_fill_smem_cap():
        # ring buffers too wide for shared memory: one global slab per block
        scratch = torch.empty(B * state, dtype=torch.uint8, device=dev)
    _launch(name, dev, lib.ngt_convex_fill, genome.data_ptr(),
            genome.shape[-1], readbuf.data_ptr(), readbuf.numel(),
            pk.data_ptr(), params.data_ptr(), ymin.data_ptr(),
            ymax.data_ptr(), B, TpP, L,
            dirs.data_ptr(), best.data_ptr(), by.data_ptr(), bx.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    return dirs, best, by, bx


def convex_fill_plain(genome, readbuf, pk, params, ymin, ymax, L: int):
    """The fill as a loop over wavefronts of [B, L] tensor steps (the XLA
    scan twin), stopping after the last wavefront any problem reaches."""
    c = _align_cols(pk)
    B, TpP = ymin.shape
    dev = pk.device
    mat, mis, go, ge, gemin, gdecay = (params[i] for i in range(6))
    dirs = torch.zeros((B, TpP, L), dtype=torch.uint8, device=dev)
    H = c["H"]
    n_t = int((ymin < H[:, None]).sum(dim=1).max()) if B else 0
    Wn = max(int(c["W"].max()) if B else 0, 1)
    Hn = max(int(H.max()) if B else 0, 1)
    ref = gather_ref(genome, c["ds"], c["diff"], c["hi"], c["W"], Wn,
                     c["unit"])
    qry = gather_qry(readbuf, c["qs"], H, c["rev"], Hn)
    lanes = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    # the previous wavefront's (score, dir, run) as f32 planes with a zero
    # guard lane at each end: lane l sits at index l + 1, so the window
    # shifts are gathers at l + {0, 1, 2}
    st1 = torch.zeros((3, B, L + 2), dtype=torch.float32, device=dev)
    s2 = torch.zeros((B, L + 2), dtype=torch.float32, device=dev)
    # up neighbours in the first L columns, left ones in the last L
    ext_dir = torch.tensor([INS] * L + [DEL] * L, dtype=torch.float32,
                           device=dev)[None, :]
    lanes2 = torch.cat([lanes, lanes + 1], dim=1)
    # per-lane running best (score, t, ymin at t); the strict > keeps each
    # lane's row-major-first cell, so one lexicographic reduction at the
    # end gives the first best cell in (score desc, y asc, x asc) order
    bs = torch.full((B, L), -1.0, dtype=torch.float32, device=dev)
    bt = torch.zeros((B, L), dtype=torch.int32, device=dev)
    bym = torch.zeros((B, L), dtype=torch.int32, device=dev)
    z1 = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    for t in range(n_t):
        ym = ymin[:, t:t + 1]
        dl1 = ym - ymin[:, t - 1:t] if t >= 1 else z1
        dl2 = ym - ymin[:, t - 2:t - 1] if t >= 2 else z1
        y = ym + lanes
        valid = lanes <= (ymax[:, t:t + 1] - ym)
        rc = torch.gather(ref, 1, (t - y).clamp(0, Wn - 1).long())
        qc = torch.gather(qry, 1, y.clamp(0, Hn - 1).long())
        # left = prev1[l + d1], up = prev1[l + d1 - 1], diag = prev2[l + d2 - 1]
        nb = torch.gather(st1, 2, (lanes2 + (dl1 == 1).int()).long()
                          .expand(3, B, 2 * L))
        dg_s = torch.gather(s2, 1, (lanes + dl2.clamp(0, 2)).long())
        s_, d_, r_ = nb[0], nb[1], nb[2]
        ext = d_ == ext_dir
        gap = torch.minimum(gemin, ge + r_ * gdecay)
        cell = torch.where(ext, torch.where(s_ == 0.0, 0.0, s_ + gap),
                           s_ + go)
        up_cell, lf_cell = cell[:, :L], cell[:, L:]
        diag_cell = dg_s + torch.where(rc == qc, mat, mis)
        max_cell = torch.maximum(lf_cell.clamp_min(0.0),
                                 torch.maximum(diag_cell, up_cell))
        m = cell == max_cell.repeat(1, 2)
        m_up, m_lf = m[:, :L], m[:, L:]
        e = ext & m
        e2, e1 = e[:, :L], e[:, L:]
        # D-ext > I-ext > diag > D-open > I-open > STOP
        new_d = torch.where(e1, DEL, torch.where(
            e2, INS, torch.where(max_cell == diag_cell, DIAG, torch.where(
                m_lf, DEL, torch.where(m_up, INS, STOP)))))
        new_d = torch.where(valid, new_d, STOP)
        run = r_ + 1.0
        new_r = torch.where(e1, run[:, L:], torch.where(
            e2, run[:, :L], (new_d >= INS).to(torch.float32)))
        new_s = torch.where(new_d == STOP, 0.0, max_cell)
        dirs[:, t] = new_d
        cand = torch.where(valid, new_s, float("-inf"))
        upd = cand > bs
        bs = torch.where(upd, cand, bs)
        bt = torch.where(upd, t, bt)
        bym = torch.where(upd, ym, bym)
        s2 = st1[0]
        st1 = F.pad(torch.stack([new_s, new_d.to(torch.float32), new_r]),
                    (1, 1))

    bl_y = bym + lanes
    bl_x = bt - bl_y
    m = bs.amax(dim=1, keepdim=True)
    is_m = bs == m
    y_min = torch.where(is_m, bl_y, BIG).amin(dim=1, keepdim=True)
    x_min = torch.where(is_m & (bl_y == y_min), bl_x, BIG).amin(dim=1)
    return dirs, m[:, 0], y_min[:, 0].to(torch.int32), x_min.to(torch.int32)


# ---------------------------------------------------------------------------
# convex_backtrack
# ---------------------------------------------------------------------------

def convex_backtrack(dirs, ymin, pk, bx, by):
    """Reverse walk of every align row from (bx, by) over its direction
    plane. Returns the ops packed 2 bits per wavefront, u8 [B, TpP / 4]
    (zero past the walk), and stop x, stop y, state int32 [B]
    (state 1 = DONE, the walk reached STOP or the matrix edge)."""
    name = "convex_backtrack"
    _need(name, "dirs", dirs, torch.uint8, 3)
    _need(name, "ymin", ymin, torch.int32, 2)
    _need(name, "pk", pk, torch.int32, 2, 12)
    _need(name, "bx", bx, torch.int32, 1)
    _need(name, "by", by, torch.int32, 1)
    B, TpP, L = dirs.shape
    if ymin.shape != (B, TpP) or TpP % 4 or pk.shape[0] != B:
        raise ValueError("%s: inconsistent shapes" % name)
    if not _on_cuda(name, dirs, ymin, pk, bx, by):
        return convex_backtrack_plain(dirs, ymin, pk, bx, by)
    dev = pk.device
    packed = torch.empty((B, TpP // 4), dtype=torch.uint8, device=dev)
    sx = torch.empty(B, dtype=torch.int32, device=dev)
    sy = torch.empty_like(sx)
    state = torch.empty_like(sx)
    _launch(name, dev, _lib().ngt_convex_backtrack, dirs.data_ptr(),
            ymin.data_ptr(), pk.data_ptr(), bx.data_ptr(), by.data_ptr(),
            B, TpP, L, packed.data_ptr(), sx.data_ptr(), sy.data_ptr(),
            state.data_ptr())
    return packed, sx, sy, state


def convex_backtrack_plain(dirs, ymin, pk, bx, by):
    """The walk vectorized over problems: each iteration moves every
    walking problem one step at its own wavefront (the problems are
    independent, so this visits exactly the cells of the per-wavefront
    sweep of the XLA twin)."""
    c = _align_cols(pk)
    B, TpP, L = dirs.shape
    dev = pk.device
    rows = torch.arange(B, device=dev)
    # validPath band per row (AlignmentMatrixFast.cpp:213-220), f32
    Hn = max(int(c["H"].max()) if B else 0, 1)
    yy = torch.arange(Hn, dtype=torch.int32, device=dev)[None, :]
    o = corridor_offs(c["mode"], c["ci"], c["k"], c["d"], yy).to(torch.float32)
    width_f = c["width"].to(torch.float32)[:, None]
    tenth = 0.1 * width_f
    min_c = _f2i(o + tenth)
    max_c = _f2i(min_c.to(torch.float32) + width_f - tenth)
    x, y = bx.clone(), by.clone()
    state = torch.where(by > 0, WALK, FAIL).to(torch.int32)
    sx = torch.full_like(x, -1)
    sy = torch.full_like(y, -1)
    ops = torch.zeros((B, TpP), dtype=torch.int32, device=dev)
    while bool((state == WALK).any()):
        for _ in range(32):
            walk = state == WALK
            t = (x + y).clamp(0, TpP - 1).long()
            lane = y - ymin[rows, t]
            inb = (lane >= 0) & (lane < L)
            d = dirs[rows, t, lane.clamp(0, L - 1).long()].to(torch.int32)
            d = torch.where(walk & inb, d, STOP)
            stop_now = walk & (d == STOP)
            yc = y.clamp(0, Hn - 1).long()
            ok = (x > min_c[rows, yc]) & (x < max_c[rows, yc])
            bad = walk & ~stop_now & ~ok
            emit = torch.where(walk & ~stop_now & ~bad, d, 0)
            ops[rows, t] = torch.where(walk, emit, ops[rows, t])
            nx = x - ((emit == DIAG) | (emit == DEL)).to(torch.int32)
            ny = y - ((emit == DIAG) | (emit == INS)).to(torch.int32)
            end = stop_now | ((emit != 0) & ((nx < 0) | (ny < 0)))
            sx = torch.where(end, nx, sx)
            sy = torch.where(end, ny, sy)
            state = torch.where(end, DONE,
                                torch.where(bad, FAIL, state)).to(torch.int32)
            x, y = nx, ny
    return pack_ops(ops), sx, sy, state


def pack_ops(ops):
    """int [B, T] ops (T a multiple of 4) -> u8 [B, T / 4], 2 bits each."""
    o4 = ops.reshape(ops.shape[0], -1, 4).to(torch.uint8)
    return (o4[..., 0] | (o4[..., 1] << 2) | (o4[..., 2] << 4)
            | (o4[..., 3] << 6))


# ---------------------------------------------------------------------------
# expand_votes
# ---------------------------------------------------------------------------

def expand_votes(cum2, d2tp, ct2p, L: int):
    """Per-vote slot values of device search v2's row-local tables. cum2
    int32 [B, SL2] is each row's inclusive cumsum of per-slot vote counts
    (at most L votes a row); d2tp / ct2p int32 [B, SL2 + 1] are the per-slot
    position-index bases and bin corrections, pad slot last. Returns slot,
    d2t, ct int32 [B, L]: vote l of row b lies in slot
    #{j : cum2[b, j] <= l} (SL2 past the row's votes) and takes that slot's
    d2tp and ct2p."""
    name = "expand_votes"
    _need(name, "cum2", cum2, torch.int32, 2)
    _need(name, "d2tp", d2tp, torch.int32, 2)
    _need(name, "ct2p", ct2p, torch.int32, 2)
    B, SL2 = cum2.shape
    if d2tp.shape != (B, SL2 + 1) or ct2p.shape != (B, SL2 + 1):
        raise ValueError("%s: inconsistent shapes" % name)
    if not _on_cuda(name, cum2, d2tp, ct2p):
        return expand_votes_plain(cum2, d2tp, ct2p, L)
    dev = cum2.device
    slot = torch.empty((B, L), dtype=torch.int32, device=dev)
    d2t = torch.empty_like(slot)
    ct = torch.empty_like(slot)
    if B == 0 or L == 0:
        return slot, d2t, ct
    _launch(name, dev, _lib().ngt_expand_votes, cum2.data_ptr(),
            d2tp.data_ptr(), ct2p.data_ptr(), B, SL2, L, slot.data_ptr(),
            d2t.data_ptr(), ct.data_ptr())
    return slot, d2t, ct


def expand_votes_plain(cum2, d2tp, ct2p, L: int):
    """The XLA twin's formulation (ngmlr_tpu/seed/device_search.py:411-419):
    one flat repeat of the slot ids by the per-slot counts, the pad slot
    taking each row's L - nv leftover votes so the total is exactly B * L,
    then a gather of the two slot tables."""
    B, SL2 = cum2.shape
    dev = cum2.device
    c2 = torch.diff(cum2, dim=1,
                    prepend=torch.zeros((B, 1), dtype=torch.int32, device=dev))
    c2p = torch.cat([c2, L - cum2[:, -1:]], dim=1)
    kmer_f = torch.repeat_interleave(
        torch.arange(B * (SL2 + 1), device=dev), c2p.reshape(-1).long(),
        output_size=B * L)
    slot = (kmer_f % (SL2 + 1)).to(torch.int32).reshape(B, L)
    d2t = d2tp.reshape(-1)[kmer_f].reshape(B, L)
    ct = ct2p.reshape(-1)[kmer_f].reshape(B, L)
    return slot, d2t, ct
