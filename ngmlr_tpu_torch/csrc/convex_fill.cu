// convex_fill: banded convex-gap Smith-Waterman fill on window-aligned
// anti-diagonals (ConvexAlignFast::fwdFillMatrix semantics).
//
// Replaces: ngmlr_tpu/ops/pallas_kernels.py:254 convex_fill (the Pallas TPU
// kernel behind device_engine._convex_kernel; body _fill_kernel, :60-251),
// including the XLA gathers of the reference window and the query that fed
// it.
//
// Lane l of wavefront t holds row y = ymin(t) + l, column x = t - y; it is
// live when l <= ymax(t) - ymin(t). Its neighbours sit at lane shifts of 0, 1
// or 2 given by d1 = ymin(t) - ymin(t-1) and d2 = ymin(t) - ymin(t-2):
//   left = prev1[l + d1], up = prev1[l + d1 - 1], diag = prev2[l + d2 - 1],
// with lanes outside [0, L) reading as zero. Cell: diag = s2 + (mat | mis);
// a gap opens at s + go; a gap extends to 0 when s == 0, else to s +
// min(gemin, ge + run * gdecay); every cell is floored at 0; ties break
// D-ext > I-ext > diag > D-open > I-open > STOP. The best cell is the
// lexicographically first by (score desc, y asc, x asc). Outputs the u8
// direction plane [B, TpP, L] (rows past a problem's last non-empty
// wavefront are left unwritten: the backtrack never reads them) and best /
// by / bx.
//
// Bound on this card: the latency of one wavefront step. The operation
// floor (~38 instructions a live cell over 132 SMs) is a fraction of a
// millisecond at the main path's shapes, but each wavefront needs the two
// before it, so a problem's ~20,000 wavefronts run one after another, and a
// launch of 8-64 problems fills 8-64 SMs. The time is the number of steps
// times the cycles of one step. A cell is ~85% compares, selects, min/max
// and logic, which a warp scheduler issues at one every two cycles (the
// ALU pipe's 16 lanes), on a dependent chain of ~20 of them (-fmad=false
// keeps every add exact); then comes the exchange with the neighbouring
// lanes. A clock probe puts a main-path step (L = 256, R = 2) at ~600
// cycles: ~300 in the cells, ~90 in the exchange between threads, ~110 in
// reading the step's window and codes (PERF.md).
//
// Design (lane classes up to TILED_MAX_L): one block per problem; thread j
// owns R consecutive lanes [jR, jR + R) and keeps their state of the last
// two wavefronts in registers: the score, the value each cell offers as an
// up and as a left neighbour (its extension for INS / DEL, else s + go,
// computed once when the cell is made) and the run an extension continues.
// A step reads shared memory and registers only:
//   Tiles: the wavefronts go in tiles of K. The tile's ymin, a step word per
//   wavefront (its shift variant and last live lane) and its sequence codes
//   sit in one of two shared buffers: the query rows [a, a + K + L) and the
//   reference columns reversed (byte k holds x = t0 + K - 1 - a - k), a =
//   ymin at the wavefront before the tile. As ymin rises by at most one a
//   wavefront, every live cell of the tile falls in both spans, and a
//   thread's R codes are consecutive bytes in each: a few word loads and
//   funnel shifts, one XOR a four cells, read a step ahead. The codes are
//   made once, when staged ('x', N and the reverse complement of
//   common.cuh). The next tile's bytes are loaded into registers (volatile,
//   unconditional loads) as a tile starts and stored to the other buffer
//   when it ends, so their latency passes under the K steps.
//   Neighbours: inside a thread from registers; across threads, each
//   thread stores its bottom and top lane to shared slots, meets the block
//   at one barrier and loads its two neighbours' lanes: no shuffles and no
//   predicated accesses, which cost the exchange twice as much. The shifts
//   (d1 == 1, clamp(d2, 0, 2)) are uniform in a block: the step is
//   compiled once for each of the six pairs and picked by uniform
//   branches, so no cell selects a neighbour and the compiler interleaves a
//   thread's R cells. The tie order is three predicates formed side by
//   side, with no lane branch.
//   Directions: each step's R bytes go into a shared [K, L] tile, written to
//   the plane once per tile with 16-byte stores.
//   Best cell: per lane, a strict > keeps the score and wavefront of its
//   first best cell (y grows with t on a lane, x grows at fixed y), and one
//   lexicographic reduction at the end recovers y from ymin.
// R per lane class (fill_r) was chosen by measurement on the card: 2 up to
// 768 lanes (4 warps for L = 256), 4 up to 2048, 8 above. Each (R, block)
// pair is its own instantiation, its __launch_bounds__ the block rounded up
// to 128 threads (the block itself at L = 256, 512, 768, 1024, 1536, 2048,
// 3072 and 4096).
// Wider lane classes (realigns of very long reads) do not fit the registers:
// they keep one lane a thread with the last two wavefronts in shared memory
// (global scratch above ngt_convex_fill_smem_cap()), and write directions
// directly.
#include "common.cuh"

namespace {

constexpr int K = 32;                 // wavefronts per tile
constexpr int TILED_MAX_L = 4096;     // widest lane class kept in registers
constexpr int WIDE_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Best {
  float s;
  int y, x;
};

// lexicographic (score desc, y asc, x asc)
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.s > b.s || (a.s == b.s && (a.y < b.y || (a.y == b.y && a.x < b.x)));
}

// block-wide lexicographic reduction; thread 0 writes the result
__device__ __forceinline__ void reduce_best(Best mine, Best* wbest,
                                            float* best_out, int32_t* by_out,
                                            int32_t* bx_out, int b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best other;
    other.s = __shfl_down_sync(FULL, mine.s, o);
    other.y = __shfl_down_sync(FULL, mine.y, o);
    other.x = __shfl_down_sync(FULL, mine.x, o);
    if (better(other, mine)) mine = other;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wbest[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    Best m = wbest[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (better(wbest[w], m)) m = wbest[w];
    best_out[b] = m.s;
    by_out[b] = m.y;
    bx_out[b] = m.x;
  }
}

struct Scores {
  float mat, mis, go, ge, gemin, gdecay;
};

// The previous wavefront's values at the lanes next to a thread's own:
// l_* of lane jR - 1 (the thread before), r_* of lane jR + R (the next).
struct Halo {
  float l_up, l_ux, l_s1, l_s2;
  float r_lf, r_lx, r_s1, r_s2;
};

// One wavefront of a thread's R lanes. s1/s2: scores at t - 1 and t - 2;
// up/lf: the value each cell of t - 1 offers as an up / left neighbour;
// ux/lx: run + 1 where that cell is an INS / DEL (an extension continues
// it), else 0. xw: the query XOR reference codes, a byte a lane. live: the
// thread's lanes with index <= hv. SH1 = (d1 == 1) and SHD = clamp(d2, 0,
// 2) are uniform in a block; as template arguments they leave no branch and
// no select between the cells, so the scheduler can interleave all R.
// Writes the R direction bytes packed into dw.
template <int R, bool SH1, int SHD>
__device__ __forceinline__ void fill_step(
    float (&s1)[R], float (&s2)[R], float (&up)[R], float (&lf)[R],
    float (&ux)[R], float (&lx)[R], float (&bs)[R], int (&bt)[R],
    const Halo& h, const uint32_t* xw, int lane0, int hv, int t,
    const Scores& p, uint32_t* dw) {
  float ns[R], nr[R];
  int nd[R];
  bool ins[R], del[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float lfv, lxv, upv, uxv;
    if (SH1) {            // left = prev1[l + 1], up = prev1[l]
      lfv = i + 1 < R ? lf[i + 1] : h.r_lf;
      lxv = i + 1 < R ? lx[i + 1] : h.r_lx;
      upv = up[i];
      uxv = ux[i];
    } else {              // left = prev1[l], up = prev1[l - 1]
      lfv = lf[i];
      lxv = lx[i];
      upv = i > 0 ? up[i - 1] : h.l_up;
      uxv = i > 0 ? ux[i - 1] : h.l_ux;
    }
    // diag = prev2[l + SHD - 1]
    const float dg = SHD == 0 ? (i > 0 ? s2[i - 1] : h.l_s2)
                   : SHD == 1 ? s2[i]
                              : (i + 1 < R ? s2[i + 1] : h.r_s2);
    const bool eq = ((xw[i >> 2] >> (8 * (i & 3))) & 0xffu) == 0u;
    const float diag = __fadd_rn(dg, eq ? p.mat : p.mis);
    // fmaxf (one instruction) gives what the plain version's maxima give:
    // they differ only on -0, and no cell value is ever -0 (scores start at
    // +0, and every other value is a sum with a nonzero score parameter)
    const float mx = fmaxf(fmaxf(lfv, 0.f), fmaxf(diag, upv));
    const bool m_lf = mx == lfv, m_up = mx == upv, m_dg = mx == diag;
    const bool e1 = (lxv != 0.f) & m_lf, e2 = (uxv != 0.f) & m_up;
    const bool live = lane0 + i <= hv;
    // the tie order D-ext > I-ext > diag > D-open > I-open > STOP as three
    // predicates formed side by side (no chain of selects, no lane branch):
    // keep (not STOP), DEL, INS; DIAG is keep and neither
    const bool keep = live & (m_lf | m_up | m_dg);
    const bool is_del = live & (e1 | (!e2 & !m_dg & m_lf));
    const bool is_ins = live & !e1 & (e2 | (!m_dg & !m_lf & m_up));
    const float r = is_del ? (e1 ? lxv : 1.f) : (e2 ? uxv : 1.f);
    const float s = keep ? mx : 0.f;
    const bool upd = live & (s > bs[i]);
    bs[i] = upd ? s : bs[i];
    bt[i] = upd ? t : bt[i];
    ns[i] = s;
    nd[i] = is_del ? ngt::DEL : (is_ins ? ngt::INS : (keep ? ngt::DIAG : ngt::STOP));
    nr[i] = r;       // the run, where the cell is an INS or a DEL
    ins[i] = is_ins;
    del[i] = is_del;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    // fminf: as the select it stands for, since a zero gap only meets a
    // nonzero score
    const float gap = fminf(p.gemin, __fadd_rn(p.ge, __fmul_rn(nr[i], p.gdecay)));
    const float ext = ns[i] == 0.f ? 0.f : __fadd_rn(ns[i], gap);
    const float open = __fadd_rn(ns[i], p.go);
    const float run = __fadd_rn(nr[i], 1.f);
    up[i] = ins[i] ? ext : open;
    ux[i] = ins[i] ? run : 0.f;
    lf[i] = del[i] ? ext : open;
    lx[i] = del[i] ? run : 0.f;
    s2[i] = s1[i];
    s1[i] = ns[i];
  }
#pragma unroll
  for (int w = 0; w < (R + 3) / 4; ++w) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 4 * w; i < 4 * w + 4 && i < R; ++i)
      v |= (uint32_t)nd[i] << (8 * (i & 3));
    dw[w] = v;
  }
}

// loads that stay where they are written (see fill_tiled's staging)
__device__ __forceinline__ uint32_t ldg_u8(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ldg_u32(const int32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Shared-memory layout of a tiled block of NT threads (LP = NT * R lanes,
// the last NT * R - L of them dead: never live, so they read as the zero
// guard lanes of [0, L)).
struct TileLayout {
  int LP, QN, dt, sq, sr, sym, sst, xa, xb, bytes;
  __host__ __device__ TileLayout(int R, int NT) {
    LP = NT * R;
    QN = K + LP + 16;              // staged codes a buffer, + over-read
    dt = 0;                        // [K][LP] direction tile
    sq = dt + K * LP;              // [2][QN] query codes
    sr = sq + 2 * QN;              // [2][QN] reference codes, reversed
    sym = sr + 2 * QN;             // [2][K] ymin
    sst = sym + 2 * K * 4;         // [2][K] step words (see fill_tiled)
    xa = sst + 2 * K * 4;          // [2][NT + 2] float4: (up, ux, s, -)
    xb = xa + 2 * (NT + 2) * 16;   // [2][NT + 2] float4: (lf, lx, s, -)
    bytes = xb + 2 * (NT + 2) * 16;
  }
};

// NTB: the block's __launch_bounds__, at least blockDim.x
template <int R, int NTB>
__global__ void __launch_bounds__(NTB)
fill_tiled(const uint8_t* __restrict__ genome, int64_t plane,
           const uint8_t* __restrict__ readbuf, int64_t rlen,
           const int32_t* __restrict__ pk, const float* __restrict__ params,
           const int32_t* __restrict__ ymin, const int32_t* __restrict__ ymax,
           int TpP, int L, uint8_t* __restrict__ dirs,
           float* __restrict__ best_out, int32_t* __restrict__ by_out,
           int32_t* __restrict__ bx_out) {
  static_assert(R == 2 || R == 4 || R == 8, "the lane classes' R values");
  constexpr int NQW = (R + 3) / 4;   // code words a thread compares a step
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Best wbest[NTB / 32];
  const int NT = blockDim.x, tid = threadIdx.x;
  const TileLayout lay(R, NT);
  const int LP = lay.LP, QN = lay.QN;
  uint8_t* dt = smem + lay.dt;
  uint8_t* sq = smem + lay.sq;
  uint8_t* sr = smem + lay.sr;
  int32_t* sym = reinterpret_cast<int32_t*>(smem + lay.sym);
  int32_t* sst = reinterpret_cast<int32_t*>(smem + lay.sst);
  float4* xa = reinterpret_cast<float4*>(smem + lay.xa);
  float4* xb = reinterpret_cast<float4*>(smem + lay.xb);

  const int b = blockIdx.x;
  const ngt::AlignRow a = ngt::load_align_row(pk, b);
  const uint8_t* g = ngt::plane_base(genome, a.unit, plane);
  const Scores p{params[0], params[1], params[2], params[3], params[4],
                 params[5]};
  const int32_t* ymin_b = ymin + (int64_t)b * TpP;
  const int32_t* ymax_b = ymax + (int64_t)b * TpP;
  uint8_t* dirs_b = dirs + (int64_t)b * TpP * L;
  const int lane0 = tid * R;
  // what a zero lane (a guard, or a cell that is not live) offers as an up
  // or left neighbour: an opening gap from score 0
  const float z_off = __fadd_rn(0.f, p.go);

  // The next tile's staging: raw bytes and windows loaded into registers
  // as a tile starts (tile tn, query rows from an), made into codes and
  // stored when it ends. The loads are unconditional, from clamped
  // addresses, and volatile, so the compiler neither sinks them to their
  // use after the tile nor puts a branch around each.
  uint32_t qv[R + 1], rv[R + 1], ymv, yxv;
  auto fetch = [&](int tn, int an) {
    const int x0 = tn + K - 1 - an;
#pragma unroll
    for (int m = 0; m <= R; ++m) {
      const int k = tid + m * NT;
      const int j = an + k;             // query row
      const int64_t qp = (int64_t)a.qs + (a.rev ? a.H - 1 - j : j);
      qv[m] = ldg_u8(readbuf + (qp < 0 ? 0 : (qp >= rlen ? rlen - 1 : qp)));
      const int64_t gp = (int64_t)a.ds + (x0 - k - a.diff);   // column x0 - k
      rv[m] = ldg_u8(g + (gp < 0 ? 0 : (gp >= plane ? plane - 1 : gp)));
    }
    const int t = min(tn + min(tid, K - 1), TpP - 1);
    ymv = ldg_u32(ymin_b + t);
    yxv = ldg_u32(ymax_b + t);
  };
  // The rules of ngt::qry_code and ngt::ref_code on the fetched bytes, and
  // each wavefront's step word: 8 * (hv + 1) + its variant, where hv =
  // min(ymax - ymin, L - 1) is its last live lane and the variant
  // 3 * (d1 == 1) + clamp(d2, 0, 2) (d1 = d2 = 0 at t = 0, d2 = 0 at t = 1);
  // ym1 / ym2: ymin at wavefronts tn - 1 and tn - 2.
  auto stage = [&](int buf, int tn, int an, int ym1, int ym2) {
    const int x0 = tn + K - 1 - an;
#pragma unroll
    for (int m = 0; m <= R; ++m) {
      const int k = tid + m * NT;
      if (k < QN) {
        const int j = an + k, i = x0 - k;
        int q = (int)qv[m];
        q = a.rev && q < 4 ? q ^ 1 : q;
        q = j < 0 || j >= a.H ? ngt::NCODE : q;
        const bool x_out = i < a.diff || i >= a.W ||
                           (int64_t)a.ds + (i - a.diff) >= (int64_t)a.hi;
        sq[buf * QN + k] = (uint8_t)q;
        sr[buf * QN + k] = (uint8_t)(x_out ? ngt::XCODE : (int)rv[m]);
      }
    }
    if (tid < K) {   // warp 0; past TpP, ymin = H: the loop's stop
      const int t = tn + tid;
      const int ym = t < TpP ? (int)ymv : a.H;
      const int p1 = __shfl_up_sync(FULL, ym, 1);
      const int p2 = __shfl_up_sync(FULL, ym, 2);
      const int y1 = tid >= 1 ? p1 : ym1;
      const int y2 = tid >= 2 ? p2 : (tid == 1 ? ym1 : ym2);
      const int dl1 = t >= 1 ? ym - y1 : 0, dl2 = t >= 2 ? ym - y2 : 0;
      const int var = (dl1 == 1 ? 3 : 0) + (dl2 < 0 ? 0 : (dl2 > 2 ? 2 : dl2));
      const int hv = max(min((int)yxv - ym, L - 1), -1);
      sym[buf * K + tid] = ym;
      sst[buf * K + tid] = 8 * (hv + 1) + var;
    }
  };

  float s1[R], s2[R], up[R], lf[R], ux[R], lx[R], bs[R];
  int bt[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s1[i] = s2[i] = 0.f;
    up[i] = lf[i] = z_off;
    ux[i] = lx[i] = 0.f;
    bs[i] = -1.f;
    bt[i] = 0;
  }
  Halo h{z_off, 0.f, 0.f, 0.f, z_off, 0.f, 0.f, 0.f};
  // the exchange slots' guards: what the lanes below 0 and above LP - 1
  // offer (a zero lane), never overwritten
  if (tid < 2) {
    xa[tid * (NT + 2)] = make_float4(z_off, 0.f, 0.f, 0.f);
    xb[tid * (NT + 2) + NT + 1] = make_float4(z_off, 0.f, 0.f, 0.f);
  }
  float4 *ca = xa, *cb = xb, *na = xa + NT + 2, *nb = xb + NT + 2;

  fetch(0, 0);
  stage(0, 0, 0, 0, 0);
  __syncthreads();
  int buf = 0, qa = 0;    // qa: the staged tile's first query row
  for (int t0 = 0; t0 < TpP; t0 += K) {
    const int32_t* cym = sym + buf * K;
    const int32_t* cst = sst + buf * K;
    const uint32_t* cq = reinterpret_cast<const uint32_t*>(sq + buf * QN);
    const uint32_t* cr = reinterpret_cast<const uint32_t*>(sr + buf * QN);
    const int x0 = t0 + K - 1 - qa;
    const int an = cym[K - 1];
    const bool more = t0 + K < TpP && an < a.H;
    if (more) fetch(t0 + K, an);
    // wavefront u's codes for this thread: query rows ym + lane0 + i,
    // reference columns t - ym - lane0 - i (reversed: ascending in i), as
    // one XOR word a four lanes. The clamps only keep windows that break
    // the one-row-a-wavefront rule inside the buffers.
    auto codes = [&](int u, int ym, uint32_t (&xw)[NQW]) {
      const int qo = min(max(ym - qa, 0), K) + lane0;
      const int ro = min(max(x0 - (t0 + u) + ym, 0), K) + lane0;
      uint32_t qw[NQW + 1], rw[NQW + 1];
#pragma unroll
      for (int w = 0; w <= NQW; ++w) {
        qw[w] = cq[(qo >> 2) + w];
        rw[w] = cr[(ro >> 2) + w];
      }
      const int qsh = (qo & 3) * 8, rsh = (ro & 3) * 8;
#pragma unroll
      for (int w = 0; w < NQW; ++w)
        xw[w] = __funnelshift_r(qw[w], qw[w + 1], qsh) ^
                __funnelshift_r(rw[w], rw[w + 1], rsh);
    };
    // each wavefront's window and codes are read one step ahead, so their
    // shared-memory latency passes under the step before
    int ym = cym[0], st = cst[0];
    uint32_t xw[NQW];
    codes(0, ym, xw);
    int nu = 0;
    for (int u = 0; u < K; ++u) {
      const int t = t0 + u;
      if (ym >= a.H) break;   // every row has left the corridor
      const int un = min(u + 1, K - 1);
      const int ym_n = cym[un], st_n = cst[un];
      uint32_t xw_n[NQW];
      codes(un, ym_n, xw_n);
      const int hv = (st >> 3) - 1, var = st & 7;
      uint32_t dw[NQW];
#define NGT_STEP(SH1, SHD)                                                   \
  fill_step<R, SH1, SHD>(s1, s2, up, lf, ux, lx, bs, bt, h, xw, lane0, hv, t, \
                         p, dw)
      if (var >= 3) {    // uniform branches, cheaper than a jump table
        if (var == 3) NGT_STEP(true, 0);
        else if (var == 4) NGT_STEP(true, 1);
        else NGT_STEP(true, 2);
      } else {
        if (var == 0) NGT_STEP(false, 0);
        else if (var == 1) NGT_STEP(false, 1);
        else NGT_STEP(false, 2);
      }
#undef NGT_STEP
      uint8_t* drow = dt + u * LP + lane0;   // R-aligned: one store
      if (R == 8)
        *reinterpret_cast<uint2*>(drow) = make_uint2(dw[0], dw[1]);
      else if (R == 4)
        *reinterpret_cast<uint32_t*>(drow) = dw[0];
      else
        *reinterpret_cast<uint16_t*>(drow) = (uint16_t)dw[0];

      // the neighbours' halo lanes for the next step: each thread offers
      // its top lane to the thread above and its bottom lane to the one
      // below through shared slots, one barrier and two loads; two slot
      // sets alternate, so a set is written again only after the next
      // barrier
      h.l_s2 = h.l_s1;
      h.r_s2 = h.r_s1;
      ca[tid + 1] = make_float4(up[R - 1], ux[R - 1], s1[R - 1], 0.f);
      cb[tid + 1] = make_float4(lf[0], lx[0], s1[0], 0.f);
      __syncthreads();
      const float4 l4 = ca[tid], r4 = cb[tid + 2];
      h.l_up = l4.x; h.l_ux = l4.y; h.l_s1 = l4.z;
      h.r_lf = r4.x; h.r_lx = r4.y; h.r_s1 = r4.z;
      float4* sw = ca; ca = na; na = sw;
      sw = cb; cb = nb; nb = sw;
      ym = ym_n;
      st = st_n;
#pragma unroll
      for (int w = 0; w < NQW; ++w) xw[w] = xw_n[w];
      nu = u + 1;
    }
    if (more && nu == K) stage(buf ^ 1, t0 + K, an, an, cym[K - 2]);
    __syncthreads();
    // the tile's direction rows to the plane, 16 bytes a store
    const int cpr = L >> 4;
    for (int c = tid; c < nu * cpr; c += NT) {
      const int u = c / cpr, cc = c - u * cpr;
      *reinterpret_cast<uint4*>(dirs_b + (int64_t)(t0 + u) * L + cc * 16) =
          *reinterpret_cast<const uint4*>(dt + u * LP + cc * 16);
    }
    if (!more || nu < K) break;
    __syncthreads();
    buf ^= 1;
    qa = an;
  }

  // each lane's first best cell, then the block's lexicographic first;
  // a lane that saw no live cell keeps (-1, y = l, x = -l), as in the plain
  // version, so a problem without one gives (-1, 0, 0)
  Best mine{__int_as_float(0xff800000), 0, 0};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int l = lane0 + i;
    if (l >= L) continue;
    Best c;
    c.s = bs[i];
    c.y = (bs[i] < 0.f ? 0 : ymin_b[bt[i]]) + l;
    c.x = bt[i] - c.y;
    if (better(c, mine)) mine = c;
  }
  reduce_best(mine, wbest, best_out, by_out, bx_out, b);
}

// Lane classes above TILED_MAX_L: one lane a thread (looping past 1024),
// the last two wavefronts in shared memory or a global scratch slab, codes
// gathered per cell, directions stored per cell.
__global__ void __launch_bounds__(WIDE_THREADS)
fill_wide(const uint8_t* __restrict__ genome, int64_t plane,
          const uint8_t* __restrict__ readbuf, int64_t rlen,
          const int32_t* __restrict__ pk, const float* __restrict__ params,
          const int32_t* __restrict__ ymin, const int32_t* __restrict__ ymax,
          int TpP, int L, uint8_t* __restrict__ dirs,
          float* __restrict__ best_out, int32_t* __restrict__ by_out,
          int32_t* __restrict__ bx_out, uint8_t* scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Best wbest[WIDE_THREADS / 32];

  const int b = blockIdx.x;
  const ngt::AlignRow a = ngt::load_align_row(pk, b);
  const uint8_t* g = ngt::plane_base(genome, a.unit, plane);
  const float mat = params[0], mis = params[1], go = params[2];
  const float ge = params[3], gemin = params[4], gdecay = params[5];

  const int LP = L + 2;   // lane l at index l + 1; indices 0 and L + 1 stay 0
  uint8_t* base = scratch ? scratch + (size_t)b * 5 * LP * 4 : smem;
  float* S = reinterpret_cast<float*>(base);           // [3][LP] scores
  int32_t* DR = reinterpret_cast<int32_t*>(S + 3 * LP);  // [2][LP] run<<2|dir
  for (int i = threadIdx.x; i < 5 * LP; i += blockDim.x)
    reinterpret_cast<int32_t*>(base)[i] = 0;

  const int32_t* ymin_b = ymin + (int64_t)b * TpP;
  const int32_t* ymax_b = ymax + (int64_t)b * TpP;
  uint8_t* dirs_b = dirs + (int64_t)b * TpP * L;
  Best mine{__int_as_float(0xff800000), 0, 0};
  int ym1 = 0, ym2 = 0;   // ymin at t - 1 and t - 2
  __syncthreads();

  for (int t = 0; t < TpP; ++t) {
    const int ym = ymin_b[t];
    if (ym >= a.H) break;   // every row has left the corridor
    const int yx = ymax_b[t];
    const int dl1 = t >= 1 ? ym - ym1 : 0;
    const int dl2 = t >= 2 ? ym - ym2 : 0;
    const float* S1 = S + ((t + 2) % 3) * LP;
    const float* S2 = S + ((t + 1) % 3) * LP;
    float* S0 = S + (t % 3) * LP;
    const int32_t* DR1 = DR + ((t + 1) & 1) * LP;
    int32_t* DR0 = DR + (t & 1) * LP;
    const int sh1 = dl1 == 1 ? 1 : 0;
    const int shd = dl2 < 0 ? 0 : (dl2 > 2 ? 2 : dl2);
    uint8_t* drow = dirs_b + (int64_t)t * L;

    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      float ns = 0.f;
      int nd = ngt::STOP, nr = 0;
      if (l <= yx - ym) {
        const int y = ym + l, x = t - y;
        const int rc = ngt::ref_code(g, plane, a.ds, a.diff, a.hi, a.W, x);
        const int qc = ngt::qry_code(readbuf, rlen, a.qs, a.H, a.rev, y);
        const float lf_s = S1[l + 1 + sh1];
        const int lf_dr = DR1[l + 1 + sh1];
        const float up_s = S1[l + sh1];
        const int up_dr = DR1[l + sh1];
        const float dg_s = S2[l + shd];
        const int lf_d = lf_dr & 3, up_d = up_dr & 3;
        const int lf_run = lf_dr >> 2, up_run = up_dr >> 2;

        const float diag_cell = __fadd_rn(dg_s, rc == qc ? mat : mis);
        const bool ins_ext = up_d == ngt::INS;
        float up_gap = __fadd_rn(ge, __fmul_rn((float)up_run, gdecay));
        up_gap = gemin < up_gap ? gemin : up_gap;
        const float up_cell = ins_ext ? (up_s == 0.f ? 0.f : __fadd_rn(up_s, up_gap))
                                      : __fadd_rn(up_s, go);
        const bool del_ext = lf_d == ngt::DEL;
        float lf_gap = __fadd_rn(ge, __fmul_rn((float)lf_run, gdecay));
        lf_gap = gemin < lf_gap ? gemin : lf_gap;
        const float lf_cell = del_ext ? (lf_s == 0.f ? 0.f : __fadd_rn(lf_s, lf_gap))
                                      : __fadd_rn(lf_s, go);

        const float m1 = lf_cell > 0.f ? lf_cell : 0.f;
        const float m2 = diag_cell > up_cell ? diag_cell : up_cell;
        const float max_cell = m1 > m2 ? m1 : m2;
        const bool m_lf = max_cell == lf_cell, m_up = max_cell == up_cell;
        if (del_ext && m_lf) {
          nd = ngt::DEL; nr = lf_run + 1;
        } else if (ins_ext && m_up) {
          nd = ngt::INS; nr = up_run + 1;
        } else if (max_cell == diag_cell) {
          nd = ngt::DIAG;
        } else if (m_lf) {
          nd = ngt::DEL; nr = 1;
        } else if (m_up) {
          nd = ngt::INS; nr = 1;
        }
        ns = nd == ngt::STOP ? 0.f : max_cell;
        const Best c{ns, y, x};
        if (better(c, mine)) mine = c;
      }
      S0[l + 1] = ns;
      DR0[l + 1] = (nr << 2) | nd;
      drow[l] = (uint8_t)nd;
    }
    ym2 = ym1;
    ym1 = ym;
    __syncthreads();
  }
  // no live cell at all: (-1, 0, 0), as the plain version gives
  if (mine.s == __int_as_float(0xff800000)) mine = Best{-1.f, 0, 0};
  reduce_best(mine, wbest, best_out, by_out, bx_out, b);
}

// Lanes a thread owns in the tiled kernel, per lane class (PERF.md: the
// block sizes measured on the card): blocks of 64-384 threads at R = 2,
// 224-512 at R = 4, 288-512 at R = 8.
int fill_r(int L) {
  if (L <= 768) return 2;
  return L <= 2048 ? 4 : 8;
}

template <int R, int NTB>
int launch_tiled(const void* genome, int64_t plane, const void* readbuf,
                 int64_t rlen, const void* pk, const void* params,
                 const void* ymin, const void* ymax, int B, int TpP, int L,
                 int NT, void* dirs, void* best, void* by, void* bx,
                 cudaStream_t stream) {
  const int smem = TileLayout(R, NT).bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fill_tiled<R, NTB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  fill_tiled<R, NTB><<<B, NT, (size_t)smem, stream>>>(
      (const uint8_t*)genome, plane, (const uint8_t*)readbuf, rlen,
      (const int32_t*)pk, (const float*)params, (const int32_t*)ymin,
      (const int32_t*)ymax, TpP, L, (uint8_t*)dirs, (float*)best,
      (int32_t*)by, (int32_t*)bx);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of state one block of lane class L keeps outside registers: 0 for
// the tiled kernel; above ngt_convex_fill_smem_cap() the caller passes a
// global scratch slab of B * ngt_convex_fill_state_bytes(L) bytes instead of
// shared memory.
extern "C" int64_t ngt_convex_fill_state_bytes(int L) {
  return L <= TILED_MAX_L ? 0 : (int64_t)5 * (L + 2) * 4;
}

extern "C" int64_t ngt_convex_fill_smem_cap() { return 200 * 1024; }

// genome: unit planes of `plane` bytes each (a flat genome: one plane, the
// whole buffer), every row's unit below their count;
// pk int32 [B, 12]; params f32 [6] (mat, mis, go, ge, gemin, gdecay);
// ymin/ymax int32 [B, TpP]; dirs u8 [B, TpP, L]; best f32 [B]; by/bx int32 [B];
// scratch: null, or B * state_bytes(L) bytes of global memory.
extern "C" int ngt_convex_fill(const void* genome, int64_t plane,
                               const void* readbuf, int64_t rlen, const void* pk,
                               const void* params, const void* ymin,
                               const void* ymax, int B, int TpP, int L,
                               void* dirs, void* best, void* by, void* bx,
                               void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || L % 32 != 0 || TpP <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (L <= TILED_MAX_L) {
    const int R = fill_r(L);
    const int NT = ((L + R - 1) / R + 31) / 32 * 32;
    // the instantiation whose launch bound is NT rounded up to 128 threads
#define NGT_TILED(R_, NTB_)                                                  \
  if (R == R_ && NT <= NTB_)                                                \
  return launch_tiled<R_, NTB_>(genome, plane, readbuf, rlen, pk, params,   \
                                ymin, ymax, B, TpP, L, NT, dirs, best, by,  \
                                bx, st)
    NGT_TILED(2, 128);
    NGT_TILED(2, 256);
    NGT_TILED(2, 384);
    NGT_TILED(4, 256);
    NGT_TILED(4, 384);
    NGT_TILED(4, 512);
    NGT_TILED(8, 384);
    NGT_TILED(8, 512);
#undef NGT_TILED
    return (int)cudaErrorInvalidValue;
  }
  const int64_t state = ngt_convex_fill_state_bytes(L);
  int64_t smem = 0;
  if (scratch == nullptr) {
    if (state > ngt_convex_fill_smem_cap()) return (int)cudaErrorInvalidValue;
    smem = state;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          fill_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  fill_wide<<<B, WIDE_THREADS, (size_t)smem, st>>>(
      (const uint8_t*)genome, plane, (const uint8_t*)readbuf, rlen,
      (const int32_t*)pk, (const float*)params, (const int32_t*)ymin,
      (const int32_t*)ymax, TpP, L, (uint8_t*)dirs, (float*)best,
      (int32_t*)by, (int32_t*)bx, (uint8_t*)scratch);
  return (int)cudaGetLastError();
}
