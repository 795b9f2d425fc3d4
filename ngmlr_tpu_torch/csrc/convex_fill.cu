// convex_fill: banded convex-gap Smith-Waterman fill on window-aligned
// anti-diagonals (ConvexAlignFast::fwdFillMatrix semantics).
//
// Replaces: ngmlr_tpu/ops/pallas_kernels.py:convex_fill (the Pallas TPU
// kernel behind device_engine._convex_kernel), including the XLA gathers of
// the reference window and the query that fed it.
//
// Lane l of wavefront t holds row y = ymin(t) + l, column x = t - y; it is
// live when l <= ymax(t) - ymin(t). Its neighbours sit at lane shifts of 0, 1
// or 2 given by d1 = ymin(t) - ymin(t-1) and d2 = ymin(t) - ymin(t-2):
//   left = prev1[l + d1], up = prev1[l + d1 - 1], diag = prev2[l + d2 - 1].
// Cell: diag = s2 + (mat | mis); a gap opens at s + go; a gap extends to 0
// when s == 0, else to s + min(gemin, ge + run * gdecay); every cell is
// floored at 0; ties break D-ext > I-ext > diag > D-open > I-open > STOP.
// The best cell is the lexicographically first by (score desc, y asc,
// x asc). Outputs the u8 direction plane [B, TpP, L] (rows past a problem's
// last non-empty wavefront are left unwritten: the backtrack never reads
// them) and best / by / bx.
//
// Bound on this card: the work is ~30 f32 and integer operations per live
// cell against one direction byte per lane of every wavefront reached; at
// the main path's shapes (L = 256) the two floors are about even, the dirs
// write slightly ahead. What a run sees is neither: each wavefront needs
// the two before it, so a block walks its wavefronts one after another,
// each closed by a __syncthreads(), and that serial chain sets the time.
//
// Design: one block per problem, one lane per thread (L <= 1024; wider lane
// classes loop). The last two wavefronts live in shared-memory ring buffers
// (score f32, and direction + run length packed in one int32), with a zero
// guard lane at each end so the shifted reads need no bounds checks. Per
// wavefront each thread reads its neighbours, gathers its two sequence
// codes straight from the genome and read buffer, writes its direction byte
// coalesced to dirs[b, t, :], and the block meets at one __syncthreads().
// The loop stops at the problem's last non-empty wavefront (ymin = H). For
// lane classes whose ring buffers exceed shared memory, the same buffers
// live in a global scratch slab per block instead.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

struct Best {
  float s;
  int y, x;
};

// lexicographic (score desc, y asc, x asc)
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.s > b.s || (a.s == b.s && (a.y < b.y || (a.y == b.y && a.x < b.x)));
}

__global__ void __launch_bounds__(MAX_THREADS)
convex_fill_kernel(const uint8_t* __restrict__ genome, int64_t glen,
                   const uint8_t* __restrict__ readbuf, int64_t rlen,
                   const int32_t* __restrict__ pk,
                   const float* __restrict__ params,
                   const int32_t* __restrict__ ymin,
                   const int32_t* __restrict__ ymax, int TpP, int L,
                   uint8_t* __restrict__ dirs, float* __restrict__ best_out,
                   int32_t* __restrict__ by_out, int32_t* __restrict__ bx_out,
                   uint8_t* scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Best wbest[MAX_THREADS / 32];

  const int b = blockIdx.x;
  const ngt::AlignRow a = ngt::load_align_row(pk, b);
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
  const float NEG_INF = __int_as_float(0xff800000);
  Best mine{NEG_INF, 0, 0};
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
    const int shd = dl2 == 0 ? 0 : (dl2 == 1 ? 1 : 2);
    uint8_t* drow = dirs_b + (int64_t)t * L;

    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      float ns = 0.f;
      int nd = ngt::STOP, nr = 0;
      if (l <= yx - ym) {
        const int y = ym + l, x = t - y;
        const int rc = ngt::ref_code(genome, glen, a.ds, a.diff, a.hi, a.W, x);
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

  // block-wide lexicographic reduction of the per-thread best cells
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best other;
    other.s = __shfl_down_sync(0xffffffffu, mine.s, o);
    other.y = __shfl_down_sync(0xffffffffu, mine.y, o);
    other.x = __shfl_down_sync(0xffffffffu, mine.x, o);
    if (better(other, mine)) mine = other;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wbest[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    Best m = wbest[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (better(wbest[w], m)) m = wbest[w];
    if (m.s == NEG_INF) m = Best{-1.f, 0, 0};   // no live cell at all
    best_out[b] = m.s;
    by_out[b] = m.y;
    bx_out[b] = m.x;
  }
}

}  // namespace

// Shared-memory bytes one block needs for lane class L; above
// ngt_convex_fill_smem_cap() the caller passes a global scratch slab of
// B * ngt_convex_fill_state_bytes(L) bytes instead.
extern "C" int64_t ngt_convex_fill_state_bytes(int L) {
  return (int64_t)5 * (L + 2) * 4;
}

extern "C" int64_t ngt_convex_fill_smem_cap() { return 200 * 1024; }

// pk int32 [B, 12]; params f32 [6] (mat, mis, go, ge, gemin, gdecay);
// ymin/ymax int32 [B, TpP]; dirs u8 [B, TpP, L]; best f32 [B]; by/bx int32 [B];
// scratch: null, or B * state_bytes(L) bytes of global memory.
extern "C" int ngt_convex_fill(const void* genome, int64_t glen,
                               const void* readbuf, int64_t rlen, const void* pk,
                               const void* params, const void* ymin,
                               const void* ymax, int B, int TpP, int L,
                               void* dirs, void* best, void* by, void* bx,
                               void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || L % 32 != 0 || TpP <= 0) return (int)cudaErrorInvalidValue;
  const int64_t state = ngt_convex_fill_state_bytes(L);
  int64_t smem = 0;
  if (scratch == nullptr) {
    if (state > ngt_convex_fill_smem_cap()) return (int)cudaErrorInvalidValue;
    smem = state;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          convex_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  const int threads = L <= MAX_THREADS ? L : 512;
  convex_fill_kernel<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint8_t*)genome, glen, (const uint8_t*)readbuf, rlen,
      (const int32_t*)pk, (const float*)params, (const int32_t*)ymin,
      (const int32_t*)ymax, TpP, L, (uint8_t*)dirs, (float*)best,
      (int32_t*)by, (int32_t*)bx, (uint8_t*)scratch);
  return (int)cudaGetLastError();
}
