// corridor_windows: per-wavefront active row window of every banded
// alignment problem.
//
// Replaces: ngmlr_tpu/ops/pallas_kernels.py:corridor_windows (the Pallas TPU
// pointer-advance kernel called from device_engine._convex_kernel).
//
// For problem b and wavefront t (t = x + y):
//   ymin[t] = #{y < H : key_hi(y) <= t},  ymax[t] = #{y < H : key_lo(y) <= t} - 1
// with key_lo(y) = y + lo(y), key_hi(y) = y + hi(y), lo = clip(offs(y), 0, W)
// and hi = max(clip(offs(y) + width, 0, W), lo) for the four affine corridor
// generators. Also returns hmax = max_t (ymax - ymin + 1), the realized
// window height that the lane-bound retry checks.
//
// Precondition: both key sequences increase strictly over y < H. The
// offsets are nondecreasing in y (FULL is constant, LINEAR is y - ci, and
// ENDPOINTS / ANCHORS divide by k > 0 with correctly rounded, hence
// monotone, f32 operations), so y + lo and y + hi rise by at least 1 a row.
// tests/test_torch_kernels.py checks it for every corridor generator and
// for every align wave of a golden run. The plain version (a histogram and
// a cumsum) does not need it; this kernel does.
//
// Bound on this card: bytes. Each wavefront costs a few integer operations
// and writes 8 bytes per problem, so writing the two [B, TpP] int32 planes
// (0.01 ms at B = 128, TpP = 32768) is the floor.
//
// Design: one block of 256 threads per (problem, tile of T = 1024
// wavefronts; the last tile of a row may be ragged), so a launch has
// B * ceil(TpP / T) blocks and fills the card. Within the tile [t0, t0 + T):
//   Y(t0) = #{y : key(y) < t0} is one warp-wide search per key (32 probes a
//   round, ballot, narrow the range 32-fold);
//   a row with key in the tile has y in [Y(t0), Y(t0) + T) because the keys
//   rise by at least 1 a row, so thread i evaluates the keys of rows
//   Y(t0) + i (4 per thread) and marks slot key - t0 in shared memory
//   (distinct keys, so no two rows share a slot);
//   a block-wide inclusive scan of the marks plus Y(t0) gives the counts.
// Each thread then stores 4 consecutive wavefronts of each plane with one
// 16-byte store (the row base is 16-byte aligned since TpP % 32 == 0).
// hmax: each block reduces its tile's maximum and folds it in with one
// integer atomicMax, which is order-free and therefore exact; a small
// kernel launched first sets hmax to INT_MIN (the wrapper allocates it
// uninitialised).
#include <climits>

#include "common.cuh"

namespace {

constexpr int TILE = 1024;               // wavefronts per block
constexpr int THREADS = 256;
constexpr int PER = TILE / THREADS;      // wavefronts (and candidate rows) per thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int corridor_key(const ngt::AlignRow& a, int y,
                                            bool add_width) {
  if (y >= a.H) return ngt::BIG;
  const int o = ngt::corridor_off(a.mode, a.ci, a.k, a.d, y);
  int lo = o < 0 ? 0 : (o > a.W ? a.W : o);
  if (add_width) {
    // int32 wrap as in the JAX twin
    const int ow = (int)((unsigned)o + (unsigned)a.width);
    const int hi = ow < 0 ? 0 : (ow > a.W ? a.W : ow);
    lo = hi > lo ? hi : lo;
  }
  return y + lo;
}

// #{y < H : key(y) < t0}, the first row whose key reaches t0, by the whole
// warp: each round probes 32 evenly spaced rows of the open range and keeps
// the gap between the last probe below t0 and the first at or above it.
__device__ int warp_first_at_least(const ngt::AlignRow& a, bool add_width,
                                   int t0, int lane) {
  int lo = 0, hi = a.H > 0 ? a.H : 0;   // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int y = lo + lane * step;
    const bool ge = y >= hi || corridor_key(a, y, add_width) >= t0;
    const unsigned m = __ballot_sync(FULL, ge);
    const int f = m ? __ffs(m) - 1 : 32;
    const int nlo = f == 0 ? lo : lo + (f - 1) * step + 1;
    const int nhi = f == 32 ? hi : min(lo + f * step, hi);
    lo = nlo;
    hi = nhi;
  }
  return lo;
}

__global__ void hmax_init_kernel(int B, int32_t* __restrict__ hmax) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x)
    hmax[b] = INT_MIN;
}

__global__ void __launch_bounds__(THREADS)
corridor_windows_kernel(const int32_t* __restrict__ pk, int TpP, int tiles,
                        int32_t* __restrict__ ymin, int32_t* __restrict__ ymax,
                        int32_t* __restrict__ hmax) {
  __shared__ __align__(16) int32_t mark_hi[TILE];
  __shared__ __align__(16) int32_t mark_lo[TILE];
  __shared__ int32_t base[2];                      // Y_hi(t0), Y_lo(t0)
  __shared__ int32_t wsum_hi[THREADS / 32], wsum_lo[THREADS / 32];
  __shared__ int32_t wmax[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * TILE;
  const ngt::AlignRow a = ngt::load_align_row(pk, b);

  reinterpret_cast<int4*>(mark_hi)[tid] = make_int4(0, 0, 0, 0);
  reinterpret_cast<int4*>(mark_lo)[tid] = make_int4(0, 0, 0, 0);
  if (warp < 2) {
    const int y0 = warp_first_at_least(a, warp == 0, t0, lane);
    if (lane == 0) base[warp] = y0;
  }
  __syncthreads();
  const int yh = base[0], yl = base[1];
  const int t_end = t0 + TILE;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = u * THREADS + tid;
    // keys are BIG past H; the lower test only guards shared memory
    // against rows that break the precondition
    const int kh = corridor_key(a, yh + i, true);
    if (kh >= t0 && kh < t_end) mark_hi[kh - t0] = 1;
    const int kl = corridor_key(a, yl + i, false);
    if (kl >= t0 && kl < t_end) mark_lo[kl - t0] = 1;
  }
  __syncthreads();

  // inclusive scan: per thread over its 4 slots, then across the block
  const int4 mh = reinterpret_cast<const int4*>(mark_hi)[tid];
  const int4 ml = reinterpret_cast<const int4*>(mark_lo)[tid];
  int ch[PER] = {mh.x, mh.x + mh.y, mh.x + mh.y + mh.z,
                 mh.x + mh.y + mh.z + mh.w};
  int cl[PER] = {ml.x, ml.x + ml.y, ml.x + ml.y + ml.z,
                 ml.x + ml.y + ml.z + ml.w};
  int sh = ch[PER - 1], sl = cl[PER - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int vh = __shfl_up_sync(FULL, sh, o);
    const int vl = __shfl_up_sync(FULL, sl, o);
    if (lane >= o) {
      sh += vh;
      sl += vl;
    }
  }
  if (lane == 31) {
    wsum_hi[warp] = sh;
    wsum_lo[warp] = sl;
  }
  __syncthreads();
  int off_h = yh + sh - ch[PER - 1], off_l = yl + sl - cl[PER - 1];
  for (int w = 0; w < warp; ++w) {
    off_h += wsum_hi[w];
    off_l += wsum_lo[w];
  }

  const int t = t0 + tid * PER;
  int hm = INT_MIN;
  if (t < TpP) {   // TpP % 32 == 0: a thread's 4 wavefronts lie all in or all out
    int4 vmin, vmax;
    vmin.x = off_h + ch[0]; vmax.x = off_l + cl[0] - 1;
    vmin.y = off_h + ch[1]; vmax.y = off_l + cl[1] - 1;
    vmin.z = off_h + ch[2]; vmax.z = off_l + cl[2] - 1;
    vmin.w = off_h + ch[3]; vmax.w = off_l + cl[3] - 1;
    const int64_t o = (int64_t)b * TpP + t;
    *reinterpret_cast<int4*>(ymin + o) = vmin;
    *reinterpret_cast<int4*>(ymax + o) = vmax;
    hm = max(max(vmax.x - vmin.x, vmax.y - vmin.y),
             max(vmax.z - vmin.z, vmax.w - vmin.w)) + 1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hm = max(hm, __shfl_xor_sync(FULL, hm, o));
  if (lane == 0) wmax[warp] = hm;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) hm = max(hm, wmax[w]);
    atomicMax(hmax + b, hm);
  }
}

}  // namespace

// pk: int32 [B, 12] align rows; ymin/ymax: int32 [B, TpP]; hmax: int32 [B].
// TpP must be a multiple of 32, and ymin/ymax 16-byte aligned.
extern "C" int ngt_corridor_windows(const void* pk, int B, int TpP, void* ymin,
                                    void* ymax, void* hmax, void* stream) {
  if (B <= 0) return 0;
  if (TpP <= 0 || TpP % 32 != 0 || ((uintptr_t)ymin | (uintptr_t)ymax) % 16)
    return (int)cudaErrorInvalidValue;
  const int tiles = (TpP + TILE - 1) / TILE;
  if ((int64_t)B * tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  hmax_init_kernel<<<(B + 255) / 256 < 1024 ? (B + 255) / 256 : 1024, 256, 0,
                     s>>>(B, (int32_t*)hmax);
  corridor_windows_kernel<<<B * tiles, THREADS, 0, s>>>(
      (const int32_t*)pk, TpP, tiles, (int32_t*)ymin, (int32_t*)ymax,
      (int32_t*)hmax);
  return (int)cudaGetLastError();
}
