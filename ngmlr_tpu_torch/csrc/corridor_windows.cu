// corridor_windows: per-wavefront active row window of every banded
// alignment problem.
//
// Replaces: ngmlr_tpu/ops/pallas_kernels.py:corridor_windows (the Pallas TPU
// pointer-advance kernel called from device_engine._convex_kernel).
//
// For problem b and wavefront t (t = x + y):
//   ymin[t] = #{y < H : y + hi(y) <= t},  ymax[t] = #{y < H : y + lo(y) <= t} - 1
// with lo = clip(offs(y), 0, W) and hi = max(clip(offs(y) + width, 0, W), lo)
// for the four affine corridor generators. Both key sequences increase
// strictly in y, so each count advances by 0 or 1 per wavefront and a
// monotone pointer walk yields them exactly. Also returns
// hmax = max_t (ymax - ymin + 1), the realized window height that the
// lane-bound retry checks.
//
// Bound on this card: bytes. The walk is a handful of integer and f32
// operations per wavefront and problem, and each wavefront writes 8 bytes
// per problem, so writing the two [B, TpP] int32 planes is the floor.
//
// Design: one thread walks one problem; a warp holds 32 problems. The walk
// emits 32 wavefronts at a time into a shared [32 x 33] tile, and the warp
// then writes the tile row by row, so each store instruction covers 128
// contiguous bytes of one problem's row instead of 32 scattered words.
#include "common.cuh"

namespace {

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

__global__ void corridor_windows_kernel(const int32_t* __restrict__ pk, int B,
                                        int TpP, int32_t* __restrict__ ymin,
                                        int32_t* __restrict__ ymax,
                                        int32_t* __restrict__ hmax) {
  __shared__ int32_t tmin[32][33], tmax[32][33];
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * 32;
  const int b = b0 + lane;
  const bool live = b < B;
  ngt::AlignRow a;
  if (live) a = ngt::load_align_row(pk, b);
  else a.H = 0;
  int ym = 0, yx = 0, hm = -ngt::BIG;
  for (int t0 = 0; t0 < TpP; t0 += 32) {
    for (int u = 0; u < 32; ++u) {
      const int t = t0 + u;
      if (live) {
        ym += corridor_key(a, ym, true) <= t;
        yx += corridor_key(a, yx, false) <= t;
        hm = yx - ym > hm ? yx - ym : hm;   // ymax - ymin + 1
      }
      tmin[lane][u] = ym;
      tmax[lane][u] = yx - 1;
    }
    __syncwarp();
    for (int pb = 0; pb < 32 && b0 + pb < B; ++pb) {
      const int64_t off = (int64_t)(b0 + pb) * TpP + t0 + lane;
      ymin[off] = tmin[pb][lane];
      ymax[off] = tmax[pb][lane];
    }
    __syncwarp();
  }
  if (live) hmax[b] = hm;
}

}  // namespace

// pk: int32 [B, 12] align rows; ymin/ymax: int32 [B, TpP]; hmax: int32 [B].
// TpP must be a multiple of 32.
extern "C" int ngt_corridor_windows(const void* pk, int B, int TpP, void* ymin,
                                    void* ymax, void* hmax, void* stream) {
  if (B <= 0) return 0;
  if (TpP <= 0 || TpP % 32 != 0) return (int)cudaErrorInvalidValue;
  corridor_windows_kernel<<<(B + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pk, B, TpP, (int32_t*)ymin, (int32_t*)ymax,
      (int32_t*)hmax);
  return (int)cudaGetLastError();
}
