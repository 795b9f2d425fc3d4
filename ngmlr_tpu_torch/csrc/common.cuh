// Shared device helpers of the four alignment kernels.
//
// Every kernel reads its problems from the packed int32 rows the host
// engine produces (ngmlr_tpu_torch/ops/device_engine.py):
//   score rows [P, 7]:  ds u32, hi u32, diff, W, qstart, qlen, qrev
//   align rows [B, 12]: the same seven, then corridor mode, ci, width,
//                       k (f32 bits), d (f32 bits)
// and gathers sequence codes straight from the device genome and read
// buffer (no [B, W] window tensors exist on the card).
//
// All f32 arithmetic here must round exactly as the JAX reference does on
// its CPU backend: the build passes -fmad=false and the helpers below use
// the _rn intrinsics, so no multiply-add is ever contracted.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ngt {

constexpr int STOP = 0, DIAG = 1, INS = 2, DEL = 3;
constexpr int XCODE = 5;   // 'x': undecodable reference, never equals a query code
constexpr int NCODE = 4;
constexpr int CORRIDOR_FULL = 0, CORRIDOR_LINEAR = 1, CORRIDOR_ENDPOINTS = 2,
              CORRIDOR_ANCHORS = 3;
constexpr int WALK = 0, DONE = 1, FAIL = 2;
constexpr int W_MASK = (1 << 28) - 1;   // bits 28+ of the W column: unit id
constexpr int32_t BIG = 1 << 30;

// Reference window code i of a RefDesc (ds, diff, hi, W): the genome code at
// ds + i - diff when diff <= i < W and that position is below hi, else 'x'.
__device__ __forceinline__ int ref_code(const uint8_t* __restrict__ genome,
                                        int64_t glen, uint32_t ds, int diff,
                                        uint32_t hi, int W, int i) {
  if (i < diff || i >= W) return XCODE;
  const int64_t pos = (int64_t)ds + (int64_t)(i - diff);
  if (pos >= (int64_t)hi) return XCODE;
  return genome[pos < glen ? pos : glen - 1];
}

// Query code j of a QryDesc (start, length, rev): the read slice,
// reverse-complemented (code ^ 1 for A/T/G/C) when rev, N past its length.
__device__ __forceinline__ int qry_code(const uint8_t* __restrict__ readbuf,
                                        int64_t rlen, int start, int length,
                                        int rev, int j) {
  if (j < 0 || j >= length) return NCODE;
  const int src = rev ? length - 1 - j : j;
  int64_t pos = (int64_t)start + src;
  pos = pos < 0 ? 0 : (pos >= rlen ? rlen - 1 : pos);
  int c = readbuf[pos];
  if (rev && c < 4) c ^= 1;
  return c;
}

// f32 -> int32 truncation with XLA's saturating semantics (NaN -> 0).
__device__ __forceinline__ int f2i(float v) { return __float2int_rz(v); }

// Per-row corridor offset of the four affine generators
// (AlignmentBuffer.cpp:52-197), f32-exact against the JAX twin
// (device_engine._corridor_offs).
__device__ __forceinline__ int corridor_off(int mode, int ci, float k,
                                            float d, int y) {
  if (mode == CORRIDOR_FULL) return ci;
  if (mode == CORRIDOR_LINEAR) return y - ci;
  const float yf = (float)y;
  if (mode == CORRIDOR_ENDPOINTS) return f2i(__fdiv_rn(__fsub_rn(yf, d), k));
  return f2i(__fsub_rn(__fdiv_rn(yf, k), d));
}

struct AlignRow {
  uint32_t ds, hi;
  int diff, W, qs, H, rev, mode, ci, width;
  float k, d;
};

__device__ __forceinline__ AlignRow load_align_row(const int32_t* __restrict__ pk,
                                                   int b) {
  const int32_t* r = pk + (int64_t)b * 12;
  AlignRow a;
  a.ds = (uint32_t)r[0];
  a.hi = (uint32_t)r[1];
  a.diff = r[2];
  a.W = r[3] & W_MASK;
  a.qs = r[4];
  a.H = r[5];
  a.rev = r[6];
  a.mode = r[7];
  a.ci = r[8];
  a.width = r[9];
  a.k = __int_as_float(r[10]);
  a.d = __int_as_float(r[11]);
  return a;
}

}  // namespace ngt
