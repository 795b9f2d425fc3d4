// convex_backtrack: reverse walk over the direction planes from the best
// cell, emitting one CIGAR op per wavefront, packed 2 bits each.
//
// Replaces: ngmlr_tpu/ops/pallas_kernels.py:convex_backtrack (the Pallas TPU
// kernel behind device_engine._convex_kernel) and the XLA 2-bit packing that
// followed it.
//
// From (bx, by) (FAIL at once when by <= 0), at wavefront t = x + y the walk
// reads d = dirs[b, t, y - ymin(t)] (STOP when the lane is outside [0, L)):
//   STOP ends the walk as DONE at (x, y);
//   leaving the validPath band (AlignmentMatrixFast.cpp:213-220:
//   min_c = trunc(offs(y) + 0.1 width), max_c = trunc(min_c + width -
//   0.1 width), in f32; the cell needs min_c < x < max_c) ends it as FAIL;
//   otherwise d is emitted at t and the walk steps to the diagonal, upper or
//   left neighbour; stepping off the matrix ends it as DONE there.
// Op t lands in bits 2*(t % 4) of byte t / 4 of the problem's packed row;
// every op outside the walk is 0, so the tail past the walk is zero.
//
// Bound on this card: bytes, in principle: the packed rows (TpP / 4 bytes per
// problem) are the only traffic the function needs, plus one direction
// byte per step of the walk. The walk itself is a serial chain of dependent
// loads (each step's address depends on the previous direction), so its
// latency, not bandwidth, is what a run sees.
//
// Design: one thread walks one problem and writes its packed row byte by
// byte from the top wavefront down, fusing the pack into the walk.
// Problems run in parallel across threads; a step costs one dependent
// direction-byte load and one ymin load, both through L1/L2.
#include "common.cuh"

namespace {

__global__ void convex_backtrack_kernel(const uint8_t* __restrict__ dirs,
                                        const int32_t* __restrict__ ymin,
                                        const int32_t* __restrict__ pk,
                                        const int32_t* __restrict__ bx_in,
                                        const int32_t* __restrict__ by_in,
                                        int B, int TpP, int L,
                                        uint8_t* __restrict__ packed,
                                        int32_t* __restrict__ sx_out,
                                        int32_t* __restrict__ sy_out,
                                        int32_t* __restrict__ state_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const ngt::AlignRow a = ngt::load_align_row(pk, b);
  const float width_f = (float)a.width;
  const float tenth = __fmul_rn(0.1f, width_f);
  const int32_t* ymin_b = ymin + (int64_t)b * TpP;
  const uint8_t* dirs_b = dirs + (int64_t)b * TpP * L;
  uint8_t* out = packed + (int64_t)b * (TpP / 4);

  int x = bx_in[b], y = by_in[b];
  int state = y > 0 ? ngt::WALK : ngt::FAIL;
  int sx = -1, sy = -1;
  for (int q = TpP / 4 - 1; q >= 0; --q) {
    unsigned byte = 0;
    for (int u = 3; u >= 0 && state == ngt::WALK; --u) {
      const int t = 4 * q + u;
      if (x + y != t) continue;
      const int lane = y - ymin_b[t];
      const int d = (lane >= 0 && lane < L) ? dirs_b[(int64_t)t * L + lane]
                                            : ngt::STOP;
      if (d == ngt::STOP) {
        sx = x;
        sy = y;
        state = ngt::DONE;
        break;
      }
      const float o = (float)ngt::corridor_off(a.mode, a.ci, a.k, a.d, y);
      const int min_c = ngt::f2i(__fadd_rn(o, tenth));
      const int max_c = ngt::f2i(__fsub_rn(__fadd_rn((float)min_c, width_f), tenth));
      if (!(x > min_c && x < max_c)) {
        state = ngt::FAIL;
        break;
      }
      byte |= (unsigned)d << (2 * u);
      x -= (d == ngt::DIAG || d == ngt::DEL);
      y -= (d == ngt::DIAG || d == ngt::INS);
      if (x < 0 || y < 0) {
        sx = x;
        sy = y;
        state = ngt::DONE;
      }
    }
    out[q] = (uint8_t)byte;
  }
  sx_out[b] = sx;
  sy_out[b] = sy;
  state_out[b] = state;
}

}  // namespace

// dirs u8 [B, TpP, L]; ymin int32 [B, TpP]; pk int32 [B, 12]; bx/by int32 [B]
// -> packed u8 [B, TpP / 4], sx/sy/state int32 [B]. TpP must be a multiple
// of 4.
extern "C" int ngt_convex_backtrack(const void* dirs, const void* ymin,
                                    const void* pk, const void* bx,
                                    const void* by, int B, int TpP, int L,
                                    void* packed, void* sx, void* sy,
                                    void* state, void* stream) {
  if (B <= 0) return 0;
  if (TpP <= 0 || TpP % 4 != 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  convex_backtrack_kernel<<<(B + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, (const int32_t*)ymin, (const int32_t*)pk,
      (const int32_t*)bx, (const int32_t*)by, B, TpP, L, (uint8_t*)packed,
      (int32_t*)sx, (int32_t*)sy, (int32_t*)state);
  return (int)cudaGetLastError();
}
