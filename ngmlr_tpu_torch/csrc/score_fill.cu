// score_fill: batched ungapped local-segment scores (the StrippedSW
// candidate filter).
//
// Replaces: ngmlr_tpu/ops/pallas_kernels.py:score_fill (the Pallas TPU
// kernel behind device_engine._score_kernel), including the XLA gathers
// _gather_ref / _gather_qry that fed it.
//
// Computes, per problem p, max over (i, j) of H[i][j] with
//   H[i][j] = max(H[i-1][j-1] + s(ref[i], qry[j]), 0),  H[-1][*] = H[*][-1] = 0
//   s = +1 if the codes are equal and qry < 4; -1 if both are < 4 and
//   differ; 0 otherwise
// over the padded Rp x Qp bucket, returned as f32.
//
// Bound on this card: integer operations. The hot bucket is 320 x 256 cells
// per problem at about six integer operations a cell, against 7 + 1 bytes of
// descriptor and result per problem, so the DRAM traffic is negligible and
// the recurrence's ALU work sets the floor.
//
// Design: one block per problem, thread j owns query rows j*R .. j*R+R-1 in
// registers (R = 1 at the hot shape, larger buckets loop). Per reference
// column, a thread needs the previous column's value of the row just above
// its first row: a warp shuffle inside the warp, and a double-buffered
// shared slot across warp edges, with one __syncthreads() per column. The
// reference window is gathered once into shared memory (up to 128 KB for
// the widest bucket, past the default 48 KB by the opt-in attribute); the
// query codes live in registers for the whole fill.
#include "common.cuh"

namespace {

template <int R>
__global__ void score_fill_kernel(const uint8_t* __restrict__ genome,
                                  int64_t plane,
                                  const uint8_t* __restrict__ readbuf,
                                  int64_t rlen, const int32_t* __restrict__ pk,
                                  int Rp, float* __restrict__ out) {
  extern __shared__ uint8_t sref[];           // [Rp] reference codes
  __shared__ int32_t edge[2][32];             // last row value of each warp
  __shared__ int32_t wbest[32];

  const int b = blockIdx.x;
  const int32_t* row = pk + (int64_t)b * 7;
  const uint32_t ds = (uint32_t)row[0], hi = (uint32_t)row[1];
  const int diff = row[2], W = row[3] & ngt::W_MASK;
  const int qs = row[4], qlen = row[5], rev = row[6];
  const uint8_t* g = ngt::plane_base(genome, ngt::row_unit(row[3]), plane);

  for (int i = threadIdx.x; i < Rp; i += blockDim.x)
    sref[i] = (uint8_t)ngt::ref_code(g, plane, ds, diff, hi, W, i);
  if (threadIdx.x < 32) edge[0][threadIdx.x] = 0;

  int q[R], h[R];
  const int j0 = threadIdx.x * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    q[r] = ngt::qry_code(readbuf, rlen, qs, qlen, rev, j0 + r);
    h[r] = 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int best = 0;
  __syncthreads();

  for (int i = 0; i < Rp; ++i) {
    const int rc = sref[i];
    int up = __shfl_up_sync(0xffffffffu, h[R - 1], 1);
    if (lane == 0) up = warp > 0 ? edge[i & 1][warp - 1] : 0;
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int qc = q[r];
      const int s = (qc < 4) ? ((qc == rc) ? 1 : (rc < 4 ? -1 : 0)) : 0;
      const int prev = r > 0 ? h[r - 1] : up;
      const int v = prev + s;
      h[r] = v > 0 ? v : 0;
      best = h[r] > best ? h[r] : best;
    }
    if (lane == 31) edge[(i + 1) & 1][warp] = h[R - 1];
    __syncthreads();
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v = __shfl_down_sync(0xffffffffu, best, o);
    best = v > best ? v : best;
  }
  if (lane == 0) wbest[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = wbest[w] > m ? wbest[w] : m;
    out[b] = (float)m;
  }
}

template <int R>
cudaError_t launch(const uint8_t* genome, int64_t plane, const uint8_t* readbuf,
                   int64_t rlen, const int32_t* pk, int P, int Rp, int Qp,
                   float* out, cudaStream_t stream) {
  const int threads = Qp / R;
  if (Rp > 48 * 1024) {
    // the widest bucket the host launches is 131072 columns (W < MAX_SEQ_LEN)
    cudaError_t e = cudaFuncSetAttribute(
        score_fill_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, Rp);
    if (e != cudaSuccess) return e;
  }
  score_fill_kernel<R><<<P, threads, Rp, stream>>>(genome, plane, readbuf, rlen,
                                                  pk, Rp, out);
  return cudaGetLastError();
}

}  // namespace

// genome: unit planes of `plane` bytes each (a flat genome: one plane, the
// whole buffer), every row's unit below their count; Rp: padded reference
// columns; Qp: padded query rows, a power of two >= 64.
extern "C" int ngt_score_fill(const void* genome, int64_t plane,
                              const void* readbuf, int64_t rlen, const void* pk,
                              int P, int Rp, int Qp, void* out, void* stream) {
  if (P <= 0) return 0;
  if (Qp < 64 || (Qp & (Qp - 1)) != 0 || Rp <= 0)
    return (int)cudaErrorInvalidValue;
  auto g = (const uint8_t*)genome;
  auto rb = (const uint8_t*)readbuf;
  auto p = (const int32_t*)pk;
  auto o = (float*)out;
  auto s = (cudaStream_t)stream;
  const int R = Qp <= 1024 ? 1 : Qp / 1024;
  switch (R) {
    case 1: return (int)launch<1>(g, plane, rb, rlen, p, P, Rp, Qp, o, s);
    case 2: return (int)launch<2>(g, plane, rb, rlen, p, P, Rp, Qp, o, s);
    case 4: return (int)launch<4>(g, plane, rb, rlen, p, P, Rp, Qp, o, s);
    case 8: return (int)launch<8>(g, plane, rb, rlen, p, P, Rp, Qp, o, s);
    case 16: return (int)launch<16>(g, plane, rb, rlen, p, P, Rp, Qp, o, s);
    case 32: return (int)launch<32>(g, plane, rb, rlen, p, P, Rp, Qp, o, s);
    case 64: return (int)launch<64>(g, plane, rb, rlen, p, P, Rp, Qp, o, s);
    case 128: return (int)launch<128>(g, plane, rb, rlen, p, P, Rp, Qp, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
