// expand_votes: per-vote slot values of the device candidate search's
// row-local slot tables.
//
// Replaces: ngmlr_tpu/ops/pallas_kernels.py:expand_votes (the Pallas TPU
// telescoping compare-accumulate kernel called from
// ngmlr_tpu/seed/device_search.py:_search_kernel_v2).
//
// Row b holds one subread's SL2 = 2 * SL vote slots (even = forward bucket,
// odd = reverse bucket of each k-mer position) plus one pad slot. cum2 is
// the row's inclusive cumsum of per-slot vote counts, so it never decreases,
// and vote l < L of the row belongs to
//   slot[b,l] = #{j < SL2 : cum2[b,j] <= l}      (SL2, the pad slot, past
//                                                  the row's last vote)
// with d2t[b,l] = d2tp[b, slot] (position-index base) and
// ct[b,l] = ct2p[b, slot] (bin correction). This equals the Pallas kernel's
// telescoped sums v0 + sum_j [bnd_j <= l] * dval_j bit for bit: int32 sums
// of differences telescope exactly, wrap-around included.
//
// Bound on this card: bytes. Each vote writes 12 bytes and does about ten
// compare-and-select steps; each row reads its 3 x ~545 table words once.
//
// Design: one block per row stages the row's three tables in shared memory
// (~6.5 KB); threads stride over l, each doing an upper-bound binary search
// over the staged cum2 (10 steps for 544 slots), two shared-memory reads,
// and three coalesced stores. The TPU kernel's [SLP, Bp] transposes, the
// 128-lane padding of B and the differenced tables were layout matters of
// the TPU and are gone.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void expand_votes_kernel(const int32_t* __restrict__ cum2,
                                    const int32_t* __restrict__ d2tp,
                                    const int32_t* __restrict__ ct2p,
                                    int SL2, int L,
                                    int32_t* __restrict__ slot,
                                    int32_t* __restrict__ d2t,
                                    int32_t* __restrict__ ct) {
  extern __shared__ int32_t smem[];
  int32_t* s_cum = smem;                // [SL2]
  int32_t* s_d2t = smem + SL2;          // [SL2 + 1]
  int32_t* s_ct = s_d2t + SL2 + 1;      // [SL2 + 1]
  const int64_t b = blockIdx.x;
  const int32_t* cum_row = cum2 + b * SL2;
  const int32_t* d2t_row = d2tp + b * (SL2 + 1);
  const int32_t* ct_row = ct2p + b * (SL2 + 1);
  for (int j = threadIdx.x; j < SL2; j += blockDim.x) s_cum[j] = cum_row[j];
  for (int j = threadIdx.x; j <= SL2; j += blockDim.x) {
    s_d2t[j] = d2t_row[j];
    s_ct[j] = ct_row[j];
  }
  __syncthreads();
  int32_t* slot_row = slot + b * L;
  int32_t* d2t_out = d2t + b * L;
  int32_t* ct_out = ct + b * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    // first j with cum2[j] > l: the number of boundaries at or below l
    int lo = 0, hi = SL2;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cum[mid] <= l) lo = mid + 1;
      else hi = mid;
    }
    slot_row[l] = lo;
    d2t_out[l] = s_d2t[lo];
    ct_out[l] = s_ct[lo];
  }
}

}  // namespace

// cum2: int32 [B, SL2] (non-decreasing rows); d2tp, ct2p: int32
// [B, SL2 + 1]; slot, d2t, ct: int32 [B, L].
extern "C" int ngt_expand_votes(const void* cum2, const void* d2tp,
                                const void* ct2p, int B, int SL2, int L,
                                void* slot, void* d2t, void* ct,
                                void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (SL2 <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * SL2 + 2) * sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  expand_votes_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cum2, (const int32_t*)d2tp, (const int32_t*)ct2p, SL2,
      L, (int32_t*)slot, (int32_t*)d2t, (int32_t*)ct);
  return (int)cudaGetLastError();
}
