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
// every op outside the walk is 0, so the tail past the walk is zero. A walk
// whose start x + y lies outside [0, TpP) takes no step (state stays WALK).
//
// Bound on this card: latency. The traffic the function needs (the packed
// rows plus one direction byte per step) takes microseconds, but each step's
// address depends on the previous step's direction, so the walk is a serial
// chain. Read straight from the [B, TpP, L] plane (hundreds of MB, far past
// L2), a step costs two dependent device-memory round trips (ymin[t], then
// the byte), ~1.7 us; out of shared memory it costs one shared load.
//
// Design: one block of 8 warps per problem. Thread 0 walks; 7 loader warps
// stage the direction bytes in tiles of R = 60 wavefronts.
//   Reach: a step lowers t by 1 or 2 and y by at most as much, so from a
//   position (yb, tb) the walk meets row t < tb only at y in
//   [yb - (tb - t), yb]. Tile k - 1 is staged from the position where the
//   walk enters tile k (the first tile from the start), so each of its rows
//   needs at most 2R = 120 bytes, whatever L is, and byte j of row t holds
//   the cell y = yb - (tb - t) + j: the walker needs no ymin.
//   Markers: the loaders fold the step's tests into the staged byte. A lane
//   outside [0, L) is STOP; a cell outside the validPath band is OUT; a
//   step that leaves the matrix is EDGE | d; the guard below each tile holds
//   EXIT. So one step is one shared-memory byte load, a byte permute for
//   the move and an add, with the next byte read ahead before the step's
//   exit test resolves; the position is decoded from the index at the exit.
//   Overlap: two tile buffers. While thread 0 walks tile k, the loaders
//   read tile k - 1 (each lane one 4-byte word of a row's window, nine rows
//   a warp, all in flight), align the words with a funnel shift, mark them
//   from a ring of per-row bands held in registers, and store them; a
//   barrier per tile swaps the buffers. The ops go to a shared byte per
//   wavefront and are packed 4 to a byte by the loaders a tile later.
// The walk and the staging take about the same time per tile (PERF.md).
// Rows whose L is not a multiple of 4 (or a misaligned plane) assemble the
// same words from bytes.
#include "common.cuh"

namespace {

constexpr int R = 60;                    // wavefronts per tile, a multiple of 4
constexpr int SPAN = 2 * R;              // staged bytes per row
// A tile row's stride. A step out of the tile's lowest rows lands 1 or 2
// rows below it at a byte index of up to SPAN + 1, so the stride exceeds
// that, and a multiple of 4 keeps the rows' word stores aligned.
constexpr int RS = SPAN + 4;
constexpr int GUARD = 256;               // bytes before a tile: the walk's exits
constexpr int BR = 128;                  // band ring slots, > SPAN
constexpr int LOADERS = 7;               // loader warps per problem
constexpr int RPL = (R + LOADERS - 1) / LOADERS;   // rows a loader stages
constexpr int THREADS = 32 * (1 + LOADERS);
constexpr unsigned FULL = 0xffffffffu;
// staged bytes: a direction 0..3 (STOP, DIAG, INS, DEL), EDGE | d where
// the step d leaves the matrix, OUT where the cell fails the validPath
// band, and EXIT in the guard below a tile (the walk moved past its rows)
constexpr int EDGE = 4, OUT = 8, EXIT = 12;
// per direction d, read with one byte permute (markers give 0): how far a
// step moves the walker's tile index: DIAG 2 RS - 1, INS RS, DEL RS - 1
constexpr uint32_t MOVE_AT = ((uint32_t)(RS - 1) << 24) |
                             ((uint32_t)RS << 16) |
                             ((uint32_t)(2 * RS - 1) << 8);
static_assert(2 * RS - 1 < 256, "a move must fit in a byte of MOVE_AT");
static_assert(GUARD >= 2 * RS, "the guard holds the two rows below a tile");
static_assert(RPL <= 32, "a loader's rows must fit its lanes");

struct Smem {
  uint8_t buf[2][GUARD + R * RS];        // two tiles, each behind its guard
  int2 band[BR];                         // row y's band at slot y % BR
  uint32_t ops[2][R / 4];                // each tile's ops, one byte each
  int walk[3];                           // x, y, state after a tile's walk
};
static_assert((GUARD + R * RS) % 16 == 0, "tiles stay 16-byte aligned");

// n zero bytes from p, by the whole block: 16-byte stores between the
// unaligned head and tail
__device__ void block_zero(uint8_t* p, int n, int tid) {
  int head = (int)((16 - ((uintptr_t)p & 15)) & 15);
  head = head < n ? head : n;
  if (tid < head) p[tid] = 0;
  p += head;
  n -= head;
  const int n16 = n / 16;
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = tid; i < n16; i += THREADS) q[i] = make_uint4(0, 0, 0, 0);
  if (tid < n - n16 * 16) p[n16 * 16 + tid] = 0;
}

// a 4-byte global load written as volatile PTX, so that it is issued where
// it stands (ahead of the walk it is to overlap) and not next to its use
__device__ __forceinline__ uint32_t ldg_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// a shared-memory byte load that stays where it is written: the walker's
// read-ahead, which the compiler would otherwise sink past the step's exit
__device__ __forceinline__ int lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr));
  return (int)v;
}

__device__ __forceinline__ uint32_t move_of(int d) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(m) : "r"(MOVE_AT), "r"(0u), "r"(d));
  return m;
}

// direction bytes 4 wi .. 4 wi + 3 of a row; bytes outside [0, L) are
// junk (WORDS: the nearest word of the row) and masked when stored
template <bool WORDS>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ row,
                                              int wi, int L) {
  if (WORDS) {
    const int last = (L >> 2) - 1;
    return ldg_u32(row + 4 * (int64_t)(wi < 0 ? 0 : (wi > last ? last : wi)));
  }
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i) {
    const int ln = 4 * wi + i;
    if (ln >= 0 && ln < L) v |= (uint32_t)row[ln] << (8 * i);
  }
  return v;
}

// a loader's ymin: lane l holds that of row r0 + l of the tile at t_lo
__device__ __forceinline__ int load_ymin(const int32_t* __restrict__ ymin_b,
                                         int t_lo, int r0, int TpP, int lane) {
  const int r = r0 + lane, t = t_lo + r;
  return lane < RPL && r < R && t < TpP ? ymin_b[t] : 0;
}

// the dirs lane of staged byte 0 of the loader's row r0 + i (warp-uniform)
__device__ __forceinline__ int row_lane0(int i, int t_lo, int r0, int yb,
                                         int tb, int ym) {
  return yb - (tb - t_lo - r0 - i) - __shfl_sync(FULL, ym, i);
}

// issue the word loads of the loader's rows, staged from (yb, tb): lane l
// loads word l of each row's window (rows past the plane read its last
// row: a first tile's rows above the walk's start are never read)
template <bool WORDS>
__device__ __forceinline__ void issue_rows(uint32_t (&w)[RPL],
                                           const uint8_t* __restrict__ dirs_b,
                                           int L, int TpP, int t_lo, int r0,
                                           int yb, int tb, int ym, int lane) {
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int lane0 = row_lane0(i, t_lo, r0, yb, tb, ym);
    const int t = min(t_lo + r0 + i, TpP - 1);
    w[i] = load_word<WORDS>(dirs_b + (int64_t)t * L, (lane0 >> 2) + lane, L);
  }
}

// one staged byte: the direction raw of cell (x, y) (STOP outside
// [0, L)), marked OUT where the cell fails the band and EDGE where its step
// leaves the matrix; STOP stays STOP, whatever the band says. A byte above
// DEL, which the fill never writes, is staged as STOP, so that no byte the
// walker reads can move its index outside the tile.
__device__ __forceinline__ uint32_t mark(uint32_t raw, bool lane_ok, int x,
                                         int y, int2 bd) {
  const bool inband = (uint32_t)x - (uint32_t)bd.x < (uint32_t)bd.y;
  const int dx = raw != ngt::INS, dy = raw != ngt::DEL;
  const bool edge = x - dx < 0 || y - dy < 0;
  return !lane_ok || raw == ngt::STOP || raw > ngt::DEL ? ngt::STOP
         : !inband                    ? OUT
         : edge                       ? raw | EDGE
                                      : raw;
}

// shift each row's words so that byte 0 is the row's lane0, mark them and
// store them. Lane l holds bytes 4 l .. 4 l + 3 of each row, whose rows y
// rise by one from one row of the tile to the next, so the lane reads the
// bands of its RPL + 3 rows y from the ring once and marks in registers.
__device__ __forceinline__ void store_rows(const uint32_t (&w)[RPL],
                                           uint8_t* tile, const int2* band,
                                           int L, int t_lo, int r0, int yb,
                                           int tb, int ym, int lane) {
  const int t0 = t_lo + r0;
  const int y_l = yb - (tb - t0) + 4 * lane;   // row y of the lane's byte 0
  int2 bd[RPL + 3];
#pragma unroll
  for (int e = 0; e < RPL + 3; ++e) bd[e] = band[(y_l + e) & (BR - 1)];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int lane0 = row_lane0(i, t_lo, r0, yb, tb, ym);
    const uint32_t next = __shfl_down_sync(FULL, w[i], 1);
    const uint32_t v = __funnelshift_r(w[i], next, 8 * (lane0 & 3));
    const int t = t0 + i, ln = lane0 + 4 * lane;
    uint32_t o = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = y_l + i + j;
      o |= mark(v >> (8 * j) & 0xff, (uint32_t)(ln + j) < (uint32_t)L, t - y,
                y, bd[i + j]) << (8 * j);
    }
    if (r0 + i < R && lane < SPAN / 4)
      reinterpret_cast<uint32_t*>(tile + (r0 + i) * RS)[lane] = o;
  }
}

// the validPath band of rows y in [lo, hi] into the ring, as (a, n): the
// cell x passes iff min_c < x < max_c iff (unsigned)(x - a) < n, with
// a = min_c + 1, n = max_c - min_c - 1 (n = 0 when no x passes)
__device__ __forceinline__ void stage_band(int2* band, const ngt::AlignRow& a,
                                           float width_f, float tenth, int lo,
                                           int hi, int i0, int stride) {
  for (int y = lo + i0; y <= hi; y += stride) {
    const float o = (float)ngt::corridor_off(a.mode, a.ci, a.k, a.d, y);
    const int min_c = ngt::f2i(__fadd_rn(o, tenth));
    const int max_c =
        ngt::f2i(__fsub_rn(__fadd_rn((float)min_c, width_f), tenth));
    const int64_t n = (int64_t)max_c - min_c - 1;
    band[y & (BR - 1)] =
        n > 0 ? make_int2(min_c + 1, (int)(uint32_t)n) : make_int2(0, 0);
  }
}

__device__ __forceinline__ void loaders_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(LOADERS * 32));
}

// the packed bytes of a walked tile: 4 ops (one byte each) into one byte
__device__ __forceinline__ void pack_ops(uint32_t* ops, uint8_t* out,
                                         int k, int nbytes, int i) {
  const int q = k * (R / 4) + i;
  const uint32_t o = ops[i];
  if (q < nbytes)
    out[q] = (uint8_t)((o & 3) | (o >> 6 & 0xc) | (o >> 12 & 0x30)
                       | (o >> 18 & 0xc0));
  ops[i] = 0;
}

template <bool WORDS>
__global__ void __launch_bounds__(THREADS)
convex_backtrack_kernel(const uint8_t* __restrict__ dirs,
                        const int32_t* __restrict__ ymin,
                        const int32_t* __restrict__ pk,
                        const int32_t* __restrict__ bx_in,
                        const int32_t* __restrict__ by_in, int TpP, int L,
                        uint8_t* __restrict__ packed,
                        int32_t* __restrict__ sx_out,
                        int32_t* __restrict__ sy_out,
                        int32_t* __restrict__ state_out) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int b = blockIdx.x;
  const ngt::AlignRow a = ngt::load_align_row(pk, b);
  const float width_f = (float)a.width;
  const float tenth = __fmul_rn(0.1f, width_f);
  const int32_t* ymin_b = ymin + (int64_t)b * TpP;
  const uint8_t* dirs_b = dirs + (int64_t)b * TpP * L;
  uint8_t* out = packed + (int64_t)b * (TpP / 4);
  const int nbytes = TpP / 4;

  int x = bx_in[b], y = by_in[b];
  int state = y > 0 ? ngt::WALK : ngt::FAIL;
  int sx = -1, sy = -1;
  int t = x + y;
  if (state == ngt::WALK && t >= 0 && t < TpP) {
    const int k0 = t / R;
    int k = k0, t_lo = k * R;
    const int above = (k + 1) * (R / 4);
    if (above < nbytes) block_zero(out + above, nbytes - above, tid);
    for (int i = tid; i < 2 * GUARD; i += THREADS)
      sm.buf[i / GUARD][i % GUARD] = EXIT;
    if (tid < R / 2) sm.ops[tid / (R / 4)][tid % (R / 4)] = 0;
    // Thread 0 walks tile k out of buf[k % 2] while the loader warps stage
    // tile k - 1 into the other buffer, from the position where the walk
    // enters tile k; each loader stages RPL rows. ymn, ymnn: a loader's
    // ymin of tiles k - 1 and k - 2.
    const bool loader = wp > 0;
    const int r0 = (wp - 1) * RPL, lt = tid - 32;
    int ymn = 0, ymnn = 0;
    int syb = y, stb = t;                // the position tile k is staged from
    int band_lo = y - (SPAN - 1);        // the ring holds rows band_lo..
    uint32_t w[RPL];
    if (loader) {
      const int ym = load_ymin(ymin_b, t_lo, r0, TpP, lane);
      if (k > 0) ymn = load_ymin(ymin_b, t_lo - R, r0, TpP, lane);
      issue_rows<WORDS>(w, dirs_b, L, TpP, t_lo, r0, y, t, ym, lane);
      stage_band(sm.band, a, width_f, tenth, band_lo, y, lt, LOADERS * 32);
      loaders_sync();
      store_rows(w, sm.buf[k & 1] + GUARD, sm.band, L, t_lo, r0, y, t, ym,
                 lane);
    }
    __syncthreads();
    while (true) {
      const int yb = y, tb = t;          // where the walk enters tile k
      if (tid == 0) {
        // One step: its byte d, its op into the tile's ops, and the next
        // step's byte read ahead from the moved index before the step's
        // exit test resolves (a marker moves by 0), so the chain per step
        // is one shared load and the move. Unrolled twice so that the two
        // bytes alternate registers.
        uint8_t* ops = reinterpret_cast<uint8_t*>(sm.ops[k & 1]);
        const uint32_t base =
            (uint32_t)__cvta_generic_to_shared(sm.buf[k & 1] + GUARD);
        int at = (t - t_lo) * RS + (y - syb) + (stb - t);
        int d0 = lds_u8(base + at), d1, d;
        while (true) {
          uint32_t mv = move_of(d0);
          d1 = lds_u8(base + at - mv);
          if ((uint32_t)(d0 - 1) > 2u) {
            d = d0;
            break;
          }
          ops[(uint32_t)at / RS] = (uint8_t)d0;
          at -= mv;
          mv = move_of(d1);
          d0 = lds_u8(base + at - mv);
          if ((uint32_t)(d1 - 1) > 2u) {
            d = d1;
            break;
          }
          ops[(uint32_t)at / RS] = (uint8_t)d1;
          at -= mv;
        }
        // the cell where the walk stopped, from its index
        const int r = (at + 2 * RS) / RS - 2;
        const int tt = t_lo + r;
        y = syb + (at - r * RS) - (stb - tt);
        x = tt - y;
        if (d == ngt::STOP) {
          sx = x;
          sy = y;
          state = ngt::DONE;
        } else if (d == OUT) {
          state = ngt::FAIL;
        } else if (d != EXIT) {          // EDGE | op: the op, then off the matrix
          const int op = d & 3;
          ops[r] = (uint8_t)op;
          x -= op != ngt::INS;
          y -= op != ngt::DEL;
          sx = x;
          sy = y;
          state = ngt::DONE;
        }
        sm.walk[0] = x;
        sm.walk[1] = y;
        sm.walk[2] = state;
      } else if (loader) {
        if (k > 0) {
          if (yb - (SPAN - 1) < band_lo)
            stage_band(sm.band, a, width_f, tenth, yb - (SPAN - 1),
                       band_lo - 1, lt, LOADERS * 32);
          issue_rows<WORDS>(w, dirs_b, L, TpP, t_lo - R, r0, yb, tb, ymn,
                            lane);
          if (k > 1) ymnn = load_ymin(ymin_b, t_lo - 2 * R, r0, TpP, lane);
          loaders_sync();
          store_rows(w, sm.buf[(k - 1) & 1] + GUARD, sm.band, L, t_lo - R,
                     r0, yb, tb, ymn, lane);
        }
        if (k < k0 && lt < R / 4)        // tile k + 1 was walked last time
          pack_ops(sm.ops[(k + 1) & 1], out, k + 1, nbytes, lt);
      }
      band_lo = min(band_lo, yb - (SPAN - 1));
      __syncthreads();
      x = sm.walk[0];
      y = sm.walk[1];
      t = x + y;
      state = sm.walk[2];
      if (state != ngt::WALK || k == 0) break;
      --k;
      t_lo -= R;
      syb = yb;
      stb = tb;
      ymn = ymnn;
    }
    if (tid < R / 4) pack_ops(sm.ops[k & 1], out, k, nbytes, tid);
    if (k > 0) block_zero(out, k * (R / 4), tid);
  } else {
    block_zero(out, nbytes, tid);
  }
  if (tid == 0) {
    sx_out[b] = sx;
    sy_out[b] = sy;
    state_out[b] = state;
  }
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
  const bool words = L % 4 == 0 && (uintptr_t)dirs % 4 == 0;
  auto kernel = words ? convex_backtrack_kernel<true>
                      : convex_backtrack_kernel<false>;
  kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, (const int32_t*)ymin, (const int32_t*)pk,
      (const int32_t*)bx, (const int32_t*)by, TpP, L, (uint8_t*)packed,
      (int32_t*)sx, (int32_t*)sy, (int32_t*)state);
  return (int)cudaGetLastError();
}
