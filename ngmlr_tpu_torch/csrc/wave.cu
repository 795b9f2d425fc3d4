// One native-engine wave's device round trip (pipeline/native_engine.py,
// NativeWave): the wave's align and score rows planned (wave_plan.h),
// staged into pinned memory, uploaded once, every launch chain and score
// bucket launched on the caller's stream through the kernels' own
// launchers, every chain's scalars and packed ops and every bucket's scores
// written into one device result region and fetched back with one copy,
// then unpacked into the arrays the engine's engine_post_results takes.
//
// It replaces, on one CUDA device, DeviceContext.align_dispatch_pk,
// score_dispatch_np and fetch_waves_np and NativeEngine._post (about 150
// PyTorch and ctypes calls and two per-row Python loops a wave): the wave
// thread makes two calls here, each without the interpreter lock. It adds
// no arithmetic: the kernels, their shapes, the padding of the blocks and
// the counters are the Python wave's.
//
// Memory: the caller owns a device arena and a pinned host buffer (both
// from torch's allocators) and passes them in `cfg`; a call that finds them
// too small writes the bytes it needs into cfg and returns NEED before it
// stages or launches anything, and the caller grows them and calls again.
// The arena holds [uploaded blocks | results | one chain's work (corridor
// windows, direction planes, fill scratch), reused chain after chain on the
// one stream]; the pinned buffer holds the uploaded blocks and the results
// of the first pass, then those of a lane-bound retry after them.

#include <cuda_runtime.h>

#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>

#include "wave_plan.h"

extern "C" int ngt_score_fill(const void* genome, int64_t plane,
                              const void* readbuf, int64_t rlen, const void* pk,
                              int P, int Rp, int Qp, void* out, void* stream);
extern "C" int ngt_corridor_windows(const void* pk, int B, int TpP, void* ymin,
                                    void* ymax, void* hmax, void* stream);
extern "C" int ngt_convex_fill(const void* genome, int64_t plane,
                               const void* readbuf, int64_t rlen, const void* pk,
                               const void* params, const void* ymin,
                               const void* ymax, int B, int TpP, int L,
                               void* dirs, void* best, void* by, void* bx,
                               void* scratch, void* stream);
extern "C" int ngt_convex_backtrack(const void* dirs, const void* ymin,
                                    const void* pk, const void* bx,
                                    const void* by, int B, int TpP, int L,
                                    void* packed, void* sx, void* sy,
                                    void* state, void* stream);
extern "C" int64_t ngt_convex_fill_state_bytes(int L);
extern "C" int64_t ngt_convex_fill_smem_cap();

namespace {

using ngt_plan::ALIGN_COLS;
using ngt_plan::SCORE_COLS;

// The int64 slots of cfg (pipeline/native_engine.py: CFG, same order).
// LANES exists only for the card test that forces the lane-bound retry
// (every row that many lanes); the pipeline leaves it 0.
enum Cfg {
  GENOME, PLANE, READBUF, RLEN, PARAMS, STREAM, DEVICE, DIRS_CAP, N_UNITS,
  LANES, DEV, DEV_BYTES, HOST, HOST_BYTES, COUNTS, SECS, NEED_DEV, NEED_HOST
};
// The counters added into cfg[COUNTS] (int64) and cfg[SECS] (f64)
// (pipeline/native_engine.py: COUNT_KEYS then LAUNCH_KEYS, and SEC_KEYS,
// same order). The LAUNCHED_* slots count each kernel where it launched.
enum Count {
  ALIGN_WAVES, ALIGN_LAUNCHES, ALIGN_PROBLEMS, CELLS_ALIGN,
  CELLS_ALIGN_USEFUL, ALIGNMENT_OK, ALIGNMENT_ALL, CORRIDOR_SUM,
  LANE_BOUND_RETRIES, SCORE_WAVES, SCORE_LAUNCHES, SCORE_PROBLEMS,
  CELLS_SCORE, CELLS_SCORE_USEFUL, NATIVE_WAVES,
  LAUNCHED_CORRIDOR, LAUNCHED_FILL, LAUNCHED_BACKTRACK, LAUNCHED_SCORE
};
enum Sec { ALIGN_S, ALIGN_FETCH_S, SCORE_S };

constexpr int OK = 0, NEED = 1, BAD_UNIT = 2;
constexpr int DONE = 1;                  // convex_backtrack's state

int64_t up(int64_t x) { return (x + 255) / 256 * 256; }

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

// One pass of a wave: its rows, their plan and where its blocks and results
// lie in the arena (from 0) and in the pinned buffer (from host0).
struct Pass {
  const int32_t* apk = nullptr;
  int64_t na = 0;
  const int32_t* spk = nullptr;
  int64_t ns = 0;
  bool conservative = false;   // width + 3 lanes, results taken as they are
  ngt_plan::AlignPlan ap;
  ngt_plan::ScorePlan sp;
  std::vector<int64_t> a_in, a_res, s_in, s_res;
  int64_t in_bytes = 0, res_bytes = 0, work_bytes = 0, host0 = 0;

  int64_t dev_need() const { return in_bytes + res_bytes + work_bytes; }
  int64_t host_need() const { return host0 + in_bytes + res_bytes; }
};

struct Wave {
  Pass first, retry;
  std::vector<int32_t> retry_rows;   // the wave row of each row to retry
  std::vector<int32_t> retried;      // the same, while the retry unpacks
  std::vector<int32_t> retry_pk;     // their rows [R, 12]
  cudaEvent_t ev = nullptr;
  int stage = 0;                     // 0 idle, 1 launched, 2 first unpacked
  int64_t n_ok = 0, corr = 0;        // the first pass's rows, then the wave's
  // what engine_post_results takes
  std::vector<float> score, s_result;
  std::vector<int32_t> bx, by;
  std::vector<uint8_t> ok;
  std::vector<int64_t> ops_off, ops_len;
  std::vector<const uint8_t*> ops;
};

void layout(Pass& p, int64_t host0) {
  const auto& chunks = p.ap.chunks;
  const auto& buckets = p.sp.buckets;
  p.a_in.resize(chunks.size());
  p.a_res.resize(chunks.size());
  p.s_in.resize(buckets.size());
  p.s_res.resize(buckets.size());
  int64_t in = 0, res = 0, work = 0;
  for (size_t c = 0; c < chunks.size(); ++c) {
    const auto& k = chunks[c];
    const int64_t Tp = k.Wp + k.Hp;
    p.a_in[c] = in;
    in += up(k.B * ALIGN_COLS * 4);
    // packed ops [B, Tp / 4], then best, bx, by, sx, sy, state, hmax [B]
    p.a_res[c] = res;
    res += up(k.B * Tp / 4 + 7 * 4 * k.B);
    const int64_t state = ngt_convex_fill_state_bytes((int)k.L);
    const int64_t scratch =
        state > ngt_convex_fill_smem_cap() ? up(k.B * state) : 0;
    const int64_t w = 2 * up(k.B * Tp * 4) + up(k.B * Tp * k.L) + scratch;
    work = w > work ? w : work;
  }
  for (size_t b = 0; b < buckets.size(); ++b) {
    p.s_in[b] = in;
    in += up(buckets[b].B * SCORE_COLS * 4);
    p.s_res[b] = res;
    res += up(buckets[b].B * 4);
  }
  p.in_bytes = in;
  p.res_bytes = res;
  p.work_bytes = work;
  p.host0 = host0;
}

// The kernels' blocks, as DeviceContext builds them: align slots past the
// rows are inert (width 1, k 1.0, qlen 0), score slots zero.
void stage_align(const Pass& p, uint8_t* host) {
  const float one = 1.0f;
  for (size_t c = 0; c < p.ap.chunks.size(); ++c) {
    const auto& k = p.ap.chunks[c];
    int32_t* blk = (int32_t*)(host + p.host0 + p.a_in[c]);
    std::memset(blk, 0, k.B * ALIGN_COLS * 4);
    for (int64_t b = 0; b < k.B; ++b) {
      blk[b * ALIGN_COLS + 9] = 1;
      std::memcpy(&blk[b * ALIGN_COLS + 10], &one, 4);
    }
    for (int64_t j = 0; j < k.n; ++j)
      std::memcpy(blk + j * ALIGN_COLS,
                  p.apk + (int64_t)p.ap.rows[k.row0 + j] * ALIGN_COLS,
                  ALIGN_COLS * 4);
  }
}

void stage_score(const Pass& p, uint8_t* host) {
  for (size_t b = 0; b < p.sp.buckets.size(); ++b) {
    const auto& k = p.sp.buckets[b];
    int32_t* blk = (int32_t*)(host + p.host0 + p.s_in[b]);
    std::memset(blk, 0, k.B * SCORE_COLS * 4);
    for (int64_t j = 0; j < k.n; ++j)
      std::memcpy(blk + j * SCORE_COLS,
                  p.spk + (int64_t)p.sp.rows[k.row0 + j] * SCORE_COLS,
                  SCORE_COLS * 4);
  }
}

// Upload, every chain, every bucket, the results' copy back and the event
// after it, all on the caller's stream. Returns 0 or -(CUDA error).
int launch_pass(Wave& w, const Pass& p, const int64_t* cfg, double* score_s) {
  cudaStream_t st = (cudaStream_t)cfg[STREAM];
  uint8_t* host = (uint8_t*)cfg[HOST];
  uint8_t* d_in = (uint8_t*)cfg[DEV];
  uint8_t* d_res = d_in + p.in_bytes;
  uint8_t* d_work = d_res + p.res_bytes;
  const void* genome = (const void*)cfg[GENOME];
  const void* readbuf = (const void*)cfg[READBUF];
  const void* params = (const void*)cfg[PARAMS];
  int64_t* n = (int64_t*)cfg[COUNTS];
  cudaError_t e = cudaMemcpyAsync(d_in, host + p.host0, p.in_bytes,
                                  cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return -(int)e;
  int rc = 0;
  for (size_t c = 0; c < p.ap.chunks.size() && !rc; ++c) {
    const auto& k = p.ap.chunks[c];
    const int B = (int)k.B, Tp = (int)(k.Wp + k.Hp), L = (int)k.L;
    const void* blk = d_in + p.a_in[c];
    uint8_t* packed = d_res + p.a_res[c];
    int32_t* sc = (int32_t*)(packed + k.B * Tp / 4);
    uint8_t* ymin = d_work;
    uint8_t* ymax = ymin + up(k.B * Tp * 4);
    uint8_t* dirs = ymax + up(k.B * Tp * 4);
    uint8_t* scratch = ngt_convex_fill_state_bytes(L) > ngt_convex_fill_smem_cap()
                           ? dirs + up(k.B * Tp * k.L)
                           : nullptr;
    rc = ngt_corridor_windows(blk, B, Tp, ymin, ymax, sc + 6 * B, st);
    if (rc) break;
    ++n[LAUNCHED_CORRIDOR];
    rc = ngt_convex_fill(genome, cfg[PLANE], readbuf, cfg[RLEN], blk, params,
                         ymin, ymax, B, Tp, L, dirs, sc, sc + 2 * B, sc + B,
                         scratch, st);
    if (rc) break;
    ++n[LAUNCHED_FILL];
    rc = ngt_convex_backtrack(dirs, ymin, blk, sc + B, sc + 2 * B, B, Tp, L,
                              packed, sc + 3 * B, sc + 4 * B, sc + 5 * B, st);
    if (!rc) ++n[LAUNCHED_BACKTRACK];
  }
  const auto t0 = std::chrono::steady_clock::now();
  for (size_t b = 0; b < p.sp.buckets.size() && !rc; ++b) {
    const auto& k = p.sp.buckets[b];
    rc = ngt_score_fill(genome, cfg[PLANE], readbuf, cfg[RLEN], d_in + p.s_in[b],
                        (int)k.B, (int)k.Rp, (int)k.Qp, d_res + p.s_res[b], st);
    if (!rc) ++n[LAUNCHED_SCORE];
  }
  *score_s += seconds_since(t0);
  if (rc) return -rc;
  e = cudaMemcpyAsync(host + p.host0 + p.in_bytes, d_res, p.res_bytes,
                      cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess) e = cudaEventRecord(w.ev, st);
  return e == cudaSuccess ? 0 : -(int)e;
}

bool bad_units(const int32_t* pk, int64_t n, int cols, int64_t n_units) {
  for (int64_t i = 0; i < n; ++i)
    if ((((int64_t)pk[i * cols + 3] >> 28) & 0xF) >= n_units) return true;
  return false;
}

// A pass's align results into the wave's arrays; pass row j is the wave's
// row rows[j] (nullptr: j). In a first pass, rows whose realised window
// height passes their launch's lanes go to retry_rows instead. Returns the
// ok rows; *corr gets the results' corridor widths.
int64_t unpack_align(Wave& w, const Pass& p, const uint8_t* host,
                     const int32_t* rows, int64_t* corr) {
  int64_t n_ok = 0;
  for (size_t c = 0; c < p.ap.chunks.size(); ++c) {
    const auto& k = p.ap.chunks[c];
    const int64_t T4 = (k.Wp + k.Hp) / 4;
    const int64_t res = p.host0 + p.in_bytes + p.a_res[c];
    const int32_t* sc = (const int32_t*)(host + res + k.B * T4);
    for (int64_t j = 0; j < k.n; ++j) {
      const int32_t pr = p.ap.rows[k.row0 + j];
      const int32_t i = rows ? rows[pr] : pr;
      if (!p.conservative && sc[6 * k.B + j] > k.L) {
        w.retry_rows.push_back(i);
        continue;
      }
      std::memcpy(&w.score[i], &sc[j], 4);
      w.bx[i] = sc[k.B + j];
      w.by[i] = sc[2 * k.B + j];
      const bool okf = sc[5 * k.B + j] == DONE;
      w.ok[i] = okf ? 1 : 0;
      w.ops_off[i] = okf ? res + j * T4 : -1;
      w.ops_len[i] = okf ? T4 : 0;
      n_ok += okf;
      *corr += p.apk[(int64_t)pr * ALIGN_COLS + 9];
    }
  }
  return n_ok;
}

void unpack_score(Wave& w, const Pass& p, const uint8_t* host) {
  for (size_t b = 0; b < p.sp.buckets.size(); ++b) {
    const auto& k = p.sp.buckets[b];
    const float* out = (const float*)(host + p.host0 + p.in_bytes + p.s_res[b]);
    for (int64_t j = 0; j < k.n; ++j) w.s_result[p.sp.rows[k.row0 + j]] = out[j];
  }
}

// The first pass's counters (DeviceContext's align and score dispatches).
void count_dispatch(const Pass& p, int64_t* n) {
  n[ALIGN_WAVES] += (int64_t)p.ap.chunks.size();
  n[ALIGN_LAUNCHES] += (int64_t)p.ap.chunks.size();
  n[ALIGN_PROBLEMS] += p.na;
  n[CELLS_ALIGN] += p.ap.cells;
  n[CELLS_ALIGN_USEFUL] += p.ap.cells_useful;
  n[SCORE_WAVES] += (int64_t)p.sp.buckets.size();
  n[SCORE_LAUNCHES] += (int64_t)p.sp.buckets.size();
  n[SCORE_PROBLEMS] += p.ns;
  n[CELLS_SCORE] += p.sp.cells;
  n[CELLS_SCORE_USEFUL] += p.sp.cells_useful;
}

// Sets the caller's device current for the scope (the kernels and their
// per-device attribute opt-ins go to the runtime's current device).
struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int dev) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~OnDevice() {
    int cur;
    if (prev >= 0 && cudaGetDevice(&cur) == cudaSuccess && cur != prev)
      cudaSetDevice(prev);
  }
};

int need(int64_t* cfg, int64_t dev, int64_t host) {
  if (dev <= cfg[DEV_BYTES] && host <= cfg[HOST_BYTES]) return OK;
  cfg[NEED_DEV] = dev;
  cfg[NEED_HOST] = host;
  return NEED;
}

}  // namespace

extern "C" void* ngt_wave_create() { return new Wave(); }

extern "C" void ngt_wave_destroy(void* h) {
  Wave* w = (Wave*)h;
  if (w->ev) cudaEventDestroy(w->ev);
  delete w;
}

// Plans, stages and launches one wave: apk [na, 12] and spk [ns, 7], the
// rows engine_wait_wave handed out (read again by ngt_wave_fetch, so they
// must stay put until it returns). Returns OK, NEED (cfg[NEED_DEV],
// cfg[NEED_HOST] hold the bytes; nothing was launched), BAD_UNIT (a row
// names a genome unit past cfg[N_UNITS]; nothing was launched) or
// -(CUDA error).
extern "C" int ngt_wave_launch(void* h, const int32_t* apk, int64_t na,
                               const int32_t* spk, int64_t ns, int64_t* cfg) {
  const auto t0 = std::chrono::steady_clock::now();
  Wave& w = *(Wave*)h;
  if (bad_units(apk, na, ALIGN_COLS, cfg[N_UNITS]) ||
      bad_units(spk, ns, SCORE_COLS, cfg[N_UNITS]))
    return BAD_UNIT;
  Pass& p = w.first;
  p.apk = apk;
  p.na = na;
  p.spk = spk;
  p.ns = ns;
  p.conservative = false;
  ngt_plan::plan_align(apk, na, false, cfg[LANES], cfg[DIRS_CAP], p.ap);
  const auto ts = std::chrono::steady_clock::now();
  ngt_plan::plan_score(spk, ns, p.sp);
  double score_s = seconds_since(ts);
  layout(p, 0);
  int rc = need(cfg, p.dev_need(), p.host_need());
  if (rc != OK) return rc;
  OnDevice on((int)cfg[DEVICE]);
  if (on.err != cudaSuccess) return -(int)on.err;
  if (!w.ev) {
    cudaError_t e = cudaEventCreateWithFlags(
        &w.ev, cudaEventDisableTiming | cudaEventBlockingSync);
    if (e != cudaSuccess) return -(int)e;
  }
  uint8_t* host = (uint8_t*)cfg[HOST];
  stage_align(p, host);
  const auto tss = std::chrono::steady_clock::now();
  stage_score(p, host);
  score_s += seconds_since(tss);
  rc = launch_pass(w, p, cfg, &score_s);
  if (rc) return rc;
  w.stage = 1;
  int64_t* n = (int64_t*)cfg[COUNTS];
  count_dispatch(p, n);
  n[NATIVE_WAVES] += 1;
  double* s = (double*)cfg[SECS];
  const double total = seconds_since(t0);
  s[SCORE_S] += score_s;
  s[ALIGN_S] += total - score_s;
  return OK;
}

// Waits for the wave's results, reruns the rows past their lane bound
// with width + 3 lanes (as DeviceContext.align_finalize_pk does), and
// points out[0..6] at what engine_post_results takes: align scores f32,
// best x, best y i32, ok u8, the ops pointer table (into the pinned
// buffer), the ops lengths i64 [na], the score results f32 [ns] (rows
// past the guard -1). Returns OK, NEED (grow, keeping the pinned buffer's
// bytes, and call again) or -(CUDA error).
extern "C" int ngt_wave_fetch(void* h, int64_t* cfg, void** out) {
  const auto t0 = std::chrono::steady_clock::now();
  Wave& w = *(Wave*)h;
  Pass& p = w.first;
  int64_t* n = (int64_t*)cfg[COUNTS];
  double* s = (double*)cfg[SECS];
  const uint8_t* host = (const uint8_t*)cfg[HOST];
  if (w.stage == 1) {
    cudaError_t e = cudaEventSynchronize(w.ev);
    if (e != cudaSuccess) return -(int)e;
    const int64_t na = p.na, ns = p.ns;
    w.score.assign(na ? na : 1, 0.f);
    w.bx.assign(na ? na : 1, -1);
    w.by.assign(na ? na : 1, -1);
    w.ok.assign(na ? na : 1, 0);
    w.ops_off.assign(na ? na : 1, -1);
    w.ops_len.assign(na ? na : 1, 0);
    w.s_result.assign(ns ? ns : 1, ns ? -1.f : 0.f);
    w.retry_rows.clear();
    w.corr = 0;
    w.n_ok = unpack_align(w, p, host, nullptr, &w.corr);
    unpack_score(w, p, host);
    w.stage = 2;
  }
  if (w.stage == 2 && !w.retry_rows.empty()) {
    Pass& r = w.retry;
    const int64_t R = (int64_t)w.retry_rows.size();
    w.retry_pk.resize(R * ALIGN_COLS);
    for (int64_t j = 0; j < R; ++j)
      std::memcpy(&w.retry_pk[j * ALIGN_COLS],
                  p.apk + (int64_t)w.retry_rows[j] * ALIGN_COLS, ALIGN_COLS * 4);
    r.apk = w.retry_pk.data();
    r.na = R;
    r.spk = nullptr;
    r.ns = 0;
    r.conservative = true;
    ngt_plan::plan_align(r.apk, R, true, 0, cfg[DIRS_CAP], r.ap);
    ngt_plan::plan_score(nullptr, 0, r.sp);
    layout(r, p.host_need());
    int rc = need(cfg, r.dev_need(), r.host_need());
    if (rc != OK) {
      s[ALIGN_FETCH_S] += seconds_since(t0);
      return rc;
    }
    OnDevice on((int)cfg[DEVICE]);
    if (on.err != cudaSuccess) return -(int)on.err;
    stage_align(r, (uint8_t*)cfg[HOST]);
    double unused = 0;
    rc = launch_pass(w, r, cfg, &unused);
    if (rc) return rc;
    cudaError_t e = cudaEventSynchronize(w.ev);
    if (e != cudaSuccess) return -(int)e;
    n[LANE_BOUND_RETRIES] += R;
    n[ALIGN_WAVES] += (int64_t)r.ap.chunks.size();
    n[ALIGN_LAUNCHES] += (int64_t)r.ap.chunks.size();
    n[ALIGN_PROBLEMS] += R;
    n[CELLS_ALIGN] += r.ap.cells;
    n[CELLS_ALIGN_USEFUL] += r.ap.cells_useful;
    // the retry's own finalize counts its rows, and the wave's counts them
    // again (DeviceContext.align_finalize_pk's recursion)
    int64_t corr2 = 0;
    w.retried.swap(w.retry_rows);
    w.retry_rows.clear();
    const int64_t ok2 = unpack_align(w, r, host, w.retried.data(), &corr2);
    n[ALIGNMENT_OK] += ok2;
    n[ALIGNMENT_ALL] += R;
    n[CORRIDOR_SUM] += corr2;
    w.n_ok += ok2;
    for (int64_t j = 0; j < R; ++j) w.corr += r.apk[j * ALIGN_COLS + 9];
  }
  if (p.na) {
    n[ALIGNMENT_OK] += w.n_ok;
    n[ALIGNMENT_ALL] += p.na;
    n[CORRIDOR_SUM] += w.corr;
  }
  w.ops.resize(w.ops_off.size());
  for (size_t i = 0; i < w.ops_off.size(); ++i)
    w.ops[i] = w.ops_off[i] >= 0 ? host + w.ops_off[i] : nullptr;
  out[0] = w.score.data();
  out[1] = w.bx.data();
  out[2] = w.by.data();
  out[3] = w.ok.data();
  out[4] = (void*)w.ops.data();
  out[5] = w.ops_len.data();
  out[6] = w.s_result.data();
  w.stage = 0;
  s[ALIGN_FETCH_S] += seconds_since(t0);
  return OK;
}

// The plan the last ngt_wave_launch launched (its first pass: a lane-bound
// retry's launches, made inside ngt_wave_fetch, are not among them), for
// instrumentation. sizes[3]: chains, rows refused by the cap, score
// buckets. With chains non-null also: chains [n, 6] (L, Wp, Hp, B, the
// block's byte offset, the results' byte offset), refused (indices into
// the wave's align rows), buckets [n, 5] (Rp, Qp, B, block and results
// offsets). A block holds the launch's rows in launch order, padded to B;
// an offset holds in both the device arena and the pinned buffer; a
// chain's results are its packed ops [B, (Wp + Hp) / 4] then best, bx, by,
// sx, sy, state, hmax int32 [B] each.
extern "C" void ngt_wave_plan(void* h, int64_t* sizes, int64_t* chains,
                              int32_t* refused, int64_t* buckets) {
  const Pass& p = ((Wave*)h)->first;
  const auto& chunks = p.ap.chunks;
  const auto& bks = p.sp.buckets;
  sizes[0] = (int64_t)chunks.size();
  sizes[1] = (int64_t)p.ap.failed.size();
  sizes[2] = (int64_t)bks.size();
  if (!chains) return;
  for (size_t c = 0; c < chunks.size(); ++c) {
    const auto& k = chunks[c];
    const int64_t v[6] = {k.L,       k.Wp, k.Hp, k.B,
                          p.a_in[c], p.in_bytes + p.a_res[c]};
    std::memcpy(chains + c * 6, v, sizeof v);
  }
  for (size_t b = 0; b < bks.size(); ++b) {
    const int64_t v[5] = {bks[b].Rp, bks[b].Qp, bks[b].B, p.s_in[b],
                          p.in_bytes + p.s_res[b]};
    std::memcpy(buckets + b * 5, v, sizeof v);
  }
  std::memcpy(refused, p.ap.failed.data(), p.ap.failed.size() * 4);
}
