// Native per-read long-read assembly engine.
//
// C++ twin of ngmlr_tpu/pipeline/longread.py + ngmlr_tpu/align/aligner.py +
// ngmlr_tpu/chain/{structs,clis}.py — which are the verified rebuild of
// AlignmentBuffer::processLongReadLIS and its helpers
// (ngmlr src/AlignmentBuffer.cpp:2845-3464 and callees). The Python
// implementation remains the oracle (goldens + fuzz compare the two); this
// engine is the production host path: it removes the per-read Python
// interpreter cost that binds single-chip throughput on a 1-core host.
//
// Execution model (mirrors pipeline/batcher.py): one FIBER (stackful
// coroutine) per read runs the straight-line per-read control flow on a
// fixed worker-thread pool; every device request (banded convex alignment
// or ungapped scoring probe) is posted to a wave gate and the fiber parks.
// The Python host loop collects a wave when every live fiber is
// parked-or-done, runs the batched kernels through DeviceContext, posts
// results, and requeues the fibers. Numeric points follow the Python
// sources op-for-op: float where np.float32 was used, double elsewhere;
// build with -ffp-contract=off so x86 FMA contraction can never change a
// rounding (see native/__init__.py).
//
// Interface: plain C, used via ctypes (see pipeline/native_engine.py).

#include <unistd.h>

#include <atomic>
#include <algorithm>
#include <array>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include <pthread.h>
#include <sys/mman.h>
#include <time.h>
#include <ucontext.h>

#include "../csrc/wave_plan.h"

// ops_convert from cigar_native.cpp (compiled into the same .so)
extern "C" {
struct CigarResult {
  int32_t valid;
  int32_t ref_position;
  int32_t final_cigar_length;
  int32_t nm;
  float identity;
  int32_t alignment_length;
  int32_t cigar_op_count;
  int32_t qstart;
  int32_t qend;
  int32_t first_ref_pos, first_read_pos, last_ref_pos, last_read_pos;
  int64_t cigar_len;
  int64_t md_len;
  int64_t nm_pos_count;
};
int ops_convert(const uint8_t* packed_ops, int64_t packed_len_bytes,
                int32_t best_x, int32_t best_y, const char* ref_window,
                int64_t ref_window_len, const char* qry, int64_t qry_len,
                int32_t external_qstart, int32_t external_qend,
                char* cigar_out, int64_t cigar_cap, char* md_out,
                int64_t md_cap, int32_t* nm_pos_out,
                int64_t nm_pos_cap_triples, CigarResult* res);
}

namespace ngmlr_engine {

// --------------------------------------------------------------------------
// config + reference metadata
// --------------------------------------------------------------------------

constexpr int64_t SPACER = 1000;          // io/reference.py:37
constexpr int32_t SV_NONE = 0, SV_INVERSION = 1, SV_TRANSLOCATION = 2;
static const char CODE2CHAR[6] = {'A', 'T', 'G', 'C', 'N', 'x'};

struct Config {                            // the cfg fields the path reads
  float score_match, score_mismatch, score_gap_open, score_gap_extend_max,
      score_gap_extend_min, score_gap_decay;   // (device params; unused here)
  double min_identity;                     // config.py:22
  double min_residues;                     // config.py:23
  double inv_score_ratio;                  // config.py:51
  double max_segment_number_per_kb;        // IConfig.h:36
  int32_t min_inversion_length;            // IConfig.h:32
  int32_t read_part_length;                // 256
  int32_t max_matrix_size_mb;              // IConfig.h:47
  int32_t small_inversion_detection;
  int32_t low_quality_split;
  int32_t max_clis_runs;                   // 100
  int32_t skip_align;
};

struct RefMeta {
  const uint8_t* codes;     // uint8 genome codes (A0 T1 G2 C3 N4)
  int64_t codes_len;
  int64_t concat_len;       // codes_len - 1 (reference.py:135-137)
  const int64_t* sp;        // ref_start_pos incl. terminator
  int32_t n_sp;
};

struct Chrom { int64_t start, end; };

// c_round: C round() — half away from zero (chain/structs.py:66-69)
static inline int64_t c_round(double v) {
  return v >= 0 ? (int64_t)std::floor(v + 0.5) : (int64_t)std::ceil(v - 0.5);
}

// upper_bound index like np.searchsorted(side="right")
static inline int32_t upper_idx(const RefMeta& rm, int64_t pos) {
  const int64_t* e = std::upper_bound(rm.sp, rm.sp + rm.n_sp, pos);
  return (int32_t)(e - rm.sp);
}

// getChrStart (reference.py:158-168, SequenceProvider.cpp:157-178)
static Chrom get_chr_start(const RefMeta& rm, int64_t position) {
  int32_t upper = upper_idx(rm, position);
  if (upper >= rm.n_sp) return {rm.sp[rm.n_sp - 1], rm.concat_len};
  if (rm.sp[upper] - position < SPACER) upper += 1;
  if (upper >= rm.n_sp) return {rm.sp[rm.n_sp - 1], rm.concat_len};
  return {rm.sp[upper - 1], rm.sp[upper] - SPACER};
}

// getChrBorders (reference.py:170-184); (0,0) when spanning chromosomes
static Chrom get_chr_borders(const RefMeta& rm, int64_t start, int64_t stop) {
  if (start > stop) std::swap(start, stop);
  if (start < SPACER) {
    start = SPACER + 1;
    stop = std::max<int64_t>(SPACER + 2, stop);
  }
  int32_t upper_start = upper_idx(rm, start);
  if (upper_start < rm.n_sp && rm.sp[upper_start] - start < SPACER)
    upper_start += 1;
  int32_t upper_stop = upper_idx(rm, stop);
  if (upper_start == upper_stop && 0 < upper_start && upper_start < rm.n_sp)
    return {rm.sp[upper_start - 1], rm.sp[upper_start] - SPACER};
  return {0, 0};
}

// Device recipe for a decoded reference window (ops/device_engine.py:98-107)
struct RefDesc { uint32_t ds, hi; int32_t diff, W; };

// decode_exact_desc (reference.py:239-266); valid=false when Python
// returns None
static bool decode_exact_desc(const RefMeta& rm, int64_t start_position,
                              int64_t sequence_length, RefDesc* out) {
  if (start_position >= rm.concat_len || start_position < 0) return false;
  int64_t W = sequence_length - 1;
  Chrom chrom = get_chr_start(rm, start_position);
  int64_t decode_start = start_position;
  int64_t end_position = start_position + sequence_length;
  int64_t decode_end = end_position;
  if (end_position > chrom.end) decode_end -= (end_position - chrom.end);
  int64_t ds, diff;
  if (decode_start < chrom.start) {
    if (decode_end > chrom.start) {
      diff = chrom.start - decode_start;
      ds = chrom.start;
    } else {
      *out = {0, 0, 0, (int32_t)W};   // fully in spacer
      return true;
    }
  } else {
    diff = 0;
    ds = decode_start;
  }
  int64_t first_pair = (ds & 1) ? ds + 1 : ds;
  int64_t hi = std::min(first_pair + 2 * ((decode_end - ds + 1) / 2),
                        rm.codes_len);
  *out = {(uint32_t)ds, (uint32_t)hi, (int32_t)diff, (int32_t)W};
  return true;
}

// decode_window_desc (reference.py:222-237)
static bool decode_window_desc(const RefMeta& rm, int64_t position,
                               int64_t buffer_length, RefDesc* out) {
  int64_t length = buffer_length - 2;
  if (position >= rm.concat_len || position < 0) return false;
  int64_t end = 0;
  if (position + length > rm.concat_len) {
    end = (position + length) - rm.concat_len;
    length -= end;
  }
  int64_t d = (position & 1) + 2 * ((length + 1) / 2);
  int64_t hi = std::min(position + d, rm.codes_len);
  *out = {(uint32_t)position, (uint32_t)hi, 0,
          (int32_t)((hi - position) + end)};
  return true;
}

// _decode_span (reference.py:268-280): bases [start, ~end]
static void decode_span(const RefMeta& rm, int64_t start_pos, int64_t end_pos,
                        std::string* out) {
  int64_t p = start_pos;
  int64_t first_pair_base = p;
  if (p & 1) {
    out->push_back(CODE2CHAR[rm.codes[p]]);
    first_pair_base = p + 1;
  }
  int64_t npairs = (end_pos - start_pos + 1) / 2;
  int64_t hi = std::min(first_pair_base + 2 * npairs, rm.codes_len);
  for (int64_t i = first_pair_base; i < hi; ++i)
    out->push_back(CODE2CHAR[rm.codes[i]]);
}

// decode_exact with corridor == 0 — the only case this path uses
// (reference.py:282-313); returns false when Python returns None
static bool decode_exact(const RefMeta& rm, int64_t start_position,
                         int64_t sequence_length, std::string* buf) {
  if (start_position >= rm.concat_len || start_position < 0) return false;
  buf->assign((size_t)sequence_length, 'x');
  Chrom chrom = get_chr_start(rm, start_position);
  int64_t decode_start = start_position;
  int64_t end_position = start_position + sequence_length;
  int64_t decode_end = end_position;
  if (end_position > chrom.end) decode_end -= (end_position - chrom.end);
  std::string dec;
  if (decode_start < chrom.start) {
    if (decode_end > chrom.start) {
      int64_t diff = chrom.start - decode_start;
      decode_span(rm, chrom.start, decode_end, &dec);
      if (diff < (int64_t)buf->size()) {
        size_t n = std::min(dec.size(), buf->size() - (size_t)diff);
        memcpy(&(*buf)[diff], dec.data(), n);
      }
    }
    // else: fully in spacer; stays 'x'
  } else {
    decode_span(rm, decode_start, decode_end, &dec);
    size_t n = std::min(dec.size(), buf->size());
    memcpy(&(*buf)[0], dec.data(), n);
  }
  buf->resize((size_t)(sequence_length - 1));
  return true;
}

// --------------------------------------------------------------------------
// core records
// --------------------------------------------------------------------------

struct Anchor {            // chain/structs.py:17-23
  int64_t on_read;
  int64_t on_ref;
  float score;
  bool is_reverse;
  bool is_unique;
};

struct Interval {          // chain/structs.py:26-52
  int64_t on_read_start = 0, on_read_stop = 0;
  int64_t on_ref_start = 0, on_ref_stop = 0;
  double m = 0.0, b = 0.0, r = 0.0;
  float score = 0.0f;
  int32_t id = 0;
  bool is_reverse = false;
  bool is_processed = false;
  std::vector<Anchor> anchors;

  int64_t length_on_read() const { return on_read_stop - on_read_start; }
  int64_t length_on_ref() const {
    int64_t d = on_ref_stop - on_ref_start;
    return d < 0 ? -d : d;
  }
};

// SeqView (io/reads.py:57-87): (start, length, rev) into one read's bytes
struct SeqView {
  int64_t start;
  int64_t length;
  bool rev;
  bool valid = true;

  SeqView sub(int64_t a, int64_t b) const {   // io/reads.py:75-80
    int64_t n = b - a;
    if (!rev) return {start + a, n, false, true};
    return {start + length - b, n, true, true};
  }
  SeqView revcomp() const { return {start, length, !rev, true}; }
};

// Align result (align/cigar.py:28-53)
struct AlignRes {
  std::string cigar, md;
  float score = -1.0f;
  float identity = 0.0f;
  int32_t nm = 0;
  int32_t mq = 0;
  int32_t qstart = 0, qend = 0;
  int32_t position_offset = 0;
  int32_t alignment_length = 0;
  int32_t cigar_op_count = 0;
  int32_t first_ref_pos = 0, first_read_pos = 0;
  int32_t last_ref_pos = 0, last_read_pos = 0;
  std::vector<int32_t> nm_per_position;    // [n*3] (readPos, refPos, nm)
  bool skip = false;
  bool primary = false;
  int32_t sv_type = 0;
  int32_t final_cigar_length = -1;
  Interval mapped_interval;
  bool has_mapped_interval = false;
};

struct Record {            // pipeline/longread.py:73-83 AlignmentRecord
  AlignRes align;
  int64_t location = 0;
  bool reverse = false;
  float score = 0.0f;
};

// --------------------------------------------------------------------------
// std::sort permutation helper (replays the reference's introsort order,
// native/cigar_native.cpp std_sort_perm_* — same comparator pattern)
// --------------------------------------------------------------------------

template <typename K, typename Cmp>
static std::vector<int32_t> sort_perm(const std::vector<K>& keys, Cmp cmp) {
  std::vector<int32_t> idx(keys.size());
  for (size_t i = 0; i < idx.size(); ++i) idx[i] = (int32_t)i;
  std::sort(idx.begin(), idx.end(), cmp);
  return idx;
}

template <typename T, typename KeyFn>
static void std_sorted_i64(std::vector<T>& items, KeyFn key) {
  // _std_sorted with int64 keys ascending (longread.py:53-58)
  std::vector<int64_t> keys(items.size());
  for (size_t i = 0; i < items.size(); ++i) keys[i] = key(items[i]);
  auto idx = sort_perm(keys, [&keys](int32_t a, int32_t b) {
    return keys[a] < keys[b];
  });
  std::vector<T> out;
  out.reserve(items.size());
  for (int32_t i : idx) out.push_back(std::move(items[i]));
  items = std::move(out);
}

template <typename T, typename KeyFn>
static void std_sorted_f32_desc(std::vector<T>& items, KeyFn key) {
  std::vector<float> keys(items.size());
  for (size_t i = 0; i < items.size(); ++i) keys[i] = key(items[i]);
  auto idx = sort_perm(keys, [&keys](int32_t a, int32_t b) {
    return keys[a] > keys[b];
  });
  std::vector<T> out;
  out.reserve(items.size());
  for (int32_t i : idx) out.push_back(std::move(items[i]));
  items = std::move(out);
}

// --------------------------------------------------------------------------
// geometric predicates (chain/structs.py)
// --------------------------------------------------------------------------

static inline bool is_same_direction(const Interval& a, const Interval& b) {
  return a.is_reverse == b.is_reverse;
}

static inline bool is_contained(const Interval& a, const Interval& b) {
  // AlignmentBuffer.cpp:792-797
  return a.on_read_start >= b.on_read_start &&
         a.on_read_stop <= b.on_read_stop &&
         a.on_ref_start >= b.on_ref_start && a.on_ref_stop <= b.on_ref_stop &&
         a.is_reverse == b.is_reverse;
}

// isIntervalInCorridor (AlignmentBuffer.cpp:592-639)
static bool interval_in_corridor(double k, double d, double corridor,
                                 const Interval& testee, bool switched) {
  int64_t on_ref_start = testee.on_ref_start;
  int64_t on_ref_stop = testee.on_ref_stop;
  if (switched) std::swap(on_ref_start, on_ref_stop);

  double y = (double)testee.on_read_start;
  int64_t upper = c_round((y - (d + corridor)) / k);
  int64_t lower = c_round((y - (d - corridor)) / k);
  if (upper < lower) std::swap(upper, lower);
  bool in_corridor = lower <= on_ref_start && on_ref_start <= upper;

  y = (double)testee.on_read_stop;
  upper = c_round((y - (d + corridor)) / k);
  lower = c_round((y - (d - corridor)) / k);
  if (upper < lower) std::swap(upper, lower);
  return in_corridor && (lower <= on_ref_stop && on_ref_stop <= upper);
}

// isCompatible (AlignmentBuffer.cpp:709-752; chain/structs.py:95-104)
static bool is_compatible(const Interval& a, const Interval& b,
                          double corridor_size = 8192.0) {
  if (!(b.m != 0 && b.b != 0 && (b.r * b.r) > 0.8)) return false;
  if (a.is_reverse == b.is_reverse)
    return interval_in_corridor(b.m, b.b, corridor_size, a, false);
  return interval_in_corridor(b.m, b.b, corridor_size, a, true) ||
         interval_in_corridor(a.m, a.b, corridor_size, b, true);
}

static inline int64_t get_overlap_on_read(const Interval& a,
                                          const Interval& b) {
  return std::max<int64_t>(
      0, std::min(a.on_read_stop, b.on_read_stop) -
             std::max(a.on_read_start, b.on_read_start));
}

static inline int64_t get_distance_on_read(const Interval& a,
                                           const Interval& b) {
  if (b.on_read_start < a.on_read_start)
    return std::max<int64_t>(0, a.on_read_start - b.on_read_stop);
  return std::max<int64_t>(0, b.on_read_start - a.on_read_stop);
}

static inline int64_t get_distance_on_ref(const Interval& a,
                                          const Interval& b) {
  // AlignmentBuffer.cpp:2346-2360
  if (b.is_reverse) {
    if (b.on_ref_stop < a.on_ref_stop)
      return std::max<int64_t>(0, a.on_ref_stop - b.on_ref_start);
    return std::max<int64_t>(0, b.on_ref_stop - a.on_ref_start);
  }
  if (b.on_ref_start < a.on_ref_start)
    return std::max<int64_t>(0, a.on_ref_start - b.on_ref_stop);
  return std::max<int64_t>(0, b.on_ref_start - a.on_ref_stop);
}

// isDuplication (AlignmentBuffer.cpp:836-860) -> (dup, dupLength)
static bool is_duplication(const Interval& a, const Interval& b,
                           int64_t* dup_length) {
  int64_t overlap_on_read = get_overlap_on_read(a, b);
  int64_t overlap_on_ref;
  if (a.is_reverse) {
    overlap_on_ref = std::max<int64_t>(
        0, std::min(a.on_ref_start, b.on_ref_start) -
               std::max(a.on_ref_stop, b.on_ref_stop));
  } else {
    overlap_on_ref = std::max<int64_t>(
        0, std::min(a.on_ref_stop, b.on_ref_stop) -
               std::max(a.on_ref_start, b.on_ref_start));
  }
  int64_t overlap_diff = std::max<int64_t>(0, overlap_on_ref - overlap_on_read);
  const int64_t rp = 256;
  *dup_length = overlap_diff;
  return overlap_on_ref >= rp && overlap_on_read <= rp && overlap_diff > 0;
}

// canSpanDeletionInsertion (AlignmentBuffer.cpp:754-776)
static bool can_span_deletion_insertion(const Interval& a, const Interval& b,
                                        double corridor_size) {
  int64_t distance_on_read = get_distance_on_read(a, b);
  int64_t distance_on_ref = get_distance_on_ref(a, b);
  int64_t d = distance_on_ref - distance_on_read;
  if (d < 0) d = -d;
  return (double)d < corridor_size;
}

// mergeIntervals (AlignmentBuffer.cpp:800-828) — mutates a
static void merge_intervals(Interval& a, const Interval& b) {
  if (a.on_read_start > b.on_read_start) {
    a.on_read_start = b.on_read_start;
    a.on_ref_start = b.on_ref_start;
  }
  if (a.on_read_stop < b.on_read_stop) {
    a.on_read_stop = b.on_read_stop;
    a.on_ref_stop = b.on_ref_stop;
  }
  a.score = a.score + b.score;    // float(f32(a)+f32(b))
  a.anchors.insert(a.anchors.end(), b.anchors.begin(), b.anchors.end());
}

// --------------------------------------------------------------------------
// cLIS + interval extraction (chain/clis.py)
// --------------------------------------------------------------------------

// clis (chain/clis.py:20-75 / native clis_chain): chain indices ascending
static void clis(const std::vector<Anchor>& anchors, int32_t read_part_length,
                 std::vector<int32_t>* out) {
  out->clear();
  int32_t n = (int32_t)anchors.size();
  if (n == 0) return;
  std::vector<int32_t> dp(n), trace(n);
  const double max_ref_diff = (double)read_part_length * 2.0;
  int32_t max_length = 1, best_end = 0;
  for (int32_t i = 0; i < n; ++i) {
    dp[i] = 1;
    trace[i] = -1;
    const Anchor& ai = anchors[i];
    for (int32_t j = i - 1; j >= 0; --j) {
      if (dp[j] + 1 <= dp[i]) continue;
      const Anchor& aj = anchors[j];
      if (aj.is_reverse != ai.is_reverse) continue;
      int64_t ref_diff = aj.is_reverse ? (aj.on_ref - ai.on_ref)
                                       : (ai.on_ref - aj.on_ref);
      int64_t read_diff = ai.on_read - aj.on_read;
      int64_t adiff = ref_diff >= read_diff ? ref_diff - read_diff
                                            : read_diff - ref_diff;
      int64_t aref = ref_diff < 0 ? -ref_diff : ref_diff;
      int64_t mx = aref > read_diff ? aref : read_diff;
      int64_t max_diff = (int64_t)((double)mx * 0.25);
      if ((adiff < max_diff ||
           (ai.on_read == aj.on_read && aref <= (int64_t)read_part_length)) &&
          (double)ref_diff < max_ref_diff && ref_diff >= 0) {
        dp[i] = dp[j] + 1;
        trace[i] = j;
      }
    }
    if (dp[i] > max_length) {
      best_end = i;
      max_length = dp[i];
    }
  }
  int32_t i = best_end;
  while (trace[i] != -1) {
    out->push_back(i);
    i = trace[i];
  }
  out->push_back(i);
  std::reverse(out->begin(), out->end());
}

// linreg (LinearRegression.cpp:11-45; chain/clis.py:78-94) — double
static void linreg(const std::vector<double>& xs, const std::vector<double>& ys,
                   double* m, double* b, double* r) {
  double n = (double)xs.size();
  double sumx = 0, sumx2 = 0, sumxy = 0, sumy = 0, sumy2 = 0;
  for (double x : xs) { sumx += x; sumx2 += x * x; }
  for (size_t i = 0; i < xs.size(); ++i) sumxy += xs[i] * ys[i];
  for (double y : ys) { sumy += y; sumy2 += y * y; }
  double denom = n * sumx2 - sumx * sumx;
  if (denom == 0) { *m = 0.0; *b = 0.0; *r = 0.0; return; }
  *m = (n * sumxy - sumx * sumy) / denom;
  *b = (sumy * sumx2 - sumx * sumxy) / denom;
  double num = sumxy - sumx * sumy / n;
  double den = std::sqrt((sumx2 - sumx * sumx / n) * (sumy2 - sumy * sumy / n));
  *r = den != 0 ? num / den : std::nan("");
}

// getIntervalsFromAnchors (chain/clis.py:97-207; AlignmentBuffer.cpp:876-1115)
static void get_intervals_from_anchors(const std::vector<Anchor>& anchors_in,
                                       int32_t max_segment_count,
                                       int32_t max_clis_runs,
                                       int32_t read_part_length,
                                       std::vector<Interval>* intervals) {
  intervals->clear();
  // std::sort by on_read incl. introsort tie order (clis.py:107-111)
  std::vector<int64_t> keys(anchors_in.size());
  for (size_t i = 0; i < anchors_in.size(); ++i) keys[i] = anchors_in[i].on_read;
  auto order = sort_perm(keys, [&keys](int32_t a, int32_t b) {
    return keys[a] < keys[b];
  });
  std::vector<Anchor> pool;
  pool.reserve(anchors_in.size());
  for (int32_t i : order) pool.push_back(anchors_in[i]);

  int32_t clis_run_number = 0;
  int32_t run_number = 0;
  std::vector<int32_t> chain;
  while (clis_run_number < max_segment_count) {
    run_number += 1;
    if (run_number >= max_clis_runs) break;
    if (pool.empty()) break;
    clis(pool, read_part_length, &chain);
    if (chain.empty()) break;

    std::vector<char> in_chain(pool.size(), 0);
    for (int32_t c : chain) in_chain[c] = 1;
    std::vector<Anchor> picked, remaining;
    picked.reserve(chain.size());
    remaining.reserve(pool.size() - chain.size());
    for (int32_t c : chain) picked.push_back(pool[c]);
    for (size_t i = 0; i < pool.size(); ++i)
      if (!in_chain[i]) remaining.push_back(pool[i]);

    int64_t min_on_read = 0x7FFFFFFFLL;       // 2**31 - 1 (clis.py:133)
    int64_t max_on_read = 0;
    int64_t min_on_ref = (int64_t)1 << 62;
    int64_t max_on_ref = 0;
    bool is_reverse = false;
    float interval_score = 0.0f;
    std::vector<double> reg_x, reg_y;
    bool is_unique = false;

    for (const Anchor& a : picked) {
      is_unique = is_unique || a.is_unique;
      int64_t on_read = a.on_read;
      is_reverse = a.is_reverse;
      interval_score = interval_score + a.score;   // f32 accumulation
      if (is_reverse) {
        if (on_read < min_on_read) {
          min_on_read = on_read;
          min_on_ref = a.on_ref + read_part_length;
        }
        if (on_read + read_part_length > max_on_read) {
          max_on_read = on_read + read_part_length;
          max_on_ref = a.on_ref;
        }
      } else {
        if (on_read < min_on_read) {
          min_on_read = on_read;
          min_on_ref = a.on_ref;
        }
        if (on_read + read_part_length > max_on_read) {
          max_on_read = on_read + read_part_length;
          max_on_ref = a.on_ref + read_part_length;
        }
      }
      reg_y.push_back((double)on_read);
      reg_x.push_back(
          (double)(is_reverse ? a.on_ref + read_part_length : a.on_ref));
    }

    if (is_unique) {
      if (reg_x.size() == 1) {
        reg_x = {(double)min_on_ref, (double)max_on_ref};
        reg_y = {(double)min_on_read, (double)max_on_read};
      }
      double m, b, r;
      linreg(reg_x, reg_y, &m, &b, &r);

      Interval iv;
      iv.anchors = std::move(picked);
      iv.is_reverse = is_reverse;
      iv.score = interval_score;
      iv.on_read_start = min_on_read;
      iv.on_read_stop = max_on_read;
      iv.on_ref_start = min_on_ref;
      iv.on_ref_stop = max_on_ref;
      iv.m = m;
      iv.b = b;
      iv.r = r;
      if (iv.length_on_read() > 0 && iv.length_on_ref() > 0)
        intervals->push_back(std::move(iv));
      clis_run_number += 1;
    }

    pool = std::move(remaining);
  }
}

}  // namespace ngmlr_engine

namespace ngmlr_engine {

// --------------------------------------------------------------------------
// wave gate: per-read FIBERS (stackful ucontext coroutines) post device
// requests and park; a fixed worker-thread pool (NGMLR_TPU_ENGINE_THREADS,
// default = hardware_concurrency) runs fibers until every live fiber is
// parked-or-done, at which point the Python host loop collects the wave, runs
// the batched kernels, and posts results (pipeline/batcher.py WaveBatcher
// semantics). Fibers replace the round-2 thread-per-read model so
// batch_reads can scale 10x+ without thousands of OS threads (the reference
// itself uses a fixed pool, NGM.cpp:334-348): a fiber costs one lazily
// committed MAP_NORESERVE stack, and a park/resume is one swapcontext pair
// instead of a kernel scheduler round trip.
// --------------------------------------------------------------------------

constexpr int32_t CORRIDOR_FULL = 0, CORRIDOR_LINEAR = 1,
                  CORRIDOR_ENDPOINTS = 2, CORRIDOR_ANCHORS = 3;

struct Fiber;

struct AlignReq {
  RefDesc ref;
  int32_t qstart = 0, qlen = 0;     // absolute read-buffer offset
  uint8_t qrev = 0;
  int32_t mode = 0, ci = 0, width = 0;
  float k = 1.0f, d = 0.0f;
  // response
  float score = 0.0f;
  int32_t best_x = -1, best_y = -1;
  uint8_t ok = 0;
  std::vector<uint8_t> ops;
  Fiber* owner = nullptr;           // fiber parked on this request
};

struct ScoreReq {
  RefDesc ref;
  int32_t qstart = 0, qlen = 0;
  uint8_t qrev = 0;
  float result = 0.0f;
  Fiber* owner = nullptr;           // fiber parked on this request
};

struct Engine;

struct ScoredSub {
  int64_t on_read;
  int32_t mq;
  std::vector<int64_t> locations;
  std::vector<uint8_t> reverse;
  std::vector<float> scores;
};

struct ReadCtx {
  int64_t length = 0;
  int64_t buf_offset = 0;      // absolute offset in the device read buffer
  const char* seq = nullptr;   // host read bytes (owned by Python)
  std::vector<ScoredSub> subs;
  // short-read path (reads <= read_part_length): candidate locations
  std::vector<int64_t> short_loc;
  std::vector<uint8_t> short_rev;
  // results
  int32_t status = 0;          // 0 ok, 1 failed (glue re-runs via Python)
  bool mapped = false;
  int32_t read_mq = 0;         // short-read path only
  std::vector<Record> records;
};

// read-failure escape: unwinds the per-read thread back to its trampoline
struct ReadFailure {};

// A fiber is one read's (or one corun thunk's) suspended computation. A
// fiber must never be resumable while its context is only half-saved, so
// every park publishes its intent through the WORKER after swapcontext
// returns to the worker stack (the "schedule after switch" discipline).
struct Fiber {
  ucontext_t ctx;
  ucontext_t* ret = nullptr;      // current worker's scheduler context
  char* stack_base = nullptr;     // mmap base (guard page at the bottom)
  size_t stack_size = 0;
  std::function<void()> body;
  Fiber* parent = nullptr;        // corun parent (nullptr for read fibers)
  char* fail_out = nullptr;       // corun child: caller's failed[i] slot
  int pending = 0;                // outstanding device reqs / live children
  bool want_fail = false;         // next resume throws ReadFailure (abort)
  bool finished = false;
  // park intent, staged by the fiber, published by the worker
  int park = 0;                   // 0 none, 1 device wave, 2 corun children
  std::vector<AlignReq*> staged_a;
  std::vector<ScoreReq*> staged_s;
  std::vector<Fiber*> staged_children;
};

static thread_local Fiber* t_fiber = nullptr;  // fiber running on this thread

// makecontext entry: body exceptions are contained here (an exception must
// never unwind across a context switch); corun children report theirs
// through fail_out, read fibers catch their own in read_fiber_main.
static void fiber_entry() {
  Fiber* f = t_fiber;
  try {
    f->body();
  } catch (...) {
    if (f->fail_out) *f->fail_out = true;
  }
  f->finished = true;
  swapcontext(&f->ctx, f->ret);   // back to the worker; never resumed again
}

static size_t fiber_stack_bytes() {
  long kb = 2048;   // lazily committed (MAP_NORESERVE): virtual, not RSS
  if (const char* s = std::getenv("NGMLR_TPU_FIBER_STACK_KB")) kb = atol(s);
  if (kb < 128) kb = 128;
  return (size_t)kb * 1024;
}

static size_t guard_page_bytes() {
  long ps = sysconf(_SC_PAGESIZE);
  return ps > 0 ? (size_t)ps : 4096;
}

struct Engine {
  Config cfg;
  RefMeta rm;
  int id = 0;                          // names the workers: ngmlr-eng<id>-<i>

  std::mutex mu;
  std::condition_variable cv_coord;    // coordinator: wave ready / batch done
  std::condition_variable cv_workers;  // workers: runnable fibers
  std::deque<Fiber*> runq;
  std::vector<Fiber*> blocked_dev;     // fibers parked on device requests
  std::vector<AlignReq*> qa;
  std::vector<ScoreReq*> qs;
  int n_running = 0;                   // fibers currently on a worker
  int n_unfinished = 0;                // read fibers not yet finished
  bool aborted = false;   // dispatch-level failure: unwind every read fiber
  bool stop_workers = false;

  std::vector<ReadCtx> reads;
  std::vector<std::thread> workers;    // fixed pool, lives for the Engine
  std::vector<char*> stack_pool;       // recycled fiber stacks
  size_t fiber_stack = 0;

  // current wave (owned here between wait_wave and post_results)
  std::vector<AlignReq*> cur_a;
  std::vector<ScoreReq*> cur_s;
  std::vector<int32_t> pk_align;   // [n][12] rows, layout of align_dispatch
  std::vector<int32_t> pk_score;   // [n][7] rows, layout of score_wave_np

  ~Engine() {
    {
      std::unique_lock<std::mutex> lk(mu);
      stop_workers = true;
      cv_workers.notify_all();
    }
    for (auto& t : workers) t.join();
    for (char* s : stack_pool) munmap(s, fiber_stack);
  }

  void ensure_workers() {
    if (!workers.empty()) return;
    if (!fiber_stack) fiber_stack = fiber_stack_bytes();
    int k = 0;
    if (const char* s = std::getenv("NGMLR_TPU_ENGINE_THREADS")) k = atoi(s);
    if (k <= 0) k = (int)std::thread::hardware_concurrency();
    if (k <= 0) k = 1;
    if (k > 64) k = 64;
    for (int i = 0; i < k; ++i)
      workers.emplace_back([this, i] {
        char name[16];   // the OS keeps 15 characters
        snprintf(name, sizeof name, "ngmlr-eng%d-%d", id, i);
        pthread_setname_np(pthread_self(), name);
        worker_loop();
      });
  }

  // CPU seconds the workers have used so far (their own thread clocks)
  double workers_cpu_seconds() {
    double s = 0.0;
    for (auto& t : workers) {
      clockid_t cid;
      timespec ts;
      if (pthread_getcpuclockid(t.native_handle(), &cid) == 0 &&
          clock_gettime(cid, &ts) == 0)
        s += ts.tv_sec + 1e-9 * ts.tv_nsec;
    }
    return s;
  }

  Fiber* new_fiber(std::function<void()> body, Fiber* parent,
                   char* fail_out) {
    Fiber* f = new Fiber();
    f->body = std::move(body);
    f->parent = parent;
    f->fail_out = fail_out;
    char* base = nullptr;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (!stack_pool.empty()) {
        base = stack_pool.back();
        stack_pool.pop_back();
      }
    }
    size_t guard = guard_page_bytes();
    if (!base) {
      base = (char*)mmap(nullptr, fiber_stack, PROT_READ | PROT_WRITE,
                         MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
      if (base == MAP_FAILED) {
        delete f;
        throw std::bad_alloc();
      }
      // guard page under the stack (real page size, not a hardcoded 4K:
      // on 16K/64K-page kernels a 4K mprotect rounds up over ss_sp)
      if (mprotect(base, guard, PROT_NONE) != 0) {
        munmap(base, fiber_stack);
        delete f;
        throw std::bad_alloc();
      }
    }
    f->stack_base = base;
    f->stack_size = fiber_stack;
    getcontext(&f->ctx);
    f->ctx.uc_stack.ss_sp = base + guard;
    f->ctx.uc_stack.ss_size = fiber_stack - guard;
    f->ctx.uc_link = nullptr;
    makecontext(&f->ctx, (void (*)())fiber_entry, 0);
    return f;
  }

  void free_fiber_locked(Fiber* f) {
    stack_pool.push_back(f->stack_base);
    delete f;
  }

  void maybe_wake_coord_locked() {
    if (n_running == 0 && runq.empty()) cv_coord.notify_all();
  }

  // ---- worker side -------------------------------------------------------

  void worker_loop() {
    for (;;) {
      Fiber* f = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_workers.wait(lk, [&] { return stop_workers || !runq.empty(); });
        if (stop_workers) return;
        f = runq.front();
        runq.pop_front();
        n_running += 1;
      }
      resume_and_publish(f);
    }
  }

  void resume_and_publish(Fiber* f) {
    ucontext_t sched;
    f->ret = &sched;
    t_fiber = f;
    swapcontext(&sched, &f->ctx);
    t_fiber = nullptr;
    // the fiber is fully swapped out (or finished): publish its fate
    if (f->finished) {
      Fiber* parent = f->parent;
      std::unique_lock<std::mutex> lk(mu);
      free_fiber_locked(f);
      if (parent) {
        if (--parent->pending == 0) {
          runq.push_back(parent);
          cv_workers.notify_one();
        }
      } else {
        n_unfinished -= 1;
      }
      n_running -= 1;
      maybe_wake_coord_locked();
    } else if (f->park == 1) {          // device requests
      std::unique_lock<std::mutex> lk(mu);
      f->park = 0;
      if (aborted) {
        // batch is unwinding: fail the fiber instead of queueing requests
        f->staged_a.clear();
        f->staged_s.clear();
        f->pending = 0;
        f->want_fail = true;
        runq.push_back(f);
        cv_workers.notify_one();
      } else {
        for (auto* r : f->staged_a) { r->owner = f; qa.push_back(r); }
        for (auto* r : f->staged_s) { r->owner = f; qs.push_back(r); }
        f->staged_a.clear();
        f->staged_s.clear();
        blocked_dev.push_back(f);
      }
      n_running -= 1;
      maybe_wake_coord_locked();
    } else {                            // park == 2: corun children
      std::unique_lock<std::mutex> lk(mu);
      f->park = 0;
      for (Fiber* c : f->staged_children) runq.push_back(c);
      f->staged_children.clear();
      cv_workers.notify_all();
      n_running -= 1;
      maybe_wake_coord_locked();
    }
  }

  // ---- fiber side --------------------------------------------------------

  // swap the current fiber out; the worker publishes its park intent
  static void park() {
    Fiber* f = t_fiber;
    swapcontext(&f->ctx, f->ret);
    if (f->want_fail) {
      f->want_fail = false;
      throw ReadFailure{};
    }
  }

  void post_wait(std::vector<AlignReq*> al, std::vector<ScoreReq*> sc) {
    if (al.empty() && sc.empty()) return;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (aborted) throw ReadFailure{};
    }
    Fiber* f = t_fiber;
    f->park = 1;
    f->staged_a = std::move(al);
    f->staged_s = std::move(sc);
    f->pending = (int)(f->staged_a.size() + f->staged_s.size());
    park();   // resumed by engine_post_results (or abort -> ReadFailure)
  }

  // corun (pipeline/batcher.py:76-118): run thunks as child fibers of this
  // gate; the caller parks until all finish.
  void corun(std::vector<std::function<void()>> fns,
             std::vector<bool>* failed) {
    size_t n = fns.size();
    failed->assign(n, false);
    if (n == 0) return;   // nothing to wait for (a park here would hang)
    if (n == 1) {
      try { fns[0](); } catch (...) { (*failed)[0] = true; }
      return;
    }
    Fiber* f = t_fiber;
    // vector<bool> elements are not addressable: stage child failures in a
    // char buffer on this fiber's stack (alive across the park)
    std::vector<char> fails(n, 0);
    f->park = 2;
    f->pending = (int)n;
    f->staged_children.clear();
    try {
      for (size_t i = 0; i < n; ++i)
        f->staged_children.push_back(
            new_fiber(std::move(fns[i]), f, &fails[i]));
    } catch (...) {
      // new_fiber OOM mid-staging: free the never-run children and reset
      // the park state so the read unwinds cleanly instead of leaking
      std::unique_lock<std::mutex> lk(mu);
      for (Fiber* c : f->staged_children) free_fiber_locked(c);
      f->staged_children.clear();
      f->park = 0;
      f->pending = 0;
      throw;
    }
    park();   // resumed when the last child finishes
    for (size_t i = 0; i < n; ++i) (*failed)[i] = fails[i] != 0;
  }
};

// --------------------------------------------------------------------------
// interval aligner (align/aligner.py)
// --------------------------------------------------------------------------

struct Corridor {
  int32_t mode;
  float k, d;
  int32_t ci;
  int32_t width;
};

struct RefWin {
  RefDesc desc;
  std::string data;      // decoded window bytes (decode_exact output)
  int64_t W() const { return (int64_t)data.size(); }
};

// getCorridorFull (aligner.py:50-55)
static Corridor corridor_full(int64_t ref_seq_len) {
  int64_t w = ref_seq_len;
  int32_t off = (int32_t)((float)w * -0.2f);
  int64_t length = w + (int64_t)((float)w * 0.2f);
  return {CORRIDOR_FULL, 1.0f, 0.0f, off, (int32_t)length};
}

// getCorridorLinear (aligner.py:58-60)
static Corridor corridor_linear(int64_t corridor) {
  return {CORRIDOR_LINEAR, 1.0f, 0.0f, (int32_t)(corridor / 2),
          (int32_t)corridor};
}

// getCorridorEndpoints (aligner.py:63-69)
static Corridor corridor_endpoints(int64_t corridor, int64_t ref_len,
                                   int64_t qry_len, bool realign) {
  int64_t width = corridor / (realign ? 1 : 4);
  float k = (float)qry_len / (float)ref_len;
  float d = (float)width / 2.0f;
  return {CORRIDOR_ENDPOINTS, k, d, 0, (int32_t)width};
}

// getCorridorEndpointsWithAnchors (aligner.py:72-105)
static Corridor corridor_with_anchors(const Interval& interval,
                                      int32_t corridor_multiplier,
                                      int64_t ref_len, int64_t qry_len,
                                      int64_t external_qstart,
                                      int32_t read_part_length,
                                      int64_t full_read_length) {
  float k_align = (float)qry_len / (float)ref_len;
  float corridor_left = 0.0f;
  float corridor_right = 0.0f;
  for (const Anchor& a : interval.anchors) {
    int64_t anchor_x, anchor_y;
    if (a.is_reverse) {
      anchor_x = a.on_ref - interval.on_ref_start;
      anchor_y = full_read_length - a.on_read - read_part_length
                 - external_qstart;
    } else {
      anchor_x = a.on_ref - interval.on_ref_start;
      anchor_y = a.on_read - external_qstart;
    }
    float x_found = (float)anchor_x;
    float x_expect = (float)anchor_y / k_align;
    float diff = x_expect - x_found;
    if (diff > 0) {
      corridor_right = std::max(corridor_right, diff);
    } else {
      corridor_left = std::max(corridor_left, diff * -1.0f);
    }
  }
  corridor_left = corridor_left + 128.0f;
  corridor_right = corridor_right + 128.0f;
  // sequential update — right uses the already-updated left (aligner.py:97-99)
  corridor_left = corridor_left + (corridor_left + corridor_right) * 0.1f;
  corridor_right = corridor_right + (corridor_left + corridor_right) * 0.1f;
  corridor_left = corridor_left * (float)corridor_multiplier;
  corridor_right = corridor_right * (float)corridor_multiplier;
  int32_t width = (int32_t)(corridor_left + corridor_right);
  return {CORRIDOR_ANCHORS, k_align, corridor_right, 0, width};
}

// materialize query bytes with Python slice semantics — including the
// negative-index wraparound of seq[start:stop] (SeqView.to_bytes,
// io/reads.py:71-73; CPython slice normalization)
static void qry_bytes(const ReadCtx& rd, const SeqView& v, std::string* out) {
  int64_t a = v.start;
  int64_t b = v.start + v.length;
  if (a < 0) a += rd.length;
  if (a < 0) a = 0;
  if (a > rd.length) a = rd.length;
  if (b < 0) b += rd.length;
  if (b < 0) b = 0;
  if (b > rd.length) b = rd.length;
  out->clear();
  if (b <= a) return;
  out->assign(rd.seq + a, (size_t)(b - a));
  if (v.rev) {
    std::reverse(out->begin(), out->end());
    for (char& c : *out) {
      switch (c) {
        case 'A': c = 'T'; break;
        case 'C': c = 'G'; break;
        case 'G': c = 'C'; break;
        case 'T': c = 'A'; break;
        default: break;   // N stays N; others unchanged (_COMPLEMENT)
      }
    }
  }
}

// align_banded (aligner.py:172-229): one SingleAlign — device fill +
// backtrack + native CIGAR conversion. Returns false on failure.
static bool align_banded(Engine& e, const ReadCtx& rd, const RefWin& rw,
                         const SeqView& qv, const Corridor& c,
                         int64_t external_qstart, int64_t external_qend,
                         AlignRes* out) {
  if (qv.length == 0 || rw.W() == 0) return false;
  // AlignmentMatrixFast::prepare refusal (aligner.py:183-188)
  if ((qv.length * (int64_t)c.width) / 1000000 >= e.cfg.max_matrix_size_mb)
    return false;
  AlignReq req;
  req.ref = rw.desc;
  req.qstart = (int32_t)(rd.buf_offset + qv.start);
  req.qlen = (int32_t)qv.length;
  req.qrev = qv.rev ? 1 : 0;
  req.mode = c.mode;
  req.k = c.k;
  req.d = c.d;
  req.ci = c.ci;
  req.width = c.width;
  e.post_wait({&req}, {});
  if (!req.ok) return false;

  std::string qb;
  qry_bytes(rd, qv, &qb);
  int64_t qlen = (int64_t)qb.size();    // truncated length, as in cigar.py:162
  int64_t cigar_cap = 4 * qlen + 4096;
  int64_t md_cap = 6 * qlen + 4096;
  int64_t nm_cap = 2 * (qlen + 1);
  std::string cigar_buf((size_t)cigar_cap, '\0');
  std::string md_buf((size_t)md_cap, '\0');
  std::vector<int32_t> nm_buf((size_t)(nm_cap * 3));
  CigarResult res;
  int rc = ops_convert(req.ops.data(), (int64_t)req.ops.size(), req.best_x,
                       req.best_y, rw.data.data(), (int64_t)rw.data.size(),
                       qb.data(), qlen, (int32_t)external_qstart,
                       (int32_t)external_qend, &cigar_buf[0], cigar_cap,
                       &md_buf[0], md_cap, nm_buf.data(), nm_cap, &res);
  if (rc == 1) return false;
  if (rc == 2) throw ReadFailure{};   // caps overflow: Python path handles it
  out->cigar.assign(cigar_buf.data(), (size_t)res.cigar_len);
  out->md.assign(md_buf.data(), (size_t)res.md_len);
  out->nm = res.nm;
  out->identity = res.identity;
  out->alignment_length = res.alignment_length;
  out->cigar_op_count = res.cigar_op_count;
  out->qstart = res.qstart;
  out->qend = res.qend;
  out->position_offset = res.ref_position;
  out->first_ref_pos = res.first_ref_pos;
  out->first_read_pos = res.first_read_pos;
  out->last_ref_pos = res.last_ref_pos;
  out->last_read_pos = res.last_read_pos;
  out->nm_per_position.assign(nm_buf.begin(),
                              nm_buf.begin() + res.nm_pos_count * 3);
  out->score = req.score;
  out->final_cigar_length = res.final_cigar_length;
  return true;
}

// computeAlignment retry loop (aligner.py:232-301)
static bool compute_alignment(Engine& e, const ReadCtx& rd,
                              const Interval* interval, int64_t corridor,
                              const SeqView& qv, int64_t external_qstart,
                              int64_t external_qend, int64_t full_read_length,
                              const RefWin& rw, bool realign,
                              bool full_alignment, AlignRes* out,
                              bool short_read = false) {
  int64_t ref_seq_len = rw.W() + 1;
  int32_t retry = full_alignment ? 1 : 5;
  int64_t max_corridor = ref_seq_len * 2;
  corridor = std::min(corridor, max_corridor);
  int64_t qry_len = qv.length;

  int32_t mult = 1;
  while (corridor * mult <= max_corridor && retry > 0) {
    retry -= 1;
    Corridor c;
    if (full_alignment) {
      c = corridor_full(ref_seq_len);
    } else if (short_read) {
      c = corridor_linear(corridor * mult);
    } else if (mult < 3 && !realign && interval != nullptr &&
               !interval->anchors.empty()) {
      c = corridor_with_anchors(*interval, mult, rw.W(), qry_len,
                                external_qstart, e.cfg.read_part_length,
                                full_read_length);
    } else {
      c = corridor_endpoints(corridor * mult, rw.W(), qry_len, realign);
    }
    AlignRes a;
    if (align_banded(e, rd, rw, qv, c, external_qstart, external_qend, &a)
        && a.final_cigar_length == full_read_length) {
      *out = std::move(a);
      return true;
    }
    mult += 1;
  }
  return false;
}

}  // namespace ngmlr_engine

namespace ngmlr_engine {

// --------------------------------------------------------------------------
// long-read assembly (pipeline/longread.py LongReadProcessor)
// --------------------------------------------------------------------------

struct Snapshot {           // the reference's intervalsTree entry
  int64_t snap_start, snap_stop;
  Interval* node;
};

struct Proc {
  Engine& e;
  ReadCtx& rd;

  int32_t rpl() const { return e.cfg.read_part_length; }

  // extendIntervalStop (longread.py:100-122, AlignmentBuffer.cpp:2386-2429)
  bool extend_interval_stop(Interval& iv, int64_t read_bp,
                            int64_t read_length) {
    Chrom chrom = get_chr_borders(e.rm, iv.on_ref_start, iv.on_ref_stop);
    if (chrom.start == 0 && chrom.end == 0) return false;
    double length_ratio =
        iv.length_on_ref()
            ? std::min(1.0, (double)iv.length_on_read() * 1.0 /
                                (double)iv.length_on_ref() * 1.0)
            : 1.0;
    int64_t extend_on_read = std::min(read_length - iv.on_read_stop, read_bp);
    int64_t extend_on_ref = c_round((double)extend_on_read / length_ratio);
    int64_t max_extend;
    if (iv.is_reverse) {
      max_extend = iv.on_ref_stop < chrom.start ? 0
                                                : iv.on_ref_stop - chrom.start;
    } else {
      max_extend = iv.on_ref_stop > chrom.end ? 0 : chrom.end - iv.on_ref_stop;
    }
    if (extend_on_ref > max_extend) {
      extend_on_ref = max_extend;
      extend_on_read = std::min(
          extend_on_read,
          std::max<int64_t>(0,
                            c_round((double)extend_on_ref * length_ratio) - 1));
    }
    iv.on_read_stop += extend_on_read;
    if (iv.is_reverse) iv.on_ref_stop -= extend_on_ref;
    else iv.on_ref_stop += extend_on_ref;
    return true;
  }

  // extendIntervalStart (longread.py:124-146)
  bool extend_interval_start(Interval& iv, int64_t read_bp) {
    Chrom chrom = get_chr_borders(e.rm, iv.on_ref_start, iv.on_ref_stop);
    if (chrom.start == 0 && chrom.end == 0) return false;
    double length_ratio =
        iv.length_on_ref()
            ? std::min(1.0, (double)iv.length_on_read() * 1.0 /
                                (double)iv.length_on_ref() * 1.0)
            : 1.0;
    int64_t extend_on_read = std::min(iv.on_read_start, read_bp);
    int64_t extend_on_ref = c_round((double)extend_on_read / length_ratio);
    int64_t max_extend;
    if (iv.is_reverse) {
      max_extend = iv.on_ref_start > chrom.end ? 0
                                               : chrom.end - iv.on_ref_start;
    } else {
      max_extend = iv.on_ref_start < chrom.start
                       ? 0
                       : iv.on_ref_start - chrom.start;
    }
    if (extend_on_ref > max_extend) {
      extend_on_ref = max_extend;
      extend_on_read = std::min(
          extend_on_read,
          std::max<int64_t>(0,
                            c_round((double)extend_on_ref * length_ratio) - 1));
    }
    iv.on_read_start -= extend_on_read;
    if (iv.is_reverse) iv.on_ref_start += extend_on_ref;
    else iv.on_ref_start -= extend_on_ref;
    return true;
  }

  // shortenIntervalStart (longread.py:148-161)
  static bool shorten_interval_start(Interval& iv, int64_t read_bp) {
    if (iv.on_read_start >= iv.on_read_stop) return false;
    double length_ratio =
        iv.length_on_ref()
            ? std::max(1.1, (double)iv.length_on_read() * 1.0 /
                                (double)iv.length_on_ref() * 1.0)
            : 1.1;
    int64_t ref_bp = c_round((double)read_bp / length_ratio);
    if (read_bp < iv.length_on_read() && ref_bp < iv.length_on_ref()) {
      iv.on_read_start += read_bp;
      iv.on_ref_start = iv.is_reverse ? iv.on_ref_start - ref_bp
                                      : iv.on_ref_start + ref_bp;
      return true;
    }
    return false;
  }

  // shortenIntervalEnd (longread.py:163-176)
  static bool shorten_interval_end(Interval& iv, int64_t read_bp) {
    if (iv.on_read_start >= iv.on_read_stop) return false;
    double length_ratio =
        iv.length_on_ref()
            ? std::max(1.1, (double)iv.length_on_read() * 1.0 /
                                (double)iv.length_on_ref() * 1.0)
            : 1.1;
    int64_t ref_bp = c_round((double)read_bp / length_ratio);
    if (read_bp < iv.length_on_read() && ref_bp < iv.length_on_ref()) {
      iv.on_read_stop -= read_bp;
      iv.on_ref_stop = iv.is_reverse ? iv.on_ref_stop + ref_bp
                                     : iv.on_ref_stop - ref_bp;
      return true;
    }
    return false;
  }

  // spansChromosomeBorder (longread.py:178-182)
  bool spans_chromosome_border(const Interval& a, const Interval& b) {
    Chrom ca = get_chr_start(e.rm, (a.on_ref_stop + a.on_ref_start) / 2);
    Chrom cb = get_chr_start(e.rm, (b.on_ref_stop + b.on_ref_start) / 2);
    return ca.start != cb.start;
  }

  // extractReadSeq (longread.py:186-191)
  SeqView extract_read_seq(int64_t on_read_start, int64_t read_seq_len,
                           bool is_reverse, bool rev_comp = false) const {
    SeqView v{on_read_start, read_seq_len, is_reverse != rev_comp, true};
    if (read_seq_len <= 0 || read_seq_len > 200000000) v.valid = false;
    return v;
  }

  // extractReferenceSequenceForAlignment (longread.py:193-204)
  bool extract_ref_window(int64_t on_ref_start, int64_t on_ref_stop,
                          RefWin* out) const {
    if (on_ref_start >= on_ref_stop) return false;
    int64_t ref_seq_length = on_ref_stop - on_ref_start + 1;
    if (ref_seq_length <= 0) return false;
    if (!decode_exact(e.rm, on_ref_start, ref_seq_length, &out->data))
      return false;
    if (!decode_exact_desc(e.rm, on_ref_start, ref_seq_length, &out->desc))
      return false;
    return true;
  }

  // scoreInterval as a device request (longread.py:219-236); returns false
  // when the reference would return 0.0 without scoring
  bool interval_score_problem(const Interval& iv, ScoreReq* out) const {
    if (iv.on_read_start >= iv.on_read_stop) return false;
    SeqView read_seq = extract_read_seq(iv.on_read_start,
                                        iv.length_on_read(), iv.is_reverse);
    if (!read_seq.valid) return false;
    int64_t on_ref_start = iv.is_reverse ? iv.on_ref_stop : iv.on_ref_start;
    int64_t on_ref_stop = iv.is_reverse ? iv.on_ref_start : iv.on_ref_stop;
    if (on_ref_start >= on_ref_stop) return false;
    int64_t ref_seq_length = on_ref_stop - on_ref_start + 1;
    if (ref_seq_length <= 0) return false;
    RefDesc rdesc;
    if (on_ref_start >= e.rm.concat_len || on_ref_start < 0) return false;
    if (!decode_exact_desc(e.rm, on_ref_start, ref_seq_length, &rdesc))
      return false;
    out->ref = rdesc;
    out->qstart = (int32_t)(rd.buf_offset + read_seq.start);
    out->qlen = (int32_t)read_seq.length;
    out->qrev = read_seq.rev ? 1 : 0;
    return true;
  }

  // gapOverlapsWithInterval (longread.py:246-286); `with_read` selects the
  // alignment-check branch (read != None in Python)
  bool gap_overlaps(const Interval& gap, std::vector<Snapshot>& all_intervals,
                    bool with_read) {
    const double min_overlap = 50.0;
    const int64_t max_length_alignment_check = 1000;
    const int64_t min_gap_length = (int64_t)(rpl() * 1.5);
    bool overlaps = false;
    if (gap.on_read_start >= gap.on_read_stop) return false;
    if (gap.length_on_read() <= min_gap_length) return false;
    for (Snapshot& s : all_intervals) {
      if (s.snap_stop < gap.on_read_start || s.snap_start > gap.on_read_stop)
        continue;
      Interval* node = s.node;
      if (node->is_processed) continue;
      if (node->length_on_read() <
          (int64_t)(4.5 * rpl()) + gap.length_on_read()) {
        int64_t overlap = get_overlap_on_read(*node, gap);
        double overlap_percent =
            (double)overlap * 100.0 / (double)gap.length_on_read();
        bool better_score = true;
        if (overlap_percent > min_overlap) {
          if (with_read && gap.length_on_read() < max_length_alignment_check) {
            Interval iv;
            iv.on_read_start = gap.on_read_start;
            iv.on_read_stop = gap.on_read_stop;
            iv.on_ref_start = node->on_ref_start;
            iv.on_ref_stop = node->on_ref_stop;
            iv.is_reverse = node->is_reverse;
            ScoreReq p1, p2;
            bool h1 = interval_score_problem(iv, &p1);
            bool h2 = interval_score_problem(gap, &p2);
            std::vector<ScoreReq*> wave;
            if (h1) wave.push_back(&p1);
            if (h2) wave.push_back(&p2);
            e.post_wait({}, wave);
            double s1 = (h1 ? (double)p1.result : 0.0) /
                        (double)iv.length_on_read();
            double s2 = (h2 ? (double)p2.result : 0.0) /
                        (double)gap.length_on_read();
            better_score = s1 > s2;
          }
        }
        overlaps = overlaps || (overlap_percent > min_overlap && better_score);
      }
    }
    return overlaps;
  }

  // gapOverlapsWithInterval(first, second) (longread.py:288-297)
  bool gap_overlaps_between(const Interval& first, const Interval& second,
                            std::vector<Snapshot>& all_intervals) {
    Interval gap;
    gap.on_read_start = first.on_read_stop + 1;
    gap.on_read_stop = std::max<int64_t>(0, second.on_read_start - 1);
    gap.on_ref_start = first.on_ref_stop;
    gap.on_ref_stop = second.on_ref_start;
    gap.is_reverse = first.is_reverse;
    return gap_overlaps(gap, all_intervals, true);
  }

  // gapToEndOverlapsWithInterval (longread.py:299-305)
  bool gap_to_end_overlaps(const Interval& second, int64_t read_length,
                           std::vector<Snapshot>& all_intervals) {
    Interval gap;
    gap.on_read_start = std::min(read_length, second.on_read_stop + 1);
    gap.on_read_stop = read_length;
    return gap_overlaps(gap, all_intervals, false);
  }

  // gapFromStartOverlapsWithInterval (longread.py:307-313)
  bool gap_from_start_overlaps(const Interval& second,
                               std::vector<Snapshot>& all_intervals) {
    Interval gap;
    gap.on_read_start = 0;
    gap.on_read_stop = std::max<int64_t>(0, second.on_read_start - 1);
    return gap_overlaps(gap, all_intervals, false);
  }

  // closeGapOnRead (longread.py:315-322)
  void close_gap_on_read(Interval& first, Interval& second,
                         int64_t read_length) {
    if (first.on_read_stop < second.on_read_stop) {
      int64_t distance = get_distance_on_read(first, second);
      int64_t max_distance = (int64_t)(0.25 * (double)read_length);
      if (0 < distance && distance < max_distance) {
        extend_interval_stop(first, distance, read_length);
        extend_interval_start(second, distance);
      }
    }
  }

  // extendToReadStart (longread.py:324-335)
  void extend_to_read_start(Interval& iv, int64_t read_length,
                            std::vector<Snapshot>& all_intervals) {
    int64_t max_extend = std::min(c_round((double)read_length * 0.25),
                                  iv.length_on_read());
    int64_t extend = iv.on_read_start;
    if (extend > 0) {
      if (extend > rpl()) {
        if (extend <= max_extend) {
          if (!gap_from_start_overlaps(iv, all_intervals))
            extend_interval_start(iv, extend);
        }
      } else {
        extend_interval_start(iv, extend);
      }
    }
  }

  // extendToReadStop (longread.py:337-352) — the short-extend branch calls
  // extendIntervalStart (upstream copy/paste quirk, preserved)
  void extend_to_read_stop(Interval& iv, int64_t read_length,
                           std::vector<Snapshot>& all_intervals) {
    int64_t max_extend = std::min(c_round((double)read_length * 0.25),
                                  iv.length_on_read());
    int64_t extend = read_length - iv.on_read_stop;
    if (extend > 0) {
      if (extend > rpl()) {
        if (extend <= max_extend) {
          if (!gap_to_end_overlaps(iv, read_length, all_intervals))
            extend_interval_stop(iv, extend, read_length);
        }
      } else {
        extend_interval_start(iv, extend);
      }
    }
  }

  // estimateCorridor (longread.py:358-365)
  int64_t estimate_corridor(const Interval& iv) const {
    int64_t on_read = iv.on_read_stop - iv.on_read_start;
    int64_t on_ref = iv.on_ref_stop - iv.on_ref_start;
    int64_t diff = on_read - on_ref;
    int64_t ad = diff < 0 ? -diff : diff;
    int64_t ar = on_read < 0 ? -on_read : on_read;
    int64_t corridor_from_diff = (int64_t)((float)ad * 2.1f);
    int64_t corridor_from_length = (int64_t)((float)ar * 0.20f);
    return std::min<int64_t>(8192,
                             std::max(corridor_from_diff,
                                      corridor_from_length));
  }

  // alignInterval (longread.py:367-391)
  bool align_interval(const Interval& iv, const SeqView& read_seq,
                      bool realign, bool full_alignment, AlignRes* out) {
    if (!read_seq.valid) return false;
    const int64_t min_read_seq_length = 10;
    int64_t d_read = iv.on_read_start - iv.on_read_stop;
    int64_t d_ref = iv.on_ref_start - iv.on_ref_stop;
    if ((d_read < 0 ? -d_read : d_read) == 0 ||
        (d_ref < 0 ? -d_ref : d_ref) == 0 ||
        read_seq.length < min_read_seq_length)
      return false;
    int64_t corridor = estimate_corridor(iv);
    int64_t qstart, qend;
    if (iv.is_reverse) {
      qend = iv.on_read_start;
      qstart = rd.length - iv.on_read_stop;
    } else {
      qstart = iv.on_read_start;
      qend = rd.length - iv.on_read_stop;
    }
    RefWin rw;
    if (!extract_ref_window(iv.on_ref_start, iv.on_ref_stop, &rw))
      return false;
    return compute_alignment(e, rd, &iv, corridor, read_seq, qstart, qend,
                             rd.length, rw, realign, full_alignment, out);
  }

  // checkForSV's two scoring probes (longread.py:393-428); returns false
  // when the reference answers SV_NONE without scoring
  bool sv_probes(const AlignRes& align, const Interval& iv,
                 const SeqView& read_part_seq, int64_t inv_mid_ref,
                 int64_t inv_mid_read, int64_t inversion_length,
                 ScoreReq* fwd, ScoreReq* rev) const {
    const int64_t read_check_length = 50;
    const int64_t ref_check_length = 250;
    if (inversion_length <= 10) return false;
    int64_t check_loc = iv.on_ref_start + align.position_offset + inv_mid_ref
                        - ref_check_length - inversion_length / 2;
    int64_t ref_seq_length = inversion_length + 2 * ref_check_length;
    RefDesc ref_desc;
    if (!decode_window_desc(e.rm, check_loc, ref_seq_length, &ref_desc))
      ref_desc = {0, 0, 0, 0};   // empty reference -> scores 0
    int64_t full_len = read_part_seq.length;
    if (!(read_check_length <= inv_mid_read &&
          (inv_mid_read + read_check_length) < full_len))
      return false;
    SeqView read_seq = read_part_seq.sub(inv_mid_read - read_check_length,
                                         inv_mid_read + read_check_length);
    if (read_seq.length == 0) return false;
    fwd->ref = ref_desc;
    fwd->qstart = (int32_t)(rd.buf_offset + read_seq.start);
    fwd->qlen = (int32_t)read_seq.length;
    fwd->qrev = read_seq.rev ? 1 : 0;
    SeqView rc = read_seq.revcomp();
    rev->ref = ref_desc;
    rev->qstart = (int32_t)(rd.buf_offset + rc.start);
    rev->qlen = (int32_t)rc.length;
    rev->qrev = rc.rev ? 1 : 0;
    return true;
  }

  // checkForSV's decision (longread.py:430-441)
  int32_t sv_verdict(float score_fwd, float score_rev) const {
    const double read_check_length = 50.0;
    const double min_score = 1.0 * read_check_length / 4.0;
    double ratio;
    if (score_fwd != 0.0f) ratio = (double)score_rev / (double)score_fwd;
    else ratio = INFINITY;
    if (score_fwd == 0.0f && score_rev == 0.0f) ratio = std::nan("");
    if (ratio > e.cfg.inv_score_ratio && (double)score_rev > min_score)
      return SV_INVERSION;
    if ((double)score_rev < min_score && (double)score_fwd < min_score &&
        e.cfg.low_quality_split)
      return SV_TRANSLOCATION;
    return SV_NONE;
  }

  // detectMisalignment (longread.py:443-553). Returns the SV type; on
  // inversion/translocation fills left/right.
  int32_t detect_misalignment(const AlignRes& align, const Interval& aligned_iv,
                              const SeqView& read_part_seq, Interval* left,
                              Interval* right) {
    int64_t max_check_count =
        std::max<int64_t>(1, (int64_t)(((double)rd.length / 1000.0) / 2.0));
    const std::vector<int32_t>& nmp = align.nm_per_position;   // [n*3]
    int64_t n_rows = align.alignment_length;
    int64_t n_use = std::min<int64_t>((int64_t)nmp.size() / 3, n_rows);

    // inv rows: windowed identity in (0, 0.75) i.e. nm in [9, 31]
    std::vector<int64_t> inv_rows;
    for (int64_t i = 0; i < n_use; ++i) {
      int32_t nm = nmp[i * 3 + 2];
      if (nm >= 9 && nm <= 31) inv_rows.push_back(i);
    }
    if (inv_rows.empty()) return SV_NONE;

    // group rows <= 21 apart; a peak closes only if 21 clean rows follow
    // before n_rows
    struct Peak { int64_t mid_ref, mid_read; bool has_probe; ScoreReq f, r; };
    std::vector<Peak> peaks;
    std::vector<ScoreReq*> wave;
    int64_t check_count = 0;
    size_t gi = 0;
    while (gi < inv_rows.size()) {
      size_t ge = gi;
      while (ge + 1 < inv_rows.size() &&
             inv_rows[ge + 1] - inv_rows[ge] <= 21)
        ge += 1;
      bool closed = inv_rows[ge] + 21 <= n_rows - 1;
      if (closed) {
        check_count += 1;
        int64_t first = inv_rows[gi], last = inv_rows[ge];
        int64_t start_inv = nmp[first * 3 + 1];
        int64_t start_inv_read = nmp[first * 3 + 0];
        int64_t stop_inv = nmp[last * 3 + 1];
        int64_t stop_inv_read = nmp[last * 3 + 0];
        Peak pk;
        pk.mid_ref = (start_inv + stop_inv) / 2;
        pk.mid_read = (start_inv_read + stop_inv_read) / 2;
        int64_t inv_len = stop_inv - start_inv;
        if (inv_len < 0) inv_len = -inv_len;
        pk.has_probe = sv_probes(align, aligned_iv, read_part_seq, pk.mid_ref,
                                 pk.mid_read, inv_len, &pk.f, &pk.r);
        peaks.push_back(pk);
      }
      gi = ge + 1;
    }
    if (peaks.empty()) return SV_NONE;
    for (Peak& pk : peaks) {
      if (pk.has_probe) { wave.push_back(&pk.f); wave.push_back(&pk.r); }
    }
    if (!wave.empty()) e.post_wait({}, wave);

    int32_t best_result = SV_NONE;
    int64_t best_mid_ref = 0, best_mid_read = 0;
    for (Peak& pk : peaks) {
      int32_t result =
          pk.has_probe ? sv_verdict(pk.f.result, pk.r.result) : SV_NONE;
      if (best_result == SV_NONE || result == SV_INVERSION) {
        best_result = result;
        best_mid_ref = pk.mid_ref;
        best_mid_read = pk.mid_read;
      }
    }
    if (check_count > max_check_count) return SV_NONE;
    if (best_result == SV_NONE) return SV_NONE;

    if (aligned_iv.is_reverse) {
      int64_t additional_qstart = align.qstart - align.first_read_pos;
      left->on_read_stop = rd.length - align.qstart;
      left->on_read_start = rd.length - (additional_qstart + best_mid_read);
      left->on_ref_start =
          aligned_iv.on_ref_start + align.position_offset + align.first_ref_pos;
      left->on_ref_stop =
          aligned_iv.on_ref_start + align.position_offset + best_mid_ref;
      left->is_reverse = aligned_iv.is_reverse;
      right->on_read_start =
          rd.length - (align.last_read_pos + additional_qstart);
      right->on_read_stop = rd.length - (best_mid_read + additional_qstart);
      right->on_ref_start =
          aligned_iv.on_ref_start + align.position_offset + best_mid_ref;
      right->on_ref_stop =
          aligned_iv.on_ref_start + align.position_offset + align.last_ref_pos;
      right->is_reverse = aligned_iv.is_reverse;
    } else {
      left->on_read_start = aligned_iv.on_read_start + align.first_read_pos;
      left->on_read_stop = aligned_iv.on_read_start + best_mid_read;
      left->on_ref_start =
          aligned_iv.on_ref_start + align.position_offset + align.first_ref_pos;
      left->on_ref_stop =
          aligned_iv.on_ref_start + align.position_offset + best_mid_ref;
      left->is_reverse = aligned_iv.is_reverse;
      right->on_read_start = aligned_iv.on_read_start + best_mid_read;
      right->on_read_stop = aligned_iv.on_read_start + align.last_read_pos;
      right->on_ref_start =
          aligned_iv.on_ref_start + align.position_offset + best_mid_ref;
      right->on_ref_stop =
          aligned_iv.on_ref_start + align.position_offset + align.last_ref_pos;
      right->is_reverse = aligned_iv.is_reverse;
    }
    return best_result;
  }

  // getIntervalFromAlign (longread.py:1013-1030)
  static Interval interval_from_align(const AlignRes& align, int64_t location,
                                      bool reverse, int32_t idx,
                                      int64_t read_length) {
    int64_t diff_on_ref = align.last_ref_pos - align.first_ref_pos;
    Interval seg;
    seg.id = idx;
    seg.on_ref_start = location;
    seg.on_ref_stop = location + diff_on_ref;
    seg.is_reverse = reverse;
    seg.is_processed = false;
    seg.score = align.score;
    if (reverse) {
      seg.on_read_start = align.qend;
      seg.on_read_stop = read_length - align.qstart - 1;
    } else {
      seg.on_read_start = align.qstart;
      seg.on_read_stop = read_length - align.qend - 1;
    }
    return seg;
  }

  // realign (longread.py:555-669). Appends records on success.
  int32_t realign_sv(const Interval& left_of_inv, const Interval& right_of_inv,
                     std::vector<Record>& records, int32_t mq) {
    // left/right re-alignments run as one wave (corun), like the Python path
    AlignRes align_left, align_right;
    bool has_left = false, has_right = false;
    {
      std::vector<bool> failed;
      std::vector<std::function<void()>> fns;
      fns.push_back([&] {
        const Interval& p = left_of_inv;
        SeqView sv = extract_read_seq(p.on_read_start,
                                      p.on_read_stop - p.on_read_start,
                                      p.is_reverse);
        has_left = align_interval(p, sv, true, false, &align_left);
      });
      fns.push_back([&] {
        const Interval& p = right_of_inv;
        SeqView sv = extract_read_seq(p.on_read_start,
                                      p.on_read_stop - p.on_read_start,
                                      p.is_reverse);
        has_right = align_interval(p, sv, true, false, &align_right);
      });
      e.corun(std::move(fns), &failed);
      if (failed[0]) throw ReadFailure{};
      if (!has_left || align_left.score <= 0.0f) return SV_NONE;
      if (failed[1]) throw ReadFailure{};
    }
    align_left.mq = mq;
    int64_t loc_left = left_of_inv.on_ref_start + align_left.position_offset;

    Interval inv;
    inv.on_read_start = rd.length - align_left.qend;
    inv.on_ref_start = loc_left + align_left.last_ref_pos;
    inv.is_reverse = !left_of_inv.is_reverse;

    if (!has_right || align_right.score <= 0.0f) return SV_NONE;
    align_right.mq = mq;
    int64_t loc_right = right_of_inv.on_ref_start + align_right.position_offset;
    inv.on_read_stop = align_right.qstart;
    inv.on_ref_stop = loc_right + align_right.first_ref_pos;

    if (!inv.is_reverse) {
      int64_t tmp = rd.length - inv.on_read_start;
      inv.on_read_start = rd.length - inv.on_read_stop;
      inv.on_read_stop = tmp;
    }

    int64_t inversion_length = inv.on_ref_stop - inv.on_ref_start;
    if (inversion_length < 0) inversion_length = -inversion_length;
    int32_t sv_result = SV_NONE;
    AlignRes align_inv;
    bool has_inv = false;
    int64_t loc_inv = 0;
    if (inversion_length > e.cfg.min_inversion_length) {
      int64_t read_seq_len = inv.on_read_stop - inv.on_read_start;
      AlignRes align_inv_rev;
      bool has_inv_rev = false;
      std::vector<bool> failed;
      std::vector<std::function<void()>> fns;
      fns.push_back([&] {
        SeqView sv = extract_read_seq(inv.on_read_start, read_seq_len,
                                      inv.is_reverse, false);
        has_inv = align_interval(inv, sv, true, true, &align_inv);
      });
      fns.push_back([&] {
        SeqView sv = extract_read_seq(inv.on_read_start, read_seq_len,
                                      inv.is_reverse, true);
        has_inv_rev = align_interval(inv, sv, true, true, &align_inv_rev);
      });
      e.corun(std::move(fns), &failed);
      if (failed[0]) throw ReadFailure{};
      if (failed[1]) throw ReadFailure{};
      if (has_inv && align_inv.score > 0.0f &&
          (int64_t)(rd.length - align_inv.qstart - align_inv.qend) >
              e.cfg.min_inversion_length &&
          (!has_inv_rev || align_inv_rev.score < align_inv.score)) {
        align_inv.mq = mq;
        loc_inv = inv.on_ref_start + align_inv.position_offset;
        sv_result = SV_INVERSION;
      } else {
        sv_result = SV_TRANSLOCATION;
      }
    } else {
      sv_result = SV_NONE;
    }

    if (sv_result == SV_NONE) return SV_NONE;

    {
      Record rec;
      rec.align = std::move(align_left);
      rec.location = loc_left;
      rec.reverse = left_of_inv.is_reverse;
      rec.score = rec.align.score;
      rec.align.mapped_interval = interval_from_align(
          rec.align, loc_left, left_of_inv.is_reverse,
          (int32_t)records.size(), rd.length);
      rec.align.has_mapped_interval = true;
      records.push_back(std::move(rec));
    }
    {
      Record rec;
      rec.align = std::move(align_right);
      rec.location = loc_right;
      rec.reverse = right_of_inv.is_reverse;
      rec.score = rec.align.score;
      rec.align.mapped_interval = interval_from_align(
          rec.align, loc_right, right_of_inv.is_reverse,
          (int32_t)records.size(), rd.length);
      rec.align.has_mapped_interval = true;
      records.push_back(std::move(rec));
    }
    if (sv_result == SV_INVERSION && has_inv) {
      Record rec;
      rec.align = std::move(align_inv);
      rec.location = loc_inv;
      rec.reverse = inv.is_reverse;
      rec.score = rec.align.score;
      rec.align.mapped_interval = interval_from_align(
          rec.align, loc_inv, inv.is_reverse, (int32_t)records.size(),
          rd.length);
      rec.align.has_mapped_interval = true;
      records.push_back(std::move(rec));
    }
    return sv_result;
  }

  // computeMappingQuality (longread.py:671-683)
  int32_t compute_mapping_quality(
      const AlignRes& align,
      const std::vector<std::array<int64_t, 3>>& tree) const {
    int64_t q_lo = align.qstart, q_hi = rd.length - align.qend;
    int64_t mq_sum = 0, mq_count = 0;
    for (const auto& t : tree) {
      if (t[0] <= q_hi && t[1] >= q_lo) {
        mq_sum += t[2];
        mq_count += 1;
      }
    }
    if (mq_count == 0) return 0;
    return (int32_t)((float)mq_sum * 1.0f / (float)mq_count);
  }

  // satisfiesConstraints (longread.py:1033-1040)
  bool satisfies_constraints(const AlignRes& align) const {
    const double min_residues = 50.0;   // hardcoded upstream
    return align.score > 0.0f && (double)align.identity >= e.cfg.min_identity
           && (double)(rd.length - align.qstart - align.qend) >= min_residues;
  }

  // alignSingleOrMultipleIntervals (longread.py:685-711)
  void align_single_or_multiple(
      Interval& iv, std::vector<Record>& records,
      const std::vector<std::array<int64_t, 3>>& tree) {
    int64_t read_seq_len = iv.on_read_stop - iv.on_read_start;
    SeqView read_part_seq = extract_read_seq(iv.on_read_start, read_seq_len,
                                             iv.is_reverse);
    if (!read_part_seq.valid) return;
    AlignRes align;
    if (!align_interval(iv, read_part_seq, false, false, &align) ||
        align.score <= 0.0f)
      return;
    int32_t sv_type = SV_NONE;
    if (e.cfg.small_inversion_detection || e.cfg.low_quality_split) {
      Interval left, right;
      sv_type = detect_misalignment(align, iv, read_part_seq, &left, &right);
      if (sv_type != SV_NONE) {
        int32_t mq = compute_mapping_quality(align, tree);
        sv_type = realign_sv(left, right, records, mq);
      }
    }
    if (sv_type == SV_NONE) {
      if (satisfies_constraints(align)) {
        align.mq = compute_mapping_quality(align, tree);
        int64_t loc = iv.on_ref_start + align.position_offset;
        Record rec;
        rec.align = std::move(align);
        rec.location = loc;
        rec.reverse = iv.is_reverse;
        rec.score = rec.align.score;
        rec.align.mapped_interval = interval_from_align(
            rec.align, loc, iv.is_reverse, (int32_t)records.size(),
            rd.length);
        rec.align.has_mapped_interval = true;
        records.push_back(std::move(rec));
      }
    }
  }
};

}  // namespace ngmlr_engine

namespace ngmlr_engine {

// --------------------------------------------------------------------------
// reconcileRead + best-combination DP (longread.py:914-1010, 1093-1118)
// --------------------------------------------------------------------------

// getBestSegmentCombination — the literal reference loop
// (longread.py:1093-1118, AlignmentBuffer.cpp:2005-2064)
static float best_segment_combination(int64_t max_length,
                                      std::vector<Interval>& segs,
                                      std::vector<int32_t>* out) {
  const int64_t max_overlap = 50;
  std::vector<float> best_score((size_t)max_length, 0.0f);
  std::vector<int64_t> last_best((size_t)max_length, 0);
  std::vector<int32_t> last_fragment((size_t)max_length, -1);
  for (int64_t i = 1; i < max_length; ++i) {
    best_score[i] = best_score[i - 1];
    last_fragment[i] = last_fragment[i - 1];
    last_best[i] = last_best[i - 1];
    for (size_t j = 0; j < segs.size(); ++j) {
      const Interval& seg = segs[j];
      int64_t d = seg.on_read_stop - seg.on_read_start;
      if (d < 0) d = -d;
      if (!seg.is_processed && seg.on_read_stop <= i && d > max_overlap) {
        int64_t start = std::min(max_length - 1,
                                 seg.on_read_start + max_overlap);
        float current = seg.score + best_score[start];
        if (current > best_score[i]) {
          best_score[i] = current;
          last_fragment[i] = (int32_t)j;
          last_best[i] = start;
        }
      }
    }
  }
  int64_t i = max_length - 1;
  float result = best_score[i];
  while (last_fragment[i] > -1) {
    out->push_back(last_fragment[i]);
    i = last_best[i];
  }
  return result;
}

// reconcileRead (longread.py:914-1010)
static bool reconcile_read(const Config& cfg, int64_t read_length,
                           std::vector<Record>& records) {
  std::vector<Interval> segs;
  segs.reserve(records.size());
  for (size_t i = 0; i < records.size(); ++i) {
    segs.push_back(Proc::interval_from_align(records[i].align,
                                             records[i].location,
                                             records[i].reverse, (int32_t)i,
                                             read_length));
  }

  std::vector<int32_t> best_segments;
  best_segment_combination(read_length, segs, &best_segments);

  float top_score = 0.0f;
  int32_t top_idx = 0;
  int64_t aligned_bp_sum = 0;
  for (int32_t idx : best_segments) {
    segs[idx].is_processed = true;
    aligned_bp_sum += segs[idx].on_read_stop - segs[idx].on_read_start;
    if (segs[idx].score > top_score) {
      top_idx = idx;
      top_score = segs[idx].score;
    }
  }
  if (!best_segments.empty())
    records[segs[top_idx].id].align.primary = true;
  double aligned = (double)aligned_bp_sum * 1.0 / (double)read_length;
  bool mapped = cfg.min_residues < 1.0
                    ? aligned > cfg.min_residues
                    : (double)aligned_bp_sum > cfg.min_residues;

  // filter short isolated intervals (longread.py:960-980)
  const int64_t min_on_read_length = 1000;
  for (Interval& a : segs) {
    if (!a.is_processed) continue;
    int64_t thresh = std::min(min_on_read_length,
                              (int64_t)((double)read_length * 0.5));
    bool keep = a.length_on_read() > thresh;
    for (Interval& b : segs) {
      if (keep) break;
      if (b.is_processed) {
        int64_t distance = get_distance_on_read(a, b);
        int64_t distance_ref;
        if (b.on_ref_start < a.on_ref_start)
          distance_ref = std::max<int64_t>(0, a.on_ref_start - b.on_ref_stop);
        else
          distance_ref = std::max<int64_t>(0, b.on_ref_start - a.on_ref_stop);
        int64_t max_distance = a.length_on_read();
        keep = (distance < max_distance || distance_ref < max_distance) &&
               b.length_on_read() > thresh;
      }
    }
    if (!keep) a.is_processed = false;
  }

  for (Interval& seg : segs) {
    if (!seg.is_processed) records[seg.id].align.skip = true;
  }

  int64_t segment_count = 0;
  for (size_t i = 0; i < records.size(); ++i) {
    if (!records[segs[i].id].align.skip) {
      if (aligned > 0.95) records[segs[i].id].align.sv_type |= 0x2;
      segment_count += 1;
    }
  }

  int64_t max_splits = std::max<int64_t>(
      1, (int64_t)((double)read_length / 1000.0 *
                       cfg.max_segment_number_per_kb +
                   0.5));
  return mapped && (segment_count - 1) <= max_splits;
}

// sortRead (longread.py:1121-1130): swap best score to front
static void sort_read(std::vector<Record>& records) {
  float highest = 0.0f;
  size_t hi_idx = 0;
  for (size_t i = 0; i < records.size(); ++i) {
    if (records[i].align.score > highest) {
      highest = records[i].align.score;
      hi_idx = i;
    }
  }
  if (hi_idx != 0) std::swap(records[0], records[hi_idx]);
}

// --------------------------------------------------------------------------
// processLongReadLIS main flow (longread.py:717-910)
// --------------------------------------------------------------------------

static void process_read(Proc& p) {
  Engine& e = p.e;
  ReadCtx& rd = p.rd;
  const Config& cfg = e.cfg;
  const int32_t rpl = cfg.read_part_length;
  const int64_t max_num_scores = 1000;

  std::vector<std::array<int64_t, 3>> tree;
  std::vector<Anchor> anchors;
  for (const ScoredSub& sub : rd.subs) {
    int64_t n = (int64_t)sub.scores.size();
    if (n >= max_num_scores || n == 0) continue;
    tree.push_back({sub.on_read, sub.on_read + rpl, (int64_t)sub.mq});
    bool unique = n == 1;
    for (int64_t k = 0; k < n; ++k) {
      anchors.push_back({sub.on_read, sub.locations[k], sub.scores[k],
                         sub.reverse[k] != 0, unique});
    }
  }

  int64_t max_splits = std::max<int64_t>(
      1, (int64_t)((double)rd.length / 1000.0 * cfg.max_segment_number_per_kb
                   + 0.5));
  int32_t max_segment_count =
      (int32_t)std::max<int64_t>(10, max_splits * 2);
  std::vector<Interval> raw;
  get_intervals_from_anchors(anchors, max_segment_count, cfg.max_clis_runs,
                             rpl, &raw);
  // stable pointers: intervals are shared and mutated across phases
  std::vector<Interval*> intervals;
  intervals.reserve(raw.size());
  std::vector<Interval*> owned;
  auto make_owned = [&owned](Interval&& iv) {
    Interval* p2 = new Interval(std::move(iv));
    owned.push_back(p2);
    return p2;
  };
  for (Interval& iv : raw) intervals.push_back(make_owned(std::move(iv)));
  std_sorted_i64(intervals,
                 [](const Interval* iv) { return iv->on_read_start; });

  struct OwnedGuard {
    std::vector<Interval*>& v;
    ~OwnedGuard() { for (Interval* p : v) delete p; }
  } guard{owned};

  // --- segment building (longread.py:764-785) -----------------------------
  std::vector<std::vector<Interval*>> segments;
  std::vector<Snapshot> all_intervals;
  for (Interval* iv : intervals) {
    bool processed = false;
    for (auto& seg : segments) {
      for (Interval* piv : seg) {
        if (is_contained(*iv, *piv)) {
          processed = true;
          break;
        }
        if (is_compatible(*iv, *piv)) {
          if (seg.size() < 1000) {
            seg.push_back(iv);
            all_intervals.push_back({iv->on_read_start, iv->on_read_stop, iv});
            processed = true;
            break;
          }
        }
      }
      if (processed) break;
    }
    if (!processed) {
      segments.push_back({iv});
      all_intervals.push_back({iv->on_read_start, iv->on_read_stop, iv});
    }
  }

  // --- segment merge / SV split (longread.py:787-855) ---------------------
  std::vector<Interval*> final_ivs;
  for (auto& seg : segments) {
    std_sorted_i64(seg, [](const Interval* iv) { return iv->on_read_start; });
    Interval* last = seg[0];
    p.extend_interval_start(*last, 2 * rpl);
    bool is_first = true;
    for (size_t j = 1; j < seg.size(); ++j) {
      Interval* cur = seg[j];
      if (is_same_direction(*cur, *last)) {
        int64_t dup_length = 0;
        bool dup = is_duplication(*cur, *last, &dup_length);
        if (!dup) {
          if (p.gap_overlaps_between(*last, *cur, all_intervals)) {
            // possible translocation
            if (is_first) {
              p.extend_to_read_start(*last, rd.length, all_intervals);
              is_first = false;
            }
            p.extend_interval_stop(*last, 2 * rpl, rd.length);
            p.extend_interval_start(*cur, 2 * rpl);
            final_ivs.push_back(last);
            last = cur;
          } else {
            double corridor_size = (double)std::min<int64_t>(
                4096, std::min(cur->length_on_read(), last->length_on_read()));
            if (can_span_deletion_insertion(*cur, *last, corridor_size) &&
                !p.spans_chromosome_border(*cur, *last)) {
              merge_intervals(*last, *cur);
              cur->is_processed = true;
            } else {
              if (is_first) {
                p.extend_to_read_start(*last, rd.length, all_intervals);
                is_first = false;
              }
              p.close_gap_on_read(*last, *cur, rd.length);
              p.extend_interval_stop(*last, 2 * rpl, rd.length);
              p.extend_interval_start(*cur, 2 * rpl);
              final_ivs.push_back(last);
              last = cur;
            }
          }
        } else {
          // duplication
          if (is_first) {
            p.extend_to_read_start(*last, rd.length, all_intervals);
            is_first = false;
          }
          p.close_gap_on_read(*last, *cur, rd.length);
          int64_t max_extend = std::min<int64_t>(
              std::max<int64_t>(
                  cur->on_read_start - last->on_read_stop + dup_length, 0),
              2 * rpl);
          p.extend_interval_stop(*last, max_extend, rd.length);
          p.extend_interval_start(*cur, max_extend);
          final_ivs.push_back(last);
          last = cur;
        }
      } else {
        // inversion
        if (is_first) {
          p.extend_to_read_start(*last, rd.length, all_intervals);
          is_first = false;
        }
        p.close_gap_on_read(*last, *cur, rd.length);
        p.extend_interval_stop(*last, 2 * rpl, rd.length);
        p.extend_interval_start(*cur, 2 * rpl);
        final_ivs.push_back(last);
        last = cur;
      }
    }
    if (is_first) {
      p.extend_to_read_start(*last, rd.length, all_intervals);
      is_first = false;
    }
    p.extend_interval_stop(*last, 2 * rpl, rd.length);
    p.extend_to_read_stop(*last, rd.length, all_intervals);
    final_ivs.push_back(last);
  }

  // --- close gaps between neighbouring final intervals (857-869) ----------
  std_sorted_i64(final_ivs,
                 [](const Interval* iv) { return iv->on_read_start; });
  if (!final_ivs.empty()) {
    Interval* last = final_ivs[0];
    for (size_t i = 1; i < final_ivs.size(); ++i) {
      Interval* cur = final_ivs[i];
      if (cur->anchors.size() > 1) {
        if (!is_compatible(*last, *cur) &&
            get_distance_on_read(*last, *cur) > 0 &&
            (cur->anchors.size() > 2 || last->anchors.size() > 2)) {
          p.close_gap_on_read(*last, *cur, rd.length);
        }
      }
      if (cur->anchors.size() > 1 || last->anchors.size() == 1) last = cur;
    }
  }

  // --- coverage check (871-885) --------------------------------------------
  std_sorted_f32_desc(final_ivs,
                      [](const Interval* iv) { return iv->score; });
  int64_t read_bp_covered = 0;
  for (Interval* iv : final_ivs) read_bp_covered += iv->length_on_read();
  double aligned = (double)read_bp_covered * 1.0 / (double)rd.length;
  bool mapped = cfg.min_residues < 1.0
                    ? aligned > cfg.min_residues
                    : (double)read_bp_covered > cfg.min_residues;
  if (!mapped) {
    rd.mapped = false;
    rd.records.clear();
    return;
  }

  // --- align final intervals (887-902) -------------------------------------
  std::vector<Record>& records = rd.records;
  records.clear();
  for (Interval* iv : final_ivs) {
    for (Record& rec : records) {
      if (!rec.align.has_mapped_interval) continue;
      const Interval& aligned_iv = rec.align.mapped_interval;
      int64_t overlap = get_overlap_on_read(*iv, aligned_iv);
      if (0 < overlap &&
          (double)overlap < (double)iv->length_on_read() * 0.95) {
        if (iv->on_read_start < aligned_iv.on_read_start)
          Proc::shorten_interval_end(*iv, overlap);
        else
          Proc::shorten_interval_start(*iv, overlap);
      }
    }
    if (iv->on_ref_start > iv->on_ref_stop)
      std::swap(iv->on_ref_start, iv->on_ref_stop);
    if (!cfg.skip_align) p.align_single_or_multiple(*iv, records, tree);
  }

  if (records.empty()) {
    rd.mapped = false;
    return;
  }

  rd.mapped = reconcile_read(cfg, rd.length, records);
  if (rd.mapped) sort_read(records);
}

// --------------------------------------------------------------------------
// short-read path (pipeline/shortread.py: ScoreBuffer::scoreShortRead,
// ScoreBuffer.cpp:216-286 + AlignmentBuffer::processShortRead,
// AlignmentBuffer.cpp:2550-2660)
// --------------------------------------------------------------------------

// ScoreBuffer::computeMQ (score_stage.py:31-39) — float32 arithmetic
static int32_t compute_mq_short(float best, bool has_second, float second) {
  if (!has_second) return 60;
  if (best <= 0.0f) return 0;
  float val = 60.0f * (best - second) / best;
  return (int32_t)std::ceil((double)val);
}

static void process_short_read(Proc& p) {
  Engine& e = p.e;
  ReadCtx& rd = p.rd;
  const Config& cfg = e.cfg;
  int64_t n = (int64_t)rd.short_loc.size();
  rd.mapped = false;
  rd.read_mq = 0;
  if (n == 0) return;

  // dedup by location (shortread.py:33-42, ScoreBuffer.cpp:225-239)
  std::vector<int32_t> order((size_t)n);
  for (int64_t i = 0; i < n; ++i) order[i] = (int32_t)i;
  const int64_t* lp = rd.short_loc.data();
  std::sort(order.begin(), order.end(),
            [lp](int32_t a, int32_t b) { return lp[a] < lp[b]; });
  std::vector<int64_t> locs;
  std::vector<uint8_t> revs;
  locs.reserve((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = rd.short_loc[order[i]];
    if (i > 0 && v == locs.back()) continue;
    locs.push_back(v);
    revs.push_back(rd.short_rev[order[i]]);
  }

  // score candidates: corridor len*0.3+256, window len+corridor, ONE wave
  int64_t corridor = (int64_t)((double)rd.length * 0.3 + 256);
  std::vector<ScoreReq> reqs(locs.size());
  std::vector<ScoreReq*> wave;
  wave.reserve(locs.size());
  for (size_t i = 0; i < locs.size(); ++i) {
    RefDesc desc;
    if (!decode_window_desc(e.rm, locs[i] - (corridor >> 1),
                            rd.length + corridor, &desc))
      desc = {0, 0, 0, 0};
    reqs[i].ref = desc;
    reqs[i].qstart = (int32_t)rd.buf_offset;
    reqs[i].qlen = (int32_t)rd.length;
    reqs[i].qrev = revs[i];
    wave.push_back(&reqs[i]);
  }
  e.post_wait({}, wave);

  // sort by score desc (introsort tie order, ScoreBuffer.cpp:275)
  std::vector<float> scores(locs.size());
  for (size_t i = 0; i < locs.size(); ++i) scores[i] = reqs[i].result;
  std::vector<int32_t> so(locs.size());
  for (size_t i = 0; i < so.size(); ++i) so[i] = (int32_t)i;
  const float* sp2 = scores.data();
  std::sort(so.begin(), so.end(),
            [sp2](int32_t a, int32_t b) { return sp2[a] > sp2[b]; });
  std::vector<int64_t> locs2;
  std::vector<uint8_t> revs2;
  std::vector<float> sc2;
  for (int32_t i : so) {
    locs2.push_back(locs[i]);
    revs2.push_back(revs[i]);
    sc2.push_back(scores[i]);
  }
  rd.read_mq = compute_mq_short(sc2[0], sc2.size() > 1,
                                sc2.size() > 1 ? sc2[1] : 0.0f);

  // align top candidates (processShortRead, AlignmentBuffer.cpp:2550-2660)
  std::vector<Record>& records = rd.records;
  records.clear();
  int64_t last_score = 0;
  for (size_t k = 0; k < locs2.size(); ++k) {
    if (!((int64_t)sc2[k] >= last_score || records.size() < 2)) break;
    last_score = (int64_t)sc2[k];
    int64_t ref_extend = (int64_t)((float)rd.length * 0.15f);
    Interval iv;
    iv.on_read_start = 0;
    iv.on_read_stop = rd.length;
    iv.on_ref_start = locs2[k] - ref_extend;
    iv.on_ref_stop = locs2[k] + rd.length + ref_extend;
    iv.is_reverse = revs2[k] != 0;
    int64_t short_read_corridor = cfg.read_part_length + 2 * ref_extend;

    SeqView read_part_seq{0, rd.length, iv.is_reverse, true};
    AlignRes align;
    bool has = false;
    if (iv.on_ref_start < iv.on_ref_stop) {
      int64_t ref_seq_length = iv.on_ref_stop - iv.on_ref_start + 1;
      RefWin rw;
      if (decode_exact(e.rm, iv.on_ref_start, ref_seq_length, &rw.data)
          && decode_exact_desc(e.rm, iv.on_ref_start, ref_seq_length,
                               &rw.desc)) {
        has = compute_alignment(e, rd, &iv, short_read_corridor,
                                read_part_seq, 0, 0, rd.length, rw,
                                /*realign=*/false, /*full_alignment=*/false,
                                &align, /*short_read=*/true);
      }
    }
    bool mapped = has && align.score > 0.0f;
    if (mapped) {
      int64_t residues = rd.length - align.qstart - align.qend;
      if (cfg.min_residues < 1.0)
        mapped = ((double)residues * 1.0 / (double)rd.length)
                 > cfg.min_residues;
      else
        mapped = (double)residues > cfg.min_residues;
    }
    if (mapped) {
      align.mq = rd.read_mq;
      int64_t loc = iv.on_ref_start + align.position_offset;
      Record rec;
      rec.align = std::move(align);
      rec.location = loc;
      rec.reverse = iv.is_reverse;
      rec.score = rec.align.score;
      records.push_back(std::move(rec));
    }
  }
  if (!records.empty()) {
    records[0].align.primary = true;
    rd.mapped = true;
  }
}

// read fiber body (finish bookkeeping lives in resume_and_publish)
static void read_fiber_main(Engine* e, int32_t ri) {
  ReadCtx& rd = e->reads[ri];
  try {
    Proc p{*e, rd};
    if (!rd.short_loc.empty() && rd.subs.empty())
      process_short_read(p);
    else
      process_read(p);
    rd.status = 0;
  } catch (...) {
    rd.status = 1;   // glue re-runs this read through the Python path
    rd.records.clear();
    rd.mapped = false;
  }
}

}  // namespace ngmlr_engine

// --------------------------------------------------------------------------
// C API (ctypes)
// --------------------------------------------------------------------------

using namespace ngmlr_engine;

extern "C" {

struct RecordABI {
  int64_t location;
  float score;
  float identity;
  int32_t reverse;
  int32_t mq;
  int32_t nm;
  int32_t qstart, qend;
  int32_t cigar_op_count;
  int32_t sv_type;
  int32_t skip;
  int32_t primary;
  int32_t alignment_length;
  int32_t position_offset;
  int32_t first_ref_pos, first_read_pos, last_ref_pos, last_read_pos;
};

void* engine_create(const double* cfg_d, const int64_t* cfg_i,
                    const uint8_t* codes, int64_t codes_len,
                    const int64_t* sp, int32_t n_sp) {
  static std::atomic<int> n_created{0};
  Engine* e = new Engine();
  e->id = n_created++;
  e->cfg.min_identity = cfg_d[0];
  e->cfg.min_residues = cfg_d[1];
  e->cfg.inv_score_ratio = cfg_d[2];
  e->cfg.max_segment_number_per_kb = cfg_d[3];
  e->cfg.min_inversion_length = (int32_t)cfg_i[0];
  e->cfg.read_part_length = (int32_t)cfg_i[1];
  e->cfg.max_matrix_size_mb = (int32_t)cfg_i[2];
  e->cfg.small_inversion_detection = (int32_t)cfg_i[3];
  e->cfg.low_quality_split = (int32_t)cfg_i[4];
  e->cfg.max_clis_runs = (int32_t)cfg_i[5];
  e->cfg.skip_align = (int32_t)cfg_i[6];
  e->rm.codes = codes;
  e->rm.codes_len = codes_len;
  e->rm.concat_len = codes_len - 1;
  e->rm.sp = sp;
  e->rm.n_sp = n_sp;
  return e;
}

// dispatch-level failure: resume every parked read fiber with a failure so
// the batch can unwind (each read lands in status=1 -> Python fallback)
void engine_abort_batch(void* h) {
  Engine* e = (Engine*)h;
  std::unique_lock<std::mutex> lk(e->mu);
  e->aborted = true;
  for (Fiber* f : e->blocked_dev) {
    f->pending = 0;
    f->want_fail = true;
    e->runq.push_back(f);
  }
  e->blocked_dev.clear();
  e->qa.clear();
  e->qs.clear();
  e->cur_a.clear();   // post_results after an abort becomes a no-op
  e->cur_s.clear();
  e->cv_workers.notify_all();
  e->cv_coord.notify_all();
}

void engine_finish_batch(void* h) {
  Engine* e = (Engine*)h;
  std::unique_lock<std::mutex> lk(e->mu);
  e->cv_coord.wait(lk, [&] {
    return e->n_unfinished == 0 && e->n_running == 0 && e->runq.empty();
  });
}

// CPU seconds the engine's worker threads have used so far
double engine_cpu_seconds(void* h) {
  return ((Engine*)h)->workers_cpu_seconds();
}

void engine_destroy(void* h) {
  Engine* e = (Engine*)h;
  if (e->n_unfinished > 0) {   // never destroy a live batch
    engine_abort_batch(h);
    engine_finish_batch(h);
  }
  delete e;
}

void engine_start_batch(void* h, int32_t n_reads, const int64_t* read_len,
                        const int64_t* buf_off, const char* const* seqs,
                        const int32_t* n_subs, const int64_t* sub_on_read,
                        const int32_t* sub_mq, const int64_t* sub_counts,
                        const int64_t* cand_loc, const uint8_t* cand_rev,
                        const float* cand_score,
                        const int64_t* short_counts,   // per read (0 = long)
                        const int64_t* short_loc, const uint8_t* short_rev) {
  Engine* e = (Engine*)h;
  if (e->n_unfinished > 0) {   // leftover aborted batch: unwind before reuse
    engine_abort_batch(h);
    engine_finish_batch(h);
  }
  {
    std::unique_lock<std::mutex> lk(e->mu);
    e->aborted = false;
    e->qa.clear();
    e->qs.clear();
    e->cur_a.clear();
    e->cur_s.clear();
  }
  e->reads.clear();
  e->reads.resize((size_t)n_reads);
  int64_t si = 0, ci = 0, shi = 0;
  for (int32_t i = 0; i < n_reads; ++i) {
    ReadCtx& rd = e->reads[i];
    rd.length = read_len[i];
    rd.buf_offset = buf_off[i];
    rd.seq = seqs[i];
    rd.subs.resize((size_t)n_subs[i]);
    for (int32_t j = 0; j < n_subs[i]; ++j, ++si) {
      ScoredSub& s = rd.subs[j];
      s.on_read = sub_on_read[si];
      s.mq = sub_mq[si];
      int64_t n = sub_counts[si];
      s.locations.assign(cand_loc + ci, cand_loc + ci + n);
      s.reverse.assign(cand_rev + ci, cand_rev + ci + n);
      s.scores.assign(cand_score + ci, cand_score + ci + n);
      ci += n;
    }
    int64_t ns = short_counts ? short_counts[i] : 0;
    if (ns > 0) {
      rd.short_loc.assign(short_loc + shi, short_loc + shi + ns);
      rd.short_rev.assign(short_rev + shi, short_rev + shi + ns);
      shi += ns;
    } else {
      rd.short_loc.clear();
      rd.short_rev.clear();
    }
  }
  e->ensure_workers();
  {
    std::unique_lock<std::mutex> lk(e->mu);
    e->n_unfinished = n_reads;
  }
  // create one fiber per read; the fixed worker pool drains the run queue
  for (int32_t i = 0; i < n_reads; ++i) {
    Fiber* f = e->new_fiber([e, i] { read_fiber_main(e, i); },
                            nullptr, nullptr);
    std::unique_lock<std::mutex> lk(e->mu);
    e->runq.push_back(f);
  }
  {
    std::unique_lock<std::mutex> lk(e->mu);
    e->cv_workers.notify_all();
  }
}

int32_t engine_wait_wave(void* h, const int32_t** align_pk, int64_t* n_align,
                         const int32_t** score_pk, int64_t* n_score) {
  Engine* e = (Engine*)h;
  std::unique_lock<std::mutex> lk(e->mu);
  // quiescent = nothing runnable, nothing running: every live fiber is
  // parked on a device request (or transitively on corun children that are)
  e->cv_coord.wait(lk, [&] {
    return e->n_running == 0 && e->runq.empty() &&
           (e->n_unfinished == 0 || !e->qa.empty() || !e->qs.empty());
  });
  if (e->qa.empty() && e->qs.empty()) {
    *n_align = 0;
    *n_score = 0;
    return 0;
  }
  e->cur_a = std::move(e->qa);
  e->cur_s = std::move(e->qs);
  e->qa.clear();
  e->qs.clear();
  lk.unlock();

  e->pk_align.resize(e->cur_a.size() * 12);
  for (size_t i = 0; i < e->cur_a.size(); ++i) {
    AlignReq* r = e->cur_a[i];
    int32_t* row = &e->pk_align[i * 12];
    memcpy(&row[0], &r->ref.ds, 4);
    memcpy(&row[1], &r->ref.hi, 4);
    row[2] = r->ref.diff;
    row[3] = r->ref.W;
    row[4] = r->qstart;
    row[5] = r->qlen;
    row[6] = r->qrev;
    row[7] = r->mode;
    row[8] = r->ci;
    row[9] = r->width;
    memcpy(&row[10], &r->k, 4);
    memcpy(&row[11], &r->d, 4);
  }
  e->pk_score.resize(e->cur_s.size() * 7);
  for (size_t i = 0; i < e->cur_s.size(); ++i) {
    ScoreReq* r = e->cur_s[i];
    int32_t* row = &e->pk_score[i * 7];
    memcpy(&row[0], &r->ref.ds, 4);
    memcpy(&row[1], &r->ref.hi, 4);
    row[2] = r->ref.diff;
    row[3] = r->ref.W;
    row[4] = r->qstart;
    row[5] = r->qlen;
    row[6] = r->qrev;
  }
  *align_pk = e->pk_align.data();
  *n_align = (int64_t)e->cur_a.size();
  *score_pk = e->pk_score.data();
  *n_score = (int64_t)e->cur_s.size();
  return 1;
}

void engine_post_results(void* h, const float* a_score, const int32_t* a_bx,
                         const int32_t* a_by, const uint8_t* a_ok,
                         const uint8_t* const* a_ops,
                         const int64_t* a_ops_len, const float* s_result) {
  Engine* e = (Engine*)h;
  for (size_t i = 0; i < e->cur_a.size(); ++i) {
    AlignReq* r = e->cur_a[i];
    r->score = a_score[i];
    r->best_x = a_bx[i];
    r->best_y = a_by[i];
    r->ok = a_ok[i];
    if (r->ok && a_ops[i] != nullptr)
      r->ops.assign(a_ops[i], a_ops[i] + a_ops_len[i]);
    else
      r->ops.clear();
  }
  for (size_t i = 0; i < e->cur_s.size(); ++i)
    e->cur_s[i]->result = s_result[i];
  {
    std::unique_lock<std::mutex> lk(e->mu);
    for (AlignReq* r : e->cur_a)
      if (r->owner) r->owner->pending -= 1;
    for (ScoreReq* r : e->cur_s)
      if (r->owner) r->owner->pending -= 1;
    e->cur_a.clear();
    e->cur_s.clear();
    // a wave carries every pending request, so every parked fiber is
    // satisfied; keep the pending check as a guard against partial posts
    std::vector<Fiber*> still;
    for (Fiber* f : e->blocked_dev) {
      if (f->pending == 0)
        e->runq.push_back(f);
      else
        still.push_back(f);
    }
    e->blocked_dev.swap(still);
    e->cv_workers.notify_all();
  }
}

int32_t engine_read_status(void* h, int32_t ri) {
  return ((Engine*)h)->reads[ri].status;
}

int32_t engine_read_mapped(void* h, int32_t ri) {
  return ((Engine*)h)->reads[ri].mapped ? 1 : 0;
}

int32_t engine_read_mq(void* h, int32_t ri) {   // short-read path MQ
  return ((Engine*)h)->reads[ri].read_mq;
}

int32_t engine_record_count(void* h, int32_t ri) {
  return (int32_t)((Engine*)h)->reads[ri].records.size();
}

void engine_get_record(void* h, int32_t ri, int32_t j, RecordABI* out,
                       const char** cigar, int64_t* cigar_len,
                       const char** md, int64_t* md_len) {
  const Record& rec = ((Engine*)h)->reads[ri].records[j];
  out->location = rec.location;
  out->score = rec.score;
  out->identity = rec.align.identity;
  out->reverse = rec.reverse ? 1 : 0;
  out->mq = rec.align.mq;
  out->nm = rec.align.nm;
  out->qstart = rec.align.qstart;
  out->qend = rec.align.qend;
  out->cigar_op_count = rec.align.cigar_op_count;
  out->sv_type = rec.align.sv_type;
  out->skip = rec.align.skip ? 1 : 0;
  out->primary = rec.align.primary ? 1 : 0;
  out->alignment_length = rec.align.alignment_length;
  out->position_offset = rec.align.position_offset;
  out->first_ref_pos = rec.align.first_ref_pos;
  out->first_read_pos = rec.align.first_read_pos;
  out->last_ref_pos = rec.align.last_ref_pos;
  out->last_read_pos = rec.align.last_read_pos;
  *cigar = rec.align.cigar.data();
  *cigar_len = (int64_t)rec.align.cigar.size();
  *md = rec.align.md.data();
  *md_len = (int64_t)rec.align.md.size();
}

// The wave planner of csrc/wave.cu (csrc/wave_plan.h), for the CPU tests,
// which hold it against DeviceContext's plan_align_rows and
// plan_score_rows. chunks [n, 6]: L, Wp, Hp, B, first row in rows, rows;
// counts: rows planned, rows refused, cells, useful cells. Returns the
// chunks.
int64_t wave_plan_align(const int32_t* pk, int64_t n, int32_t conservative,
                        int64_t lanes, int64_t dirs_cap, int64_t* chunks,
                        int32_t* rows, int32_t* failed, int64_t* counts) {
  ngt_plan::AlignPlan p;
  ngt_plan::plan_align(pk, n, conservative != 0, lanes, dirs_cap, p);
  for (size_t c = 0; c < p.chunks.size(); ++c) {
    const auto& k = p.chunks[c];
    const int64_t v[6] = {k.L, k.Wp, k.Hp, k.B, k.row0, k.n};
    memcpy(chunks + c * 6, v, sizeof v);
  }
  std::copy(p.rows.begin(), p.rows.end(), rows);
  std::copy(p.failed.begin(), p.failed.end(), failed);
  counts[0] = (int64_t)p.rows.size();
  counts[1] = (int64_t)p.failed.size();
  counts[2] = p.cells;
  counts[3] = p.cells_useful;
  return (int64_t)p.chunks.size();
}

// buckets [n, 5]: Rp, Qp, B, first row in rows, rows; counts: rows
// planned, cells, useful cells. Returns the buckets.
int64_t wave_plan_score(const int32_t* pk, int64_t n, int64_t* buckets,
                        int32_t* rows, int64_t* counts) {
  ngt_plan::ScorePlan p;
  ngt_plan::plan_score(pk, n, p);
  for (size_t b = 0; b < p.buckets.size(); ++b) {
    const auto& k = p.buckets[b];
    const int64_t v[5] = {k.Rp, k.Qp, k.B, k.row0, k.n};
    memcpy(buckets + b * 5, v, sizeof v);
  }
  std::copy(p.rows.begin(), p.rows.end(), rows);
  counts[0] = (int64_t)p.rows.size();
  counts[1] = p.cells;
  counts[2] = p.cells_useful;
  return (int64_t)p.buckets.size();
}

}  // extern "C"
