// The plan of one native-engine wave: which launches its align and score
// rows go into, in what order and at what padded shapes. Host-only C++,
// included by the CUDA library (csrc/wave.cu, which stages and launches the
// plan) and by the engine library (native/engine.cpp, which exports it for
// the CPU tests).
//
// It is DeviceContext's planning (ops/device_engine.py: plan_align_rows,
// plan_score_rows) row for row, on one device:
//   align rows [P, 12]: lanes L from the corridor's lane bound (multiples of
//     128 up to 1024, then {2^n, 1.5 * 2^n}), pow2 classes Wp of W and Hp of
//     qlen (at least 256), one bucket per (L, Wp, Hp) in ascending key
//     order, rows by descending T = W + qlen - 1 (stable), split so that no
//     launch's direction planes (rows padded to 8, x (Wp + Hp) x L bytes)
//     pass the cap, a row too big for a solo launch refused;
//   score rows [P, 7]: rows past the ssw guard (MAX_SEQ_LEN) left out, the
//     rest bucketed by (Rp, Qp), rows in ascending order, each bucket padded
//     to a power of two of at least 8 rows.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace ngt_plan {

constexpr int64_t MAX_SEQ_LEN = 100000;   // ssw guard (StrippedSW.h:87)
constexpr int32_t W_MASK = (1 << 28) - 1;  // bits 28+ of W: the genome unit
constexpr int CORRIDOR_FULL = 0, CORRIDOR_LINEAR = 1;
constexpr int ALIGN_COLS = 12, SCORE_COLS = 7;

// numpy's // on int64
inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Smallest power of two >= x, starting from lo (a power of two).
inline int64_t pow2_from(int64_t x, int64_t lo) {
  int64_t v = lo;
  while (v < x) v <<= 1;
  return v;
}

// Smallest {2^n, 1.5 * 2^n} class >= x, starting from lo.
inline int64_t size_class(int64_t x, int64_t lo) {
  int64_t v = lo;
  for (;;) {
    if (x <= v) return v;
    if (x <= v + v / 2) return v + v / 2;
    v *= 2;
  }
}

// f64 -> int64 as numpy's astype: truncation, and INT64_MIN where the value
// has no int64 (x86's cvttsd2si, which numpy's cast compiles to).
inline int64_t trunc_i64(double v) {
  return (v > -9.2e18 && v < 9.2e18) ? (int64_t)v : INT64_MIN;
}

// The lane bound of one align row (DeviceContext._lane_bound, vectorised
// in plan_align_rows); conservative: width + 3 unclamped, the retry's.
inline int64_t lane_bound(const int32_t* r, bool conservative) {
  const int64_t W = r[3] & W_MASK, qlen = r[5], width = r[9];
  if (conservative) return width + 3;
  float kf;
  std::memcpy(&kf, &r[10], 4);
  const double kk = kf;
  const int64_t b_ep =
      kk > 0 ? trunc_i64((double)width * kk / (kk + 1.0)) + 6 : width + 3;
  const int32_t mode = r[7];
  int64_t wb = mode == CORRIDOR_LINEAR ? floordiv(width, 2) + 4
               : mode == CORRIDOR_FULL ? width + 3
                                       : b_ep;
  wb = std::min(std::min(wb, width + 3), std::min(W + 2, qlen + 2));
  return std::max<int64_t>(wb, 8);
}

inline int64_t lanes_of(int64_t wb) {
  return wb <= 1024 ? floordiv(wb + 127, 128) * 128
                    : size_class(std::max<int64_t>(wb, 1), 1024);
}

// One launch chain: rows[row0, row0 + n) of the plan, padded to B rows.
struct AlignChunk {
  int64_t L, Wp, Hp, B, row0, n;
};

struct AlignPlan {
  std::vector<AlignChunk> chunks;
  std::vector<int32_t> rows;     // the chunks' rows, chunk after chunk
  std::vector<int32_t> failed;   // rows refused by the cap, as met
  int64_t cells = 0, cells_useful = 0;
  std::vector<int64_t> key, T, L, Wc, Hc;   // per row (scratch)
  std::vector<int32_t> order;
};

inline int64_t pad_align(int64_t n) {
  return std::max<int64_t>((n + 7) / 8 * 8, 8);
}

// pk: n align rows; lanes > 0 gives every row that many lanes (tests force
// the lane-bound retry with it); dirs_cap: bytes one launch's direction
// planes may hold.
inline void plan_align(const int32_t* pk, int64_t n, bool conservative,
                       int64_t lanes, int64_t dirs_cap, AlignPlan& p) {
  p.chunks.clear();
  p.rows.clear();
  p.failed.clear();
  p.cells = p.cells_useful = 0;
  p.key.resize(n);
  p.T.resize(n);
  p.L.resize(n);
  p.Wc.resize(n);
  p.Hc.resize(n);
  p.order.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* r = pk + i * ALIGN_COLS;
    const int64_t W = r[3] & W_MASK, qlen = r[5];
    p.T[i] = W + qlen - 1;
    p.L[i] = lanes > 0 ? lanes : lanes_of(lane_bound(r, conservative));
    p.Wc[i] = pow2_from(W, 256);
    p.Hc[i] = pow2_from(qlen, 256);
    p.key[i] = (p.L[i] << 40) | (p.Wc[i] << 20) | p.Hc[i];
  }
  std::iota(p.order.begin(), p.order.end(), 0);
  std::stable_sort(p.order.begin(), p.order.end(), [&](int32_t a, int32_t b) {
    return p.key[a] != p.key[b] ? p.key[a] < p.key[b] : p.T[a] > p.T[b];
  });
  int64_t chunk0 = 0, chunk_n = 0, chunk_tpp = 0, L = 0;
  auto emit = [&]() {
    if (!chunk_n) return;
    const int32_t first = p.rows[chunk0];
    const AlignChunk c{L, p.Wc[first], p.Hc[first], pad_align(chunk_n),
                       chunk0, chunk_n};
    p.cells += chunk_n * (c.Wp + c.Hp) * L;
    for (int64_t j = chunk0; j < chunk0 + chunk_n; ++j) {
      const int32_t* r = pk + (int64_t)p.rows[j] * ALIGN_COLS;
      const int64_t W = r[3] & W_MASK, width = r[9];
      p.cells_useful += (int64_t)r[5] * std::min(width, W);
    }
    p.chunks.push_back(c);
    chunk0 = (int64_t)p.rows.size();
    chunk_n = 0;
  };
  for (int64_t g = 0; g < n;) {
    int64_t e = g;
    while (e < n && p.key[p.order[e]] == p.key[p.order[g]]) ++e;
    L = p.L[p.order[g]];
    chunk0 = (int64_t)p.rows.size();
    chunk_n = 0;
    for (int64_t k = g; k < e; ++k) {
      const int32_t i = p.order[k];
      const int64_t tpp = p.Wc[i] + p.Hc[i];
      if (chunk_n && (chunk_n + 8) / 8 * 8 * chunk_tpp * L > dirs_cap) emit();
      if (!chunk_n) {
        if (8 * tpp * L > dirs_cap) {
          p.failed.push_back(i);
          continue;
        }
        chunk_tpp = tpp;
      }
      p.rows.push_back(i);
      ++chunk_n;
    }
    emit();
    g = e;
  }
}

// One score launch: rows[row0, row0 + n) of the plan, padded to B rows.
struct ScoreBucket {
  int64_t Rp, Qp, B, row0, n;
};

struct ScorePlan {
  std::vector<ScoreBucket> buckets;
  std::vector<int32_t> rows;     // the buckets' rows, bucket after bucket
  int64_t cells = 0, cells_useful = 0;
  std::vector<int64_t> key;      // per row, -1 past the guard (scratch)
  std::vector<int32_t> order;
};

inline void plan_score(const int32_t* pk, int64_t n, ScorePlan& p) {
  p.buckets.clear();
  p.rows.clear();
  p.cells = p.cells_useful = 0;
  p.key.resize(n);
  p.order.clear();
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* r = pk + i * SCORE_COLS;
    const int64_t W = r[3] & W_MASK;
    const int64_t qlen = std::max<int64_t>(r[5], 1);
    if (!(W + 1 < MAX_SEQ_LEN && qlen + 1 < MAX_SEQ_LEN)) {
      p.key[i] = -1;
      continue;
    }
    const int64_t Rp = W <= 512 ? std::max<int64_t>(64, (W + 63) / 64 * 64)
                                : pow2_from(W, 512);
    p.key[i] = Rp * (1 << 20) + pow2_from(qlen, 64);
    p.order.push_back((int32_t)i);
  }
  std::stable_sort(p.order.begin(), p.order.end(), [&](int32_t a, int32_t b) {
    return p.key[a] < p.key[b];
  });
  const int64_t m = (int64_t)p.order.size();
  for (int64_t g = 0; g < m;) {
    int64_t e = g;
    const int64_t k = p.key[p.order[g]];
    while (e < m && p.key[p.order[e]] == k) ++e;
    const ScoreBucket b{k >> 20, k & ((1 << 20) - 1),
                        pow2_from(e - g, 8), (int64_t)p.rows.size(), e - g};
    for (int64_t j = g; j < e; ++j) {
      const int32_t* r = pk + (int64_t)p.order[j] * SCORE_COLS;
      p.rows.push_back(p.order[j]);
      p.cells_useful += (int64_t)(r[3] & W_MASK) * std::max<int64_t>(r[5], 1);
    }
    p.cells += b.n * b.Rp * b.Qp;
    p.buckets.push_back(b);
    g = e;
  }
}

}  // namespace ngt_plan
