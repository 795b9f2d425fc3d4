// Native backtrack + CIGAR/MD conversion for the convex-gap wavefront kernel.
//
// C++ twin of ngmlr_tpu/align/cigar.py (which is the verified rebuild of
// ConvexAlignFast::revBacktrack + convertCigar,
// ngmlr src/ConvexAlignFast.cpp:335-433, 112-333). The Python
// implementation remains the test oracle; this file is the production host
// path.
//
// Two entry points:
//   * backtrack_and_convert — walks a host-resident packed direction plane
//     (legacy path, kept for the oracle kernels),
//   * ops_convert — consumes the 2-bit op stream emitted by the on-device
//     backtrack (ngmlr_tpu.ops.device_engine._convex_kernel): op for
//     wavefront t lives at bit (t%4)*2 of byte t/4; 0 = no op at this
//     wavefront, else DIAG/INS/DEL. Iterating t descending reproduces the
//     reference's backward walk exactly.
//
// Build: g++ -O3 -shared -fPIC -o libngmlr_cigar.so cigar_native.cpp
// Interface: plain C, used via ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>

namespace {

constexpr int STOP = 0, DIAG = 1, INS = 2, DEL = 3;
constexpr int MAX_INDEL_WINDOW = 1;  // maxIndelLength (ConvexAlignFast.cpp:169)

inline int popcount32(uint32_t v) { return __builtin_popcount(v); }

struct Op { int op; int len; };  // op: -1 clip, 'EQ'=4, 'X'=5, INS, DEL

}  // namespace

extern "C" {

struct CigarResult {
  int32_t valid;
  int32_t ref_position;
  int32_t final_cigar_length;
  int32_t nm;
  float identity;
  int32_t alignment_length;
  int32_t cigar_op_count;
  int32_t qstart;   // incl. external
  int32_t qend;     // incl. external
  int32_t first_ref_pos, first_read_pos, last_ref_pos, last_read_pos;
  int64_t cigar_len;
  int64_t md_len;
  int64_t nm_pos_count;
};

}  // extern "C"

namespace {

// convertCigar (ConvexAlignFast.cpp:112-333) over reverse-path-ordered ops.
// rev_ops[0] = trailing clip, rev_ops[n-1] = leading clip.
// returns 0 ok / 2 overflow
int convert_from_rev_ops(
    const Op* rev_ops, int64_t n_ops, int ref_position,
    const char* ref_window, int32_t external_qstart, int32_t external_qend,
    char* cigar_out, int64_t cigar_cap, char* md_out, int64_t md_cap,
    int32_t* nm_pos_out, int64_t nm_pos_cap_triples, CigarResult* res) {
  const char* refseq = ref_window + ref_position;
  uint32_t buffer = 0;
  int pos_in_ref = 0, pos_in_read = 0;
  int cigar_op_count = 0;
  int exact_alignment_length = 0;
  int64_t final_cigar_length = 0;
  int64_t co = 0, mo = 0;
  int64_t nmc = 0;

  auto emit_cigar = [&](long len, char opch) -> bool {
    int n = snprintf(cigar_out + co, (size_t)(cigar_cap - co), "%ld%c", len, opch);
    if (n < 0 || co + n >= cigar_cap) return false;
    co += n; cigar_op_count += 1; return true;
  };
  auto add_position = [&](int ref_p, int read_p, int yi) {
    if (read_p > 16 && ref_p > 16 && nmc < nm_pos_cap_triples) {
      nm_pos_out[nmc * 3 + 0] = read_p - 16;
      nm_pos_out[nmc * 3 + 1] = ref_p - 16;
      nm_pos_out[nmc * 3 + 2] = yi;
      nmc += 1;
    }
  };

  int clip0 = rev_ops[n_ops - 1].len;  // leading clip
  int qstart = clip0 + external_qstart;
  if (qstart > 0) {
    if (!emit_cigar(qstart, 'S')) return 2;
    final_cigar_length += qstart;
  }
  pos_in_read = clip0;
  res->first_ref_pos = 0;
  res->first_read_pos = pos_in_read;

  int matches = 0;
  long alignment_length = 0;
  long cigar_m_length = 0;
  long md_eq_length = 0;
  int64_t ref_index = 0;
  int yi = 0;

  auto flush_m = [&]() -> bool {
    if (cigar_m_length > 0) {
      if (!emit_cigar(cigar_m_length, 'M')) return false;
      final_cigar_length += cigar_m_length;
      cigar_m_length = 0;
    }
    return true;
  };
  auto md_num = [&](long v) -> bool {
    int n = snprintf(md_out + mo, (size_t)(md_cap - mo), "%ld", v);
    if (n < 0 || mo + n >= md_cap) return false;
    mo += n; return true;
  };

  bool overflow = false;
  for (int64_t i = n_ops - 2; i >= 1 && !overflow; --i) {
    int op = rev_ops[i].op;
    long length = rev_ops[i].len;
    alignment_length += length;
    switch (op) {
      case 5:  // X
        cigar_m_length += length;
        for (long k = 0; k < length; ++k) {
          if (!md_num(md_eq_length)) { overflow = true; break; }
          md_eq_length = 0;
          if (mo + 1 >= md_cap) { overflow = true; break; }
          md_out[mo++] = refseq[ref_index++];
          buffer = (buffer << 1) | 1u;
          yi = popcount32(buffer);
          add_position(pos_in_ref, pos_in_read, yi);
          pos_in_ref += 1; pos_in_read += 1;
        }
        exact_alignment_length += length;
        break;
      case 4:  // EQ
        cigar_m_length += length;
        md_eq_length += length;
        matches += length;
        for (long k = 0; k < length; ++k) {
          buffer <<= 1;
          yi = popcount32(buffer);
          add_position(pos_in_ref, pos_in_read, yi);
          pos_in_ref += 1; pos_in_read += 1;
        }
        ref_index += length;
        exact_alignment_length += length;
        break;
      case DEL:
        if (!flush_m()) { overflow = true; break; }
        if (!emit_cigar(length, 'D')) { overflow = true; break; }
        if (!md_num(md_eq_length)) { overflow = true; break; }
        md_eq_length = 0;
        if (mo + 1 >= md_cap) { overflow = true; break; }
        md_out[mo++] = '^';
        for (long k = 0; k < length; ++k) {
          if (mo + 1 >= md_cap) { overflow = true; break; }
          md_out[mo++] = refseq[ref_index++];
          buffer <<= 1;
          if (k < MAX_INDEL_WINDOW) { buffer |= 1u; yi = std::max(0, yi + 1); }
          add_position(pos_in_ref, pos_in_read, yi);
          pos_in_ref += 1;
        }
        exact_alignment_length += length;
        break;
      case INS:
        if (!flush_m()) { overflow = true; break; }
        if (!emit_cigar(length, 'I')) { overflow = true; break; }
        final_cigar_length += length;
        for (long k = 0; k < length; ++k) {
          buffer <<= 1;
          if (k < MAX_INDEL_WINDOW) { buffer |= 1u; yi = std::max(0, yi + 1); }
        }
        pos_in_read += length;
        exact_alignment_length += length;
        break;
      default:
        return 1;
    }
  }
  if (overflow) return 2;
  if (!md_num(md_eq_length)) return 2;
  if (!flush_m()) return 2;

  int qend = rev_ops[0].len + external_qend;  // trailing clip
  if (qend > 0) {
    if (!emit_cigar(qend, 'S')) return 2;
  }
  final_cigar_length += qend;

  res->valid = 1;
  res->ref_position = ref_position;
  res->final_cigar_length = (int32_t)final_cigar_length;
  res->nm = (int32_t)(alignment_length - matches);
  res->identity = alignment_length ? (float)matches * 1.0f / (float)alignment_length : 0.0f;
  res->alignment_length = exact_alignment_length;
  res->cigar_op_count = cigar_op_count;
  res->qstart = qstart;
  res->qend = qend;
  res->last_ref_pos = pos_in_ref;
  res->last_read_pos = pos_in_read;
  res->cigar_len = co;
  res->md_len = mo;
  res->nm_pos_count = nmc;
  return 0;
}

}  // namespace

extern "C" {

// returns 0 on success, 1 on backtrack failure, 2 on buffer overflow
int backtrack_and_convert(
    const uint8_t* dirs, int64_t T, int64_t L,
    int32_t best_x, int32_t best_y,
    const int64_t* offsets, int32_t H, int32_t width,
    const char* ref_window, int64_t /*ref_window_len*/,
    const char* qry, int64_t qry_len,
    int32_t external_qstart, int32_t external_qend,
    char* cigar_out, int64_t cigar_cap,
    char* md_out, int64_t md_cap,
    int32_t* nm_pos_out, int64_t nm_pos_cap_triples,
    CigarResult* res) {
  res->valid = 0;
  if (best_y <= 0) return 1;

  // ---- revBacktrack (ConvexAlignFast.cpp:335-433) ----
  int64_t cap_ops = qry_len + (int64_t)width + 16;
  Op* rev_ops = new Op[cap_ops + 2];
  int64_t n_ops = 0;

  int cur_op = -1;  // CIGAR_S
  int qend_clip = (int)(qry_len - best_y) - 1;
  int cur_len = qend_clip;
  int64_t cigar_string_length = qend_clip;

  int x = best_x, y = best_y;
  auto dir_at = [&](int xx, int yy) -> int {
    if (xx < 0 || yy < 0) return STOP;
    int64_t t = (int64_t)xx + yy;
    if (t >= T) return STOP;
    return (dirs[(t >> 2) * L + (yy % L)] >> ((t & 3) * 2)) & 3;
  };

  int d = dir_at(x, y);
  while (d != STOP) {
    int minC = (int)((float)offsets[y] + 0.1f * (float)width);
    int maxC = (int)((float)minC + (float)width - 0.1f * (float)width);
    if (!(x > minC && x < maxC)) { delete[] rev_ops; return 1; }

    int emit_op;
    if (d == DIAG) {
      emit_op = (qry[y] == ref_window[x]) ? 4 /*EQ*/ : 5 /*X*/;
      x -= 1; y -= 1; cigar_string_length += 1;
    } else if (d == INS) {
      emit_op = INS; y -= 1; cigar_string_length += 1;
    } else if (d == DEL) {
      emit_op = DEL; x -= 1;
    } else {
      delete[] rev_ops; return 1;
    }
    if (emit_op == cur_op) {
      cur_len += 1;
    } else {
      if (n_ops >= cap_ops) { delete[] rev_ops; return 2; }
      rev_ops[n_ops].op = cur_op; rev_ops[n_ops].len = cur_len; n_ops++;
      cur_op = emit_op; cur_len = 1;
    }
    d = dir_at(x, y);
  }
  if (n_ops + 2 > cap_ops) { delete[] rev_ops; return 2; }
  rev_ops[n_ops].op = cur_op; rev_ops[n_ops].len = cur_len; n_ops++;
  rev_ops[n_ops].op = -1; rev_ops[n_ops].len = y + 1; n_ops++;  // leading clip
  cigar_string_length += y + 1;

  int ref_position = x + 1;
  if (cigar_string_length != qry_len) { delete[] rev_ops; return 1; }

  int rc = convert_from_rev_ops(rev_ops, n_ops, ref_position, ref_window,
                                external_qstart, external_qend,
                                cigar_out, cigar_cap, md_out, md_cap,
                                nm_pos_out, nm_pos_cap_triples, res);
  delete[] rev_ops;
  return rc;
}

// Device-backtrack op stream -> Align fields. The device already performed
// the validPath checks; op==0 wavefronts are skipped. Returns 0/1/2 as above.
int ops_convert(
    const uint8_t* packed_ops, int64_t packed_len_bytes,
    int32_t best_x, int32_t best_y,
    const char* ref_window, int64_t /*ref_window_len*/,
    const char* qry, int64_t qry_len,
    int32_t external_qstart, int32_t external_qend,
    char* cigar_out, int64_t cigar_cap,
    char* md_out, int64_t md_cap,
    int32_t* nm_pos_out, int64_t nm_pos_cap_triples,
    CigarResult* res) {
  res->valid = 0;
  if (best_y <= 0) return 1;

  int64_t t_best = (int64_t)best_x + best_y;
  if (t_best >= packed_len_bytes * 4) return 1;

  int64_t cap_ops = qry_len + (t_best + 1) + 16;
  Op* rev_ops = new Op[cap_ops + 2];
  int64_t n_ops = 0;

  int cur_op = -1;
  int qend_clip = (int)(qry_len - best_y) - 1;
  int cur_len = qend_clip;
  int64_t cigar_string_length = qend_clip;

  int x = best_x, y = best_y;
  for (int64_t t = t_best; t >= 0; --t) {
    int d = (packed_ops[t >> 2] >> ((t & 3) * 2)) & 3;
    if (d == 0) continue;
    int emit_op;
    if (d == DIAG) {
      emit_op = (qry[y] == ref_window[x]) ? 4 /*EQ*/ : 5 /*X*/;
      x -= 1; y -= 1; cigar_string_length += 1;
    } else if (d == INS) {
      emit_op = INS; y -= 1; cigar_string_length += 1;
    } else {  // DEL
      emit_op = DEL; x -= 1;
    }
    if (emit_op == cur_op) {
      cur_len += 1;
    } else {
      if (n_ops >= cap_ops) { delete[] rev_ops; return 2; }
      rev_ops[n_ops].op = cur_op; rev_ops[n_ops].len = cur_len; n_ops++;
      cur_op = emit_op; cur_len = 1;
    }
  }
  if (n_ops + 2 > cap_ops) { delete[] rev_ops; return 2; }
  rev_ops[n_ops].op = cur_op; rev_ops[n_ops].len = cur_len; n_ops++;
  rev_ops[n_ops].op = -1; rev_ops[n_ops].len = y + 1; n_ops++;
  cigar_string_length += y + 1;

  int ref_position = x + 1;
  if (cigar_string_length != qry_len) { delete[] rev_ops; return 1; }

  int rc = convert_from_rev_ops(rev_ops, n_ops, ref_position, ref_window,
                                external_qstart, external_qend,
                                cigar_out, cigar_cap, md_out, md_cap,
                                nm_pos_out, nm_pos_cap_triples, res);
  delete[] rev_ops;
  return rc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// std::sort permutation oracles.
//
// The reference sorts anchors/intervals/candidate-scores with std::sort
// (AlignmentBuffer.cpp:881, 3035, 3135, 3279, 3312; ScoreBuffer.cpp:55,
// 173, 225, 275), which libstdc++ implements as introsort — UNSTABLE for
// ranges > 16 elements. Tie order is therefore an artifact of introsort's
// deterministic swap sequence, and byte-identical output requires replaying
// it. Sorting an index array with a comparator on the carried keys performs
// the identical comparison/swap sequence, so the resulting permutation
// matches the reference's element order exactly.

namespace {
inline void fill_iota(int32_t* idx, int64_t n) {
  for (int64_t i = 0; i < n; ++i) idx[i] = (int32_t)i;
}
}  // namespace

extern "C" void std_sort_perm_i64(const int64_t* keys, int32_t* idx,
                                  int64_t n, int32_t desc) {
  fill_iota(idx, n);
  if (desc) {
    std::sort(idx, idx + n,
              [keys](int32_t a, int32_t b) { return keys[a] > keys[b]; });
  } else {
    std::sort(idx, idx + n,
              [keys](int32_t a, int32_t b) { return keys[a] < keys[b]; });
  }
}

extern "C" void std_sort_perm_f32(const float* keys, int32_t* idx,
                                  int64_t n, int32_t desc) {
  fill_iota(idx, n);
  if (desc) {
    std::sort(idx, idx + n,
              [keys](int32_t a, int32_t b) { return keys[a] > keys[b]; });
  } else {
    std::sort(idx, idx + n,
              [keys](int32_t a, int32_t b) { return keys[a] < keys[b]; });
  }
}

// ---------------------------------------------------------------------------
// cLIS chain DP (AlignmentBuffer.cpp:490-564): O(n^2) constrained longest
// increasing subsequence over anchors. Semantics mirror the Python twin in
// ngmlr_tpu.chain.clis exactly (double arithmetic, descending-j scan with
// strict improvement => trace picks the highest-index predecessor among
// those with maximal dp). Returns the chain length; out_idx holds the
// chain's pool indices in ascending order.
extern "C" int32_t clis_chain(const int64_t* on_read, const int64_t* on_ref,
                              const uint8_t* is_rev, int32_t n,
                              int32_t read_part_length, int32_t* out_idx,
                              int32_t* dp, int32_t* trace) {
  if (n <= 0) return 0;
  const double max_ref_diff = (double)read_part_length * 2.0;
  int32_t max_length = 1;
  int32_t best_end = 0;
  for (int32_t i = 0; i < n; ++i) {
    dp[i] = 1;
    trace[i] = -1;
    const int64_t ai_read = on_read[i];
    const int64_t ai_ref = on_ref[i];
    const uint8_t ai_rev = is_rev[i];
    for (int32_t j = i - 1; j >= 0; --j) {
      if (dp[j] + 1 <= dp[i]) continue;
      if (is_rev[j] != ai_rev) continue;
      const int64_t ref_diff =
          ai_rev ? (on_ref[j] - ai_ref) : (ai_ref - on_ref[j]);
      const int64_t read_diff = ai_read - on_read[j];
      const int64_t adiff = ref_diff >= read_diff ? ref_diff - read_diff
                                                  : read_diff - ref_diff;
      const int64_t aref = ref_diff < 0 ? -ref_diff : ref_diff;
      const int64_t mx = aref > read_diff ? aref : read_diff;
      const int64_t max_diff = (int64_t)((double)mx * 0.25);
      if ((adiff < max_diff ||
           (ai_read == on_read[j] && aref <= (int64_t)read_part_length)) &&
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
  int32_t m = 0;
  int32_t i = best_end;
  while (trace[i] != -1) {
    out_idx[m++] = i;
    i = trace[i];
  }
  out_idx[m++] = i;
  // reverse to ascending order
  for (int32_t a = 0, b = m - 1; a < b; ++a, --b) {
    int32_t t = out_idx[a];
    out_idx[a] = out_idx[b];
    out_idx[b] = t;
  }
  return m;
}

// Segmented variant of std_sort_perm_f32: sorts each [bounds[s], bounds[s+1])
// range of `keys` independently (the per-subread candidate sort,
// ScoreBuffer.cpp:173 — introsort tie order per subread), writing GLOBAL
// permutation indices into idx. One ctypes hop for a whole batch instead of
// one per subread.
extern "C" void std_sort_perm_f32_seg(const float* keys, const int64_t* bounds,
                                      int64_t n_segs, int32_t desc,
                                      int32_t* idx) {
  for (int64_t s = 0; s < n_segs; ++s) {
    int64_t lo = bounds[s], hi = bounds[s + 1];
    for (int64_t i = lo; i < hi; ++i) idx[i] = (int32_t)i;
    if (desc) {
      std::sort(idx + lo, idx + hi,
                [keys](int32_t a, int32_t b) { return keys[a] > keys[b]; });
    } else {
      std::sort(idx + lo, idx + hi,
                [keys](int32_t a, int32_t b) { return keys[a] < keys[b]; });
    }
  }
}
