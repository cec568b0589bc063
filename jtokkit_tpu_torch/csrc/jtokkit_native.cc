// Native host engine: pre-split + exact byte-pair merge.
//
// The reference's host engine is a sequential Java regex + HashMap merge
// (reference M/GptBytePairEncoding.java). This C++ engine implements the
// same two hot loops as tight scalar code over the SAME packed integer
// tables the device engine uses (built in Python, passed in as raw pointers):
//   - codepoint class table        int8 [0x110000]
//   - byte -> token id             int32[256]
//   - byte-pair seed table         int32[65536]
//   - cuckoo pair tables           int32[2][S] x (u, v, id), mask
//   - token byte pool + offsets    (for whole-piece direct hits)
//
// Exposed via a C ABI for ctypes. Thread-safe after init (tables are
// read-only); encode() may be called concurrently from multiple threads.
//
// Built at first use by jtokkit_tpu_torch/native.py (g++ -O3 -march=native
// -std=c++17 -shared -fPIC) into jtokkit_tpu_torch/_build/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>

namespace {

constexpr int32_t kMaxRank = 0x7fffffff;

// class codes (must match jtokkit_tpu_torch/engine/charclass.py)
enum Cls : int8_t { OTHER = 0, LETTER = 1, NUMBER = 2, WS = 3, CRLF = 4, SPACE = 5 };

struct Tables {
  const int8_t* cls;          // [0x110000]
  const int32_t* byte_to_id;  // [256]
  const int32_t* byte_pair;   // [65536]
  const int32_t* cu0;
  const int32_t* cv0;
  const int32_t* cid0;
  const int32_t* cu1;
  const int32_t* cv1;
  const int32_t* cid1;
  uint32_t mask;
  // direct-hit: open-addressing hash of token byte strings
  const uint8_t* pool;        // token byte pool
  const int32_t* offsets;     // [n_tokens + 1]
  int32_t n_tokens;
  std::vector<int32_t> dh_slot;  // token id per slot, -1 empty
  uint32_t dh_mask;
};

inline uint32_t mix_h(uint32_t u, uint32_t v, uint32_t a, uint32_t b, uint32_t c,
                      uint32_t mask) {
  uint32_t h = (u * a) ^ (v * b);
  h ^= h >> 15;
  h *= c;
  h ^= h >> 13;
  return h & mask;
}

inline int32_t pair_lookup(const Tables& t, int32_t u, int32_t v) {
  uint32_t s1 = mix_h((uint32_t)u, (uint32_t)v, 0x9E3779B1u, 0x85EBCA77u,
                      0x2C1B3C6Du, t.mask);
  if (t.cu0[s1] == u && t.cv0[s1] == v) return t.cid0[s1];
  uint32_t s2 = mix_h((uint32_t)u, (uint32_t)v, 0xC2B2AE3Du, 0x27D4EB2Fu,
                      0x165667B1u, t.mask);
  if (t.cu1[s2] == u && t.cv1[s2] == v) return t.cid1[s2];
  return -1;
}

// FNV-1a over bytes, for the direct-hit table
inline uint64_t bytes_hash(const uint8_t* p, int n) {
  uint64_t h = 1469598103934665603ull;
  for (int i = 0; i < n; i++) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

inline int32_t direct_hit(const Tables& t, const uint8_t* p, int n) {
  uint32_t s = (uint32_t)(bytes_hash(p, n) & t.dh_mask);
  while (true) {
    int32_t id = t.dh_slot[s];
    if (id < 0) return -1;
    int32_t off = t.offsets[id];
    if (t.offsets[id + 1] - off == n && memcmp(t.pool + off, p, n) == 0)
      return id;
    s = (s + 1) & t.dh_mask;
  }
}

// ---------------------------------------------------------------------------
// UTF-8 + classes
// ---------------------------------------------------------------------------

inline int decode_cp(const uint8_t* p, int n, int i, uint32_t* cp) {
  uint8_t b0 = p[i];
  if (b0 < 0x80) { *cp = b0; return 1; }
  if ((b0 & 0xE0) == 0xC0 && i + 1 < n) {
    *cp = ((b0 & 0x1Fu) << 6) | (p[i + 1] & 0x3Fu);
    return 2;
  }
  if ((b0 & 0xF0) == 0xE0 && i + 2 < n) {
    *cp = ((b0 & 0x0Fu) << 12) | ((p[i + 1] & 0x3Fu) << 6) | (p[i + 2] & 0x3Fu);
    return 3;
  }
  if ((b0 & 0xF8) == 0xF0 && i + 3 < n) {
    *cp = ((b0 & 0x07u) << 18) | ((p[i + 1] & 0x3Fu) << 12) |
          ((p[i + 2] & 0x3Fu) << 6) | (p[i + 3] & 0x3Fu);
    return 4;
  }
  *cp = 0xFFFD;  // malformed: lone byte
  return 1;
}

inline int8_t cls_at(const Tables& t, const uint8_t* p, int n, int i, int* len) {
  uint32_t cp;
  *len = decode_cp(p, n, i, &cp);
  return t.cls[cp < 0x110000 ? cp : 0];
}

inline bool is_ws(int8_t c) { return c >= WS; }

// case-folded contraction check; returns byte length of the suffix (0 = none)
inline int contraction_len(const uint8_t* p, int n, int i, bool fold) {
  if (i + 1 >= n) return 0;
  uint8_t b1 = p[i + 1];
  uint8_t l1 = (fold && b1 >= 'A' && b1 <= 'Z') ? b1 + 32 : b1;
  uint8_t b2 = (i + 2 < n) ? p[i + 2] : 0;
  uint8_t l2 = (fold && b2 >= 'A' && b2 <= 'Z') ? b2 + 32 : b2;
  if (l1 == 's' || l1 == 't' || l1 == 'm' || l1 == 'd') return 1;
  if ((l1 == 'r' && l2 == 'e') || (l1 == 'v' && l2 == 'e') ||
      (l1 == 'l' && l2 == 'l'))
    return 2;
  if (fold && b1 == 0xC5 && b2 == 0xBF) return 2;  // U+017F LONG S == 's'
  return 0;
}

// ---------------------------------------------------------------------------
// pre-split scanners (mirrors jtokkit_tpu_torch/engine/presplit.py)
// ---------------------------------------------------------------------------

// Appends piece end offsets for [0, n) to `ends`.
static void split_gpt2(const Tables& t, const uint8_t* p, int n,
                       std::vector<int>& ends,
                       int64_t max_pieces = INT64_MAX) {
  int i = 0;
  while (i < n) {
    if ((int64_t)ends.size() >= max_pieces) break;
    int len;
    int8_t c = cls_at(t, p, n, i, &len);
    if (c == OTHER) {
      if (p[i] == '\'') {
        int cl = contraction_len(p, n, i, false);
        if (cl) { i += 1 + cl; ends.push_back(i); continue; }
      }
      int j = i + len;
      while (j < n) { int l2; if (cls_at(t, p, n, j, &l2) != OTHER) break; j += l2; }
      i = j; ends.push_back(i); continue;
    }
    if (c == LETTER || c == NUMBER) {
      int j = i + len;
      while (j < n) { int l2; if (cls_at(t, p, n, j, &l2) != c) break; j += l2; }
      i = j; ends.push_back(i); continue;
    }
    // whitespace
    if (c == SPACE && i + 1 < n) {
      int l2;
      int8_t nxt = cls_at(t, p, n, i + 1, &l2);
      if (nxt == LETTER || nxt == NUMBER || nxt == OTHER) {
        int j = i + 1 + l2;
        while (j < n) { int l3; if (cls_at(t, p, n, j, &l3) != nxt) break; j += l3; }
        i = j; ends.push_back(i); continue;
      }
    }
    // \s+(?!\S) | \s+
    int j = i + len, last_start = i;
    while (j < n) {
      int l2; if (!is_ws(cls_at(t, p, n, j, &l2))) break;
      last_start = j; j += l2;
    }
    if (j == n) { i = j; }
    else if (j - i > 1) { i = (last_start > i) ? last_start : j; }
    else { i = j; }
    ends.push_back(i);
  }
}

static void split_cl100k(const Tables& t, const uint8_t* p, int n,
                         std::vector<int>& ends,
                         int64_t max_pieces = INT64_MAX) {
  int i = 0;
  while (i < n) {
    if ((int64_t)ends.size() >= max_pieces) break;
    int len;
    int8_t c = cls_at(t, p, n, i, &len);
    if (c == OTHER && p[i] == '\'') {
      int cl = contraction_len(p, n, i, true);
      if (cl) { i += 1 + cl; ends.push_back(i); continue; }
    }
    if (c == LETTER) {
      int j = i + len;
      while (j < n) { int l2; if (cls_at(t, p, n, j, &l2) != LETTER) break; j += l2; }
      i = j; ends.push_back(i); continue;
    }
    if (c != CRLF && c != NUMBER && i + len < n) {
      int l2;
      if (cls_at(t, p, n, i + len, &l2) == LETTER) {
        int j = i + len + l2;
        while (j < n) { int l3; if (cls_at(t, p, n, j, &l3) != LETTER) break; j += l3; }
        i = j; ends.push_back(i); continue;
      }
    }
    if (c == NUMBER) {
      int j = i + len, cnt = 1;
      while (j < n && cnt < 3) { int l2; if (cls_at(t, p, n, j, &l2) != NUMBER) break; j += l2; cnt++; }
      i = j; ends.push_back(i); continue;
    }
    if (c == OTHER || (c == SPACE && i + 1 < n)) {
      int start2 = (c == OTHER) ? i + len : i + 1;
      bool lead_space = (c == SPACE);
      if (!lead_space || (start2 < n)) {
        int l2 = 0;
        int8_t c2 = lead_space ? cls_at(t, p, n, start2, &l2) : OTHER;
        if (!lead_space || c2 == OTHER) {
          int j = lead_space ? start2 + l2 : start2;
          while (j < n) { int l3; if (cls_at(t, p, n, j, &l3) != OTHER) break; j += l3; }
          while (j < n && (p[j] == '\n' || p[j] == '\r')) j++;
          i = j; ends.push_back(i); continue;
        }
      }
    }
    // whitespace alternatives
    int j = i + len, last_crlf = -1;
    if (c == CRLF) last_crlf = i;
    while (j < n) {
      int l2; int8_t cj = cls_at(t, p, n, j, &l2);
      if (!is_ws(cj)) break;
      if (cj == CRLF) last_crlf = j;
      j += l2;
    }
    if (last_crlf >= 0) { i = last_crlf + 1; ends.push_back(i); continue; }
    int last_start = i;
    {
      int k = i + len;
      int prev = i;
      while (k < j) { int l2; cls_at(t, p, n, k, &l2); prev = k; k += l2; }
      last_start = prev;
    }
    if (j == n) { i = j; }
    else if (j - i > 1) { i = (last_start > i) ? last_start : j; }
    else { i = j; }
    ends.push_back(i);
  }
}

// ---------------------------------------------------------------------------
// merge (reference M/GptBytePairEncoding.java:200-275 semantics)
// ---------------------------------------------------------------------------

struct Part { int32_t index; int32_t rank; };

// Long-piece merge: doubly-linked span list + lazy min-heap keyed on
// (rank, leftmost boundary). Exactly the reference's min-rank order — the
// heap pops the lowest rank, leftmost first on ties, and stale entries
// (whose boundary's pair changed or vanished) are skipped; a re-executed
// boundary can never reproduce a previous rank because ranks are token ids
// and the merged span strictly grows. O(m log m) instead of the scan
// loop's O(m^2), which dominates CJK-style 100-600 byte letter-run pieces.
static int merge_piece_heap(const Tables& t, const uint8_t* p, int n,
                            int32_t* out) {
  thread_local std::vector<int32_t> nxt, prv, ids, cur;
  nxt.resize(n + 1); prv.resize(n + 1); ids.resize(n); cur.resize(n + 1);
  for (int b = 0; b <= n; b++) { nxt[b] = b + 1; prv[b] = b - 1; }
  for (int b = 0; b < n; b++) ids[b] = t.byte_to_id[p[b]];
  // min-heap of (rank, boundary) packed into one int64: rank<<32 | b
  thread_local std::vector<int64_t> heap;
  heap.clear();
  auto push = [&](int32_t rank, int32_t b) {
    heap.push_back(((int64_t)rank << 32) | (uint32_t)b);
    std::push_heap(heap.begin(), heap.end(), std::greater<int64_t>());
  };
  for (int b = 0; b + 1 < n; b++) {
    int32_t r = t.byte_pair[p[b] * 256 + p[b + 1]];
    cur[b] = (r < 0) ? kMaxRank : r;
    if (cur[b] != kMaxRank) push(cur[b], b);
  }
  cur[n - 1] = kMaxRank;
  cur[n] = kMaxRank;
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), std::greater<int64_t>());
    int64_t e = heap.back(); heap.pop_back();
    int32_t r = (int32_t)(e >> 32);
    int32_t b = (int32_t)(e & 0xFFFFFFFF);
    if (cur[b] != r) continue;  // stale: pair changed or span removed
    int32_t j = nxt[b];          // right span's boundary
    ids[b] = r;                  // left span takes the merged id
    int32_t k = nxt[j];          // boundary after the absorbed span
    nxt[b] = k; if (k <= n) prv[k] = b;
    cur[j] = kMaxRank;           // j is gone; its heap entries go stale
    if (k < n) {
      int32_t r2 = pair_lookup(t, ids[b], ids[k]);
      cur[b] = (r2 < 0) ? kMaxRank : r2;
      if (cur[b] != kMaxRank) push(cur[b], b);
    } else {
      cur[b] = kMaxRank;
    }
    int32_t pi = prv[b];
    if (pi >= 0) {
      int32_t r3 = pair_lookup(t, ids[pi], ids[b]);
      cur[pi] = (r3 < 0) ? kMaxRank : r3;
      if (cur[pi] != kMaxRank) push(cur[pi], pi);
    }
  }
  int m = 0;
  for (int b = 0; b < n; b = nxt[b]) out[m++] = ids[b];
  return m;
}

static int merge_piece(const Tables& t, const uint8_t* p, int n,
                       int32_t* out) {
  // direct hit first (reference :81-83)
  if (n <= 128) {
    int32_t id = direct_hit(t, p, n);
    if (id >= 0) { out[0] = id; return 1; }
  }
  if (n > 96) return merge_piece_heap(t, p, n, out);
  // parts over n+1 boundaries; ids of current spans tracked for lookups
  thread_local std::vector<Part> parts;
  thread_local std::vector<int32_t> ids;
  parts.resize(n + 1);
  ids.resize(n);
  for (int i = 0; i <= n; i++) parts[i] = {i, kMaxRank};
  for (int i = 0; i < n; i++) ids[i] = t.byte_to_id[p[i]];
  for (int i = 0; i + 1 < n; i++) {
    int32_t r = t.byte_pair[p[i] * 256 + p[i + 1]];
    parts[i].rank = (r < 0) ? kMaxRank : r;
  }
  int count = n + 1;
  while (count > 1) {
    int32_t min_rank = kMaxRank;
    int min_idx = 0;
    for (int i = 0; i + 1 < count; i++) {
      if (parts[i].rank < min_rank) { min_rank = parts[i].rank; min_idx = i; }
    }
    if (min_rank == kMaxRank) break;
    // merge: left span takes the merged id (rank == id)
    ids[parts[min_idx].index] = min_rank;
    // recompute neighbors (skip=1) before removal
    if (min_idx + 3 < count) {
      int32_t r = pair_lookup(t, min_rank, ids[parts[min_idx + 2].index]);
      parts[min_idx].rank = (r < 0) ? kMaxRank : r;
    } else {
      parts[min_idx].rank = kMaxRank;
    }
    if (min_idx > 0) {
      int32_t r = pair_lookup(t, ids[parts[min_idx - 1].index], min_rank);
      parts[min_idx - 1].rank = (r < 0) ? kMaxRank : r;
    }
    memmove(&parts[min_idx + 1], &parts[min_idx + 2],
            (count - min_idx - 2) * sizeof(Part));
    count--;
  }
  int m = 0;
  for (int i = 0; i + 1 < count; i++) out[m++] = ids[parts[i].index];
  return m;
}

// Multiple independent table sets so several encodings can be used
// concurrently; each handle's tables are immutable after jt_init.
constexpr int kMaxHandles = 16;
Tables g_handles[kMaxHandles];
bool g_handle_ready[kMaxHandles] = {};

}  // namespace

extern "C" {

// Initializes table slot `handle` (0..15). Returns handle, or -1 on error.
int jt_init(int32_t handle, const int8_t* cls, const int32_t* byte_to_id,
            const int32_t* byte_pair, const int32_t* cu, const int32_t* cv,
            const int32_t* cid, int64_t table_size, const uint8_t* pool,
            const int32_t* offsets, int32_t n_tokens) {
  if (handle < 0 || handle >= kMaxHandles) return -1;
  Tables& t = g_handles[handle];
  t.cls = cls;
  t.byte_to_id = byte_to_id;
  t.byte_pair = byte_pair;
  t.cu0 = cu; t.cv0 = cv; t.cid0 = cid;
  t.cu1 = cu + table_size; t.cv1 = cv + table_size;
  t.cid1 = cid + table_size;
  t.mask = (uint32_t)(table_size - 1);
  t.pool = pool;
  t.offsets = offsets;
  t.n_tokens = n_tokens;
  // build the direct-hit byte-string hash (one-time)
  uint32_t size = 1;
  while (size < (uint32_t)(2 * n_tokens)) size <<= 1;
  t.dh_mask = size - 1;
  t.dh_slot.assign(size, -1);
  for (int32_t id = 0; id < n_tokens; id++) {
    int32_t off = offsets[id], len = offsets[id + 1] - off;
    if (len <= 0) continue;
    uint32_t s = (uint32_t)(bytes_hash(pool + off, len) & t.dh_mask);
    while (t.dh_slot[s] >= 0) s = (s + 1) & t.dh_mask;
    t.dh_slot[s] = id;
  }
  g_handle_ready[handle] = true;
  return handle;
}

// pattern: 0 = gpt2, 1 = cl100k.
// out must have room for `n` int32 (<= one token per byte).
// Returns token count, or -1 if the handle is not initialized.
int64_t jt_encode(int32_t handle, const uint8_t* text, int64_t n,
                  int32_t pattern, int32_t* out) {
  if (handle < 0 || handle >= kMaxHandles || !g_handle_ready[handle]) return -1;
  const Tables& t = g_handles[handle];
  thread_local std::vector<int> ends;
  ends.clear();
  if (pattern == 0) split_gpt2(t, text, (int)n, ends);
  else split_cl100k(t, text, (int)n, ends);
  int64_t m = 0;
  int start = 0;
  for (int e : ends) {
    m += merge_piece(t, text + start, e - start, out + m);
    start = e;
  }
  return m;
}

// Capped encode: early-exits the pre-split scan once max_tokens pieces are
// found (every piece yields >= 1 token) and stops merging once max_tokens
// tokens are produced — the reference's maxTokens early exit
// (M/GptBytePairEncoding.java:79,281-283). Writes at most max_tokens ids to
// out (the multibyte repair runs in Python). O(prefix), not O(n).
int64_t jt_encode_capped(int32_t handle, const uint8_t* text, int64_t n,
                         int32_t pattern, int32_t* out, int64_t max_tokens) {
  if (handle < 0 || handle >= kMaxHandles || !g_handle_ready[handle]) return -1;
  if (max_tokens <= 0) return 0;
  const Tables& t = g_handles[handle];
  thread_local std::vector<int> ends;
  thread_local std::vector<int32_t> scratch;
  ends.clear();
  if (pattern == 0) split_gpt2(t, text, (int)n, ends, max_tokens);
  else split_cl100k(t, text, (int)n, ends, max_tokens);
  int64_t m = 0;
  int start = 0;
  for (int e : ends) {
    int plen = e - start;
    scratch.resize(plen);
    int cnt = merge_piece(t, text + start, plen, scratch.data());
    int take = (int)std::min<int64_t>(cnt, max_tokens - m);
    std::memcpy(out + m, scratch.data(), take * sizeof(int32_t));
    m += take;
    if (m >= max_tokens) break;
    start = e;
  }
  return m;
}

// Pre-split only: writes piece end offsets, returns piece count.
int64_t jt_split(int32_t handle, const uint8_t* text, int64_t n,
                 int32_t pattern, int32_t* out_ends) {
  if (handle < 0 || handle >= kMaxHandles || !g_handle_ready[handle]) return -1;
  const Tables& t = g_handles[handle];
  thread_local std::vector<int> ends;
  ends.clear();
  if (pattern == 0) split_gpt2(t, text, (int)n, ends);
  else split_cl100k(t, text, (int)n, ends);
  for (size_t i = 0; i < ends.size(); i++) out_ends[i] = ends[i];
  return (int64_t)ends.size();
}

}  // extern "C"
