// Chunk packer of the device engine: a batch of Python documents written
// as UTF-8 into one chunk buffer at a time.
//
// jt_pack_chunk reads the documents of a Python sequence from a cursor and
// writes them into the caller's block (the pinned staging block that the
// chunk's upload copies from): each document's UTF-8, a zero byte between
// documents, zeros up to the chunk's quantized size, and per chunk-document
// its end offset and its index in the batch. A document is read from its
// own PEP 393 storage: ASCII storage is copied, 1-, 2- and 4-byte storage
// is measured and then transcoded a block of characters at a time, without
// a branch per character where the compiler targets SSE4.1 (ASCII runs 16
// at a time, 1- and 2-byte forms 8 at a time by a byte shuffle; the rest,
// and every character of a build without SSE4.1, by selects). Anything
// else (None and a falsy item are empty; any other object, and a str
// holding a lone surrogate) goes through its encode("utf-8"), so errors are
// Python's own.
//
// The chunk rule is the engine's greedy packing: a document joins the
// chunk while the chunk's bytes (separators between documents included)
// stay under chunk_bytes; the first document that does not fit starts the
// next call. A document over chunk_bytes - 1 bytes is cut at its last safe
// point within the limit (an ASCII letter or digit followed by CR or LF),
// and the rest stays at the cursor; one with no such point is a chunk of
// its own.
//
// Built at first use by jtokkit_tpu_torch/pack.py (g++ -O3 -march=native
// -std=c++17 -shared -fPIC -I<Python include>) into jtokkit_tpu_torch/_build/,
// and loaded with ctypes.PyDLL: it runs with the GIL held and reports a
// Python error by setting it and returning -1.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

#if defined(__SSE4_1__)
#include <immintrin.h>
#define JT_SSE 1
#else
#define JT_SSE 0
#endif

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the 4-byte stores below assume a little-endian host");

namespace {

// ---------------------------------------------------------------------
// one document's text
// ---------------------------------------------------------------------

// kind: 0 UTF-8 known to be ASCII (ASCII storage), 1 / 2 / 4 str storage
// of that many bytes a character, 8 UTF-8 bytes of any content (what an
// encode() returned). n counts characters (bytes for kinds 0 and 8).
struct Text {
  int kind = 0;
  const void* data = "";
  int64_t n = 0;
};

template <typename C>
inline const C* chars(const Text& t) {
  return static_cast<const C*>(t.data);
}

inline int clen(uint32_t c) {
  return 1 + (c >= 0x80) + (c >= 0x800) + (c >= 0x10000);
}

// ---------------------------------------------------------------------
// UTF-8 lengths: utf8_len(s, n, &surrogate) gives the UTF-8 bytes of n
// characters of 1-, 2- or 4-byte storage and sets surrogate when one is a
// surrogate code point (a str that str.encode refuses). A block of
// characters at a time with SSE, the rest one at a time.
// ---------------------------------------------------------------------

template <typename C>
int64_t utf8_len_tail(const C* s, int64_t n, uint32_t* sur) {
  int64_t bytes = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t c = s[i];
    bytes += clen(c);
    *sur |= ((c & 0xFFFFF800u) == 0xD800u);
  }
  return bytes;
}

int64_t utf8_len(const uint8_t* s, int64_t n, bool* surrogate) {
  int64_t i = 0, bytes = 0;
#if JT_SSE
  for (; i + 16 <= n; i += 16)
    bytes += 16 + __builtin_popcount(_mm_movemask_epi8(
                      _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i))));
#endif
  uint32_t sur = 0;
  bytes += utf8_len_tail(s + i, n - i, &sur);
  *surrogate = false;
  return bytes;
}

int64_t utf8_len(const uint16_t* s, int64_t n, bool* surrogate) {
  int64_t i = 0, bytes = 0;
  uint32_t sur = 0;
#if JT_SSE
  {
    const __m128i high = _mm_set1_epi16(static_cast<short>(0xFF80));
    const __m128i above = _mm_set1_epi16(static_cast<short>(0xF800));
    const __m128i low_sur = _mm_set1_epi16(static_cast<short>(0xD800));
    const __m128i zero = _mm_setzero_si128();
    for (; i + 8 <= n; i += 8) {
      const __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i));
      const __m128i top = _mm_and_si128(v, above);
      // two mask bits a character: 3 bytes less one under 0x80, one under 0x800
      const int under = __builtin_popcount(_mm_movemask_epi8(
                            _mm_cmpeq_epi16(_mm_and_si128(v, high), zero))) +
                        __builtin_popcount(_mm_movemask_epi8(_mm_cmpeq_epi16(top, zero)));
      bytes += 24 - under / 2;
      sur |= _mm_movemask_epi8(_mm_cmpeq_epi16(top, low_sur));
    }
  }
#endif
  bytes += utf8_len_tail(s + i, n - i, &sur);
  *surrogate = sur != 0;
  return bytes;
}

int64_t utf8_len(const uint32_t* s, int64_t n, bool* surrogate) {
  int64_t i = 0, bytes = 0;
  uint32_t sur = 0;
  bytes += utf8_len_tail(s + i, n - i, &sur);
  *surrogate = sur != 0;
  return bytes;
}

int64_t text_utf8_len(const Text& t, int64_t from, int64_t n, bool* surrogate) {
  *surrogate = false;
  switch (t.kind) {
    case 1: return utf8_len(chars<uint8_t>(t) + from, n, surrogate);
    case 2: return utf8_len(chars<uint16_t>(t) + from, n, surrogate);
    case 4: return utf8_len(chars<uint32_t>(t) + from, n, surrogate);
    default: return n;
  }
}

// ---------------------------------------------------------------------
// the split search
// ---------------------------------------------------------------------

inline bool ascii_alnum(uint32_t c) {
  return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z');
}

// The last j in [1, kk) with s[j] CR or LF after an ASCII letter or digit,
// or 0: the characters before j form the piece.
template <typename C>
int64_t last_safe_point(const C* s, int64_t kk) {
  int64_t j = kk - 1;
#if JT_SSE
  if (sizeof(C) == 1) {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(s);
    const __m128i lf = _mm_set1_epi8('\n'), cr = _mm_set1_epi8('\r');
    // 16 bytes [j - 15, j] at a time, skipped when none is CR or LF
    while (j >= 16) {
      const __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(b + j - 15));
      unsigned m = _mm_movemask_epi8(
          _mm_or_si128(_mm_cmpeq_epi8(v, lf), _mm_cmpeq_epi8(v, cr)));
      while (m) {
        const int top = 31 - __builtin_clz(m);
        const int64_t at = j - 15 + top;
        if (ascii_alnum(b[at - 1])) return at;
        m &= ~(1u << top);
      }
      j -= 16;
    }
  }
#endif
  for (; j >= 1; --j) {
    const uint32_t c = s[j];
    if ((c == '\n' || c == '\r') && ascii_alnum(s[j - 1])) return j;
  }
  return 0;
}

// Characters of the piece cut from s[0, n) (whose UTF-8 is over limit
// bytes): the split point is the last safe point whose byte offset is
// under limit, found among the characters that start under limit.
template <typename C>
int64_t split_chars(const C* s, int64_t n, int64_t limit, bool bytes) {
  int64_t kk;
  if (bytes) {
    kk = n < limit ? n : limit;
  } else {
    // kk: the characters whose UTF-8 starts under limit, 64 at a time
    // while a whole block and the character after it start under it
    int64_t i = 0, off = 0;
    bool sur;
    while (i + 64 <= n) {
      const int64_t b = utf8_len(s + i, 64, &sur);
      if (off + b >= limit) break;
      off += b;
      i += 64;
    }
    while (i < n && off < limit) off += clen(s[i++]);
    kk = i;
  }
  return last_safe_point(s, kk);
}

int64_t text_split(const Text& t, int64_t from, int64_t n, int64_t limit) {
  switch (t.kind) {
    case 1: return split_chars(chars<uint8_t>(t) + from, n, limit, false);
    case 2: return split_chars(chars<uint16_t>(t) + from, n, limit, false);
    case 4: return split_chars(chars<uint32_t>(t) + from, n, limit, false);
    default: return split_chars(chars<uint8_t>(t) + from, n, limit, true);
  }
}

// ---------------------------------------------------------------------
// UTF-8 writers: write_*(s, n, d, end) writes the UTF-8 of n characters at
// d, a block of characters at a time with SSE while d is at least
// kBlockRoom bytes from end, and the rest one character at a time. A
// block's 16-byte stores reach past the bytes it writes: at most 52 bytes
// from d for 16 characters of 2-byte storage (three bytes each, the last
// store at d + 36), 32 for 16 of 1-byte storage, 16 for 4 of 4-byte.
// ---------------------------------------------------------------------

constexpr int64_t kBlockRoom = 64;

// one character, exactly its bytes
inline uint8_t* put(uint8_t* d, uint32_t c) {
  if (c < 0x80) {
    *d++ = static_cast<uint8_t>(c);
  } else if (c < 0x800) {
    d[0] = 0xC0 | (c >> 6);
    d[1] = 0x80 | (c & 0x3F);
    d += 2;
  } else if (c < 0x10000) {
    d[0] = 0xE0 | (c >> 12);
    d[1] = 0x80 | ((c >> 6) & 0x3F);
    d[2] = 0x80 | (c & 0x3F);
    d += 3;
  } else {
    d[0] = 0xF0 | (c >> 18);
    d[1] = 0x80 | ((c >> 12) & 0x3F);
    d[2] = 0x80 | ((c >> 6) & 0x3F);
    d[3] = 0x80 | (c & 0x3F);
    d += 4;
  }
  return d;
}

// one character by selects and one 4-byte store (4 bytes of room)
inline uint8_t* put4(uint8_t* d, uint32_t c) {
  const uint32_t two = (0xC0 | (c >> 6)) | ((0x80 | (c & 0x3F)) << 8);
  const uint32_t three = (0xE0 | (c >> 12)) | ((0x80 | ((c >> 6) & 0x3F)) << 8) |
                         ((0x80 | (c & 0x3F)) << 16);
  const uint32_t four = (0xF0 | (c >> 18)) | ((0x80 | ((c >> 12) & 0x3F)) << 8) |
                        ((0x80 | ((c >> 6) & 0x3F)) << 16) | ((0x80 | (c & 0x3F)) << 24);
  const uint32_t w = c < 0x80 ? c : c < 0x800 ? two : c < 0x10000 ? three : four;
  std::memcpy(d, &w, 4);
  return d + clen(c);
}

template <typename C>
uint8_t* write_tail(const C* s, int64_t n, uint8_t* d, uint8_t* end) {
  int64_t i = 0;
  for (; i < n && end - d >= 4; ++i) d = put4(d, s[i]);
  for (; i < n; ++i) d = put(d, s[i]);
  return d;
}

#if JT_SSE

// kTable.shuffle[m]: the bytes to keep of 8 16-bit lanes, lane k's low
// byte and, where bit k of m is set, its high byte too; len[m] how many
struct ShuffleTable {
  alignas(16) uint8_t shuffle[256][16];
  uint8_t len[256];
  ShuffleTable() {
    for (int m = 0; m < 256; ++m) {
      int o = 0;
      for (int k = 0; k < 8; ++k) {
        shuffle[m][o++] = static_cast<uint8_t>(2 * k);
        if (m & (1 << k)) shuffle[m][o++] = static_cast<uint8_t>(2 * k + 1);
      }
      len[m] = static_cast<uint8_t>(o);
      for (; o < 16; ++o) shuffle[m][o] = 0x80;
    }
  }
};
const ShuffleTable kTable;

// 8 characters under 0x800 (16-bit lanes): one or two bytes each
inline uint8_t* under_0x800(__m128i v, uint8_t* d) {
  const __m128i lead = _mm_or_si128(_mm_srli_epi16(v, 6), _mm_set1_epi16(0xC0));
  const __m128i cont =
      _mm_or_si128(_mm_and_si128(v, _mm_set1_epi16(0x3F)), _mm_set1_epi16(0x80));
  const __m128i two = _mm_or_si128(lead, _mm_slli_epi16(cont, 8));
  const __m128i wide = _mm_cmpgt_epi16(v, _mm_set1_epi16(0x7F));
  const __m128i lanes = _mm_blendv_epi8(v, two, wide);
  const unsigned m =
      _mm_movemask_epi8(_mm_packs_epi16(wide, _mm_setzero_si128())) & 0xFF;
  const __m128i sel =
      _mm_load_si128(reinterpret_cast<const __m128i*>(kTable.shuffle[m]));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(d), _mm_shuffle_epi8(lanes, sel));
  return d + kTable.len[m];
}

// kForms.shuffle[m]: the bytes to keep of 4 32-bit lanes, the first
// 1 + ((m >> 2k) & 3) of lane k; len[m] how many
struct FormTable {
  alignas(16) uint8_t shuffle[256][16];
  uint8_t len[256];
  FormTable() {
    for (int m = 0; m < 256; ++m) {
      int o = 0;
      for (int k = 0; k < 4; ++k)
        for (int b = 0; b <= ((m >> (2 * k)) & 3); ++b)
          shuffle[m][o++] = static_cast<uint8_t>(4 * k + b);
      len[m] = static_cast<uint8_t>(o);
      for (; o < 16; ++o) shuffle[m][o] = 0x80;
    }
  }
};
const FormTable kForms;

// 4 code points in 32-bit lanes, none a surrogate: each one's form of one
// to four bytes (lead byte low), its bytes kept by one shuffle
inline uint8_t* utf8_x4(__m128i c, uint8_t* d) {
  const __m128i x3f = _mm_set1_epi32(0x3F), x80 = _mm_set1_epi32(0x80);
  const __m128i c0 = _mm_or_si128(_mm_and_si128(c, x3f), x80);
  const __m128i c1 = _mm_or_si128(_mm_and_si128(_mm_srli_epi32(c, 6), x3f), x80);
  const __m128i c2 = _mm_or_si128(_mm_and_si128(_mm_srli_epi32(c, 12), x3f), x80);
  const __m128i two = _mm_or_si128(
      _mm_or_si128(_mm_srli_epi32(c, 6), _mm_set1_epi32(0xC0)), _mm_slli_epi32(c0, 8));
  const __m128i three =
      _mm_or_si128(_mm_or_si128(_mm_srli_epi32(c, 12), _mm_set1_epi32(0xE0)),
                   _mm_or_si128(_mm_slli_epi32(c1, 8), _mm_slli_epi32(c0, 16)));
  const __m128i four = _mm_or_si128(
      _mm_or_si128(_mm_srli_epi32(c, 18), _mm_set1_epi32(0xF0)),
      _mm_or_si128(_mm_slli_epi32(c2, 8),
                   _mm_or_si128(_mm_slli_epi32(c1, 16), _mm_slli_epi32(c0, 24))));
  const __m128i two_up = _mm_cmpgt_epi32(c, _mm_set1_epi32(0x7F));
  const __m128i three_up = _mm_cmpgt_epi32(c, _mm_set1_epi32(0x7FF));
  const __m128i four_up = _mm_cmpgt_epi32(c, _mm_set1_epi32(0xFFFF));
  __m128i w = _mm_blendv_epi8(c, two, two_up);
  w = _mm_blendv_epi8(w, three, three_up);
  w = _mm_blendv_epi8(w, four, four_up);
  // each lane's bytes less one (0 to 3) in byte k, then two bits a lane
  const __m128i extra = _mm_sub_epi32(_mm_setzero_si128(),
                                      _mm_add_epi32(_mm_add_epi32(two_up, three_up), four_up));
  const __m128i zero = _mm_setzero_si128();
  const uint32_t x = static_cast<uint32_t>(
      _mm_cvtsi128_si32(_mm_packus_epi16(_mm_packs_epi32(extra, zero), zero)));
  const uint32_t m = (x | x >> 6 | x >> 12 | x >> 18) & 0xFF;
  const __m128i sel = _mm_load_si128(reinterpret_cast<const __m128i*>(kForms.shuffle[m]));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(d), _mm_shuffle_epi8(w, sel));
  return d + kForms.len[m];
}

// 8 characters of 2-byte storage in v
inline uint8_t* block8(__m128i v, uint8_t* d) {
  if (_mm_testz_si128(v, _mm_set1_epi16(static_cast<short>(0xF800))))
    return under_0x800(v, d);
  d = utf8_x4(_mm_cvtepu16_epi32(v), d);
  return utf8_x4(_mm_cvtepu16_epi32(_mm_srli_si128(v, 8)), d);
}

#endif

uint8_t* write_ucs1(const uint8_t* s, int64_t n, uint8_t* d, uint8_t* end) {
  int64_t i = 0;
#if JT_SSE
  for (; i + 16 <= n && end - d >= kBlockRoom; i += 16) {
    const __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i));
    if (_mm_movemask_epi8(v) == 0) {
      _mm_storeu_si128(reinterpret_cast<__m128i*>(d), v);
      d += 16;
    } else {
      d = under_0x800(_mm_cvtepu8_epi16(v), d);
      d = under_0x800(_mm_cvtepu8_epi16(_mm_srli_si128(v, 8)), d);
    }
  }
#endif
  return write_tail(s + i, n - i, d, end);
}

uint8_t* write_ucs2(const uint16_t* s, int64_t n, uint8_t* d, uint8_t* end) {
  int64_t i = 0;
#if JT_SSE
  const __m128i high = _mm_set1_epi16(static_cast<short>(0xFF80));
  for (; i + 16 <= n && end - d >= kBlockRoom; i += 16) {
    const __m128i v0 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i));
    const __m128i v1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i + 8));
    if (_mm_testz_si128(_mm_or_si128(v0, v1), high)) {
      _mm_storeu_si128(reinterpret_cast<__m128i*>(d), _mm_packus_epi16(v0, v1));
      d += 16;
    } else {
      d = block8(v0, d);
      d = block8(v1, d);
    }
  }
#endif
  return write_tail(s + i, n - i, d, end);
}

uint8_t* write_ucs4(const uint32_t* s, int64_t n, uint8_t* d, uint8_t* end) {
  int64_t i = 0;
#if JT_SSE
  for (; i + 4 <= n && end - d >= kBlockRoom; i += 4)
    d = utf8_x4(_mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i)), d);
#endif
  return write_tail(s + i, n - i, d, end);
}

// The UTF-8 of characters [from, from + n) of t at d (nbytes of them for
// kinds 0 and 8, whose text is its bytes); returns where it ends. The
// characters hold no surrogate.
uint8_t* text_write(const Text& t, int64_t from, int64_t n, int64_t nbytes, uint8_t* d,
                    uint8_t* end) {
  switch (t.kind) {
    case 1: return write_ucs1(chars<uint8_t>(t) + from, n, d, end);
    case 2: return write_ucs2(chars<uint16_t>(t) + from, n, d, end);
    case 4: return write_ucs4(chars<uint32_t>(t) + from, n, d, end);
    default: std::memcpy(d, chars<uint8_t>(t) + from, nbytes); return d + nbytes;
  }
}

bool bytes_ascii(const uint8_t* s, int64_t n) {
  uint8_t any = 0;
  for (int64_t i = 0; i < n; ++i) any |= s[i];
  return any < 0x80;
}

// ---------------------------------------------------------------------
// the batch
// ---------------------------------------------------------------------

Py_ssize_t batch_len(PyObject* seq) {
  if (PyList_Check(seq)) return PyList_GET_SIZE(seq);
  if (PyTuple_Check(seq)) return PyTuple_GET_SIZE(seq);
  return PySequence_Size(seq);
}

// a new reference to item i, or nullptr with the error set
PyObject* batch_item(PyObject* seq, Py_ssize_t i) {
  PyObject* o = nullptr;
  if (PyList_Check(seq)) {
    if (i < PyList_GET_SIZE(seq)) o = PyList_GET_ITEM(seq, i);
  } else if (PyTuple_Check(seq)) {
    o = PyTuple_GET_ITEM(seq, i);
  } else {
    return PySequence_GetItem(seq, i);
  }
  if (o == nullptr) {
    PyErr_SetString(PyExc_IndexError, "the batch changed while it was packed");
    return nullptr;
  }
  Py_INCREF(o);
  return o;
}

// bytes of a document's storage warmed ahead of its turn
constexpr int64_t kPrefetchBytes = 4096;

// For a list or tuple: warm item i + 3's object and the first bytes of
// item i + 2's storage (its object warmed a step before), so that a
// document's first lines come from the cache and not from memory one miss
// at a time (documents are scattered small objects)
void prefetch_after(PyObject* seq, Py_ssize_t i) {
  if (!PyList_Check(seq) && !PyTuple_Check(seq)) return;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject** items = PySequence_Fast_ITEMS(seq);
  if (i + 3 < n) __builtin_prefetch(items[i + 3]);
  if (i + 2 < n && PyUnicode_CheckExact(items[i + 2])) {
    PyObject* o = items[i + 2];
    const char* d = static_cast<const char*>(PyUnicode_DATA(o));
    const int64_t len = PyUnicode_GET_LENGTH(o) * PyUnicode_KIND(o);
    for (int64_t k = 0; k < len && k < kPrefetchBytes; k += 64) __builtin_prefetch(d + k);
  }
}

// The UTF-8 of an item by its encode("utf-8") (``t.encode("utf-8") if t
// else b""``), held in *owned. False with the error set.
bool text_by_encode(PyObject* item, Text* t, PyObject** owned) {
  const int truth = PyObject_IsTrue(item);
  if (truth < 0) return false;
  if (!truth) return true;
  PyObject* b = PyObject_CallMethod(item, "encode", "s", "utf-8");
  if (b == nullptr) return false;
  if (!PyBytes_Check(b)) {
    PyErr_Format(PyExc_TypeError, "encode('utf-8') returned %.100s, not bytes",
                 Py_TYPE(b)->tp_name);
    Py_DECREF(b);
    return false;
  }
  *owned = b;
  t->kind = 8;
  t->data = PyBytes_AS_STRING(b);
  t->n = PyBytes_GET_SIZE(b);
  return true;
}

// An item's text. False with the error set.
bool text_of(PyObject* item, Text* t, PyObject** owned) {
  if (item == Py_None) return true;
  if (!PyUnicode_CheckExact(item)) return text_by_encode(item, t, owned);
  t->n = PyUnicode_GET_LENGTH(item);
  t->data = PyUnicode_DATA(item);
  t->kind = PyUnicode_IS_ASCII(item) ? 0 : static_cast<int>(PyUnicode_KIND(item));
  return true;
}

int64_t quantize(int64_t n, const int64_t* sizes, int64_t n_sizes) {
  for (int64_t k = 0; k < n_sizes; ++k)
    if (n <= sizes[k]) return sizes[k];
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// One chunk of the batch ``texts`` from ``cursor`` (document index,
// character offset into it, its UTF-8 bytes from there when the offset is
// not 0), written into ``out`` (``cap`` bytes): returns the chunk's
// documents n, and ends[0, n), parts[0, n) hold each one's end offset and
// batch index; result[0] its bytes, result[1] its size (``sizes``
// quantized: the first that holds it, else the next power of two; zeros
// from result[0] on), result[2] 1 if every byte is ASCII, result[3] the
// documents read from non-ASCII storage, result[5] the length of its
// document ends (n by ``doc_sizes``), result[6] 1 if the batch ends with
// it. The cursor moves past the chunk. Returns 0 at the end of the batch,
// -2 when the chunk's one document needs a block of result[4] bytes
// (nothing is written), -1 with a Python error set.
int64_t jt_pack_chunk(PyObject* texts, int64_t* cursor, uint8_t* out, int64_t cap,
                      int32_t* ends, int32_t* parts, int64_t chunk_bytes,
                      const int64_t* sizes, int64_t n_sizes, const int64_t* doc_sizes,
                      int64_t n_doc_sizes, int64_t* result) {
  const Py_ssize_t n_docs = batch_len(texts);
  if (n_docs < 0) return -1;
  const int64_t limit = chunk_bytes - 1;
  uint8_t* const end = out + cap;
  int64_t n = 0, pos = 0, size = 0, wide = 0;
  bool ascii = true;
  while (cursor[0] < n_docs) {
    const int64_t i = cursor[0], from = cursor[1];
    PyObject* item = batch_item(texts, i);
    if (item == nullptr) return -1;
    prefetch_after(texts, i);
    PyObject* owned = nullptr;
    Text t;
    if (!text_of(item, &t, &owned)) {
      Py_DECREF(item);
      return -1;
    }
    const int64_t rest = t.n - from;
    int64_t rest_bytes = rest;
    if (from > 0) {
      rest_bytes = cursor[2];
    } else if (t.kind != 0 && t.kind != 8) {
      bool surrogate;
      rest_bytes = text_utf8_len(t, 0, rest, &surrogate);
      if (surrogate) {
        // str.encode raises for it: the same call, the same error
        t = Text();
        if (!text_by_encode(item, &t, &owned)) {
          Py_DECREF(item);
          return -1;
        }
        rest_bytes = t.n;
      }
    }
    int64_t take = rest, take_bytes = rest_bytes;
    if (rest_bytes > limit) {
      const int64_t j = text_split(t, from, rest, limit);
      if (j > 0) {
        bool surrogate;
        take = j;
        take_bytes = text_utf8_len(t, from, j, &surrogate);
      }
    }
    const bool fits = n == 0 ? quantize(take_bytes, sizes, n_sizes) <= cap
                             : size + take_bytes + 1 <= chunk_bytes;
    if (!fits) {
      Py_XDECREF(owned);
      Py_DECREF(item);
      if (n > 0) break;
      result[4] = quantize(take_bytes, sizes, n_sizes);
      return -2;
    }
    if (n > 0) out[pos++] = 0;  // separator (invalid byte; derived on the device)
    text_write(t, from, take, take_bytes, out + pos, end);
    if (t.kind == 8) {
      ascii = ascii && bytes_ascii(out + pos, take_bytes);
    } else if (t.kind != 0) {
      ascii = ascii && take_bytes == take;
      wide += from == 0;
    }
    pos += take_bytes;
    ends[n] = static_cast<int32_t>(pos);
    parts[n] = static_cast<int32_t>(i);
    ++n;
    size += take_bytes + 1;
    if (take < rest) {
      cursor[1] = from + take;
      cursor[2] = rest_bytes - take_bytes;
    } else {
      cursor[0] = i + 1;
      cursor[1] = cursor[2] = 0;
    }
    Py_XDECREF(owned);
    Py_DECREF(item);
  }
  const int64_t padded = n ? quantize(pos, sizes, n_sizes) : 0;
  if (n) std::memset(out + pos, 0, padded - pos);
  result[0] = pos;
  result[1] = padded;
  result[2] = ascii;
  result[3] = wide;
  result[5] = n ? quantize(n, doc_sizes, n_doc_sizes) : 0;
  result[6] = cursor[0] >= n_docs;
  return n;
}

}  // extern "C"
