// Multi-leaf inclusive prefix scans over int32 streams, for Hopper (sm_90a).
//
// Replaces the TPU kernel jtokkit_tpu/ops/pallas_scan.py::_scan_stacked
// (wrapped by jtokkit_tpu_torch/ops/scan.py::scan_leaves). Up to four leaves
// of one length n are scanned per call, each with its own combine:
//   max  - running maximum
//   last - the latest value >= 0 in scan order wins (-1 = unset)
//   add  - running sum, wrapping like int32 addition
// and the scan runs forward or, with `reverse`, from the highest index down.
//
// Bound: the scan is memory-bound. It must read and write L*n*4 bytes each,
// 2*L*n*4 in all: 25.2 MB at L = 3, n = 2^20, about 7.5 us at 3.35 TB/s. Its
// arithmetic is a few integer operations per element.
//
// Design: a single-pass chained scan with decoupled look-back. One launch
// per call, every input word read once and every output word written once.
//   - A block takes one tile of 8192 positions of one leaf. It scans the
//     tile (thread-serial over 32 values, warp shuffles over the 32 thread
//     totals, one warp over the 8 warp totals), publishes the tile's
//     AGGREGATE, looks back over its predecessors' published words until it
//     meets an inclusive PREFIX, publishes its own inclusive prefix, folds
//     the carry-in into its values and stores them.
//   - A tile's status and value travel together in one 64-bit word
//     (epoch << 34 | flag << 32 | value): a value and a flag written apart
//     can be seen apart. The word is stored and loaded by strong accesses at
//     gpu scope (st.relaxed.gpu / ld.relaxed.gpu: coherent between SMs and
//     never torn). Nothing else passes between blocks, so there is no other
//     memory for a release or an acquire to order, and their fences cost
//     3-13 % of the kernel's time on the card (PERF.md).
//   - Tiles are handed out in scan order by an atomic ticket, not by
//     blockIdx: the hardware does not promise that block k starts before
//     block k + 1, and a block spinning on a predecessor that was never
//     scheduled would hang the card. Every tile a block waits on belongs to
//     a block that already runs.
//   - All leaves of a call share the launch AND the ticket counter: ticket t
//     is tile t / L of leaf t % L, so the leaves advance side by side, a
//     tile's predecessor holds a ticket L lower, and one counter serves any
//     number of leaves. Status words lie leaf-major (leaf * n_tiles + tile),
//     so a look-back window of 32 predecessors is 256 contiguous bytes.
//   - The look-back is warp-wide: lane i reads the word of predecessor
//     tile - 1 - i, the window ends at the newest prefix in it, and the
//     lanes up to there are folded by an ordered shuffle reduction. `last`
//     is not commutative, so older words always enter on the left:
//     acc = combine(window, acc).
//   - The scratch (counter + status words) is persistent, one per device and
//     stream, kept by the wrapper; a call allocates and clears nothing. Word
//     0 holds (epoch << 32 | next ticket). A status word counts only if it
//     carries the call's epoch and a flag, so what an earlier call left
//     behind reads as "not ready". The block that draws the last ticket
//     rewrites the counter to (epoch + 1) << 32: every ticket of the call is
//     taken by then, so nothing else touches the counter before the next
//     call on the stream. Status words keep 30 bits of the epoch; the
//     wrapper zeroes them once in 2^30 - 1 calls, before a stale word could
//     pass for a current one. Two streams never share a scratch.
//   - Global loads and stores are 16 bytes a thread and coalesced in both
//     directions: each warp owns a contiguous span of 1024 words, loads it as
//     256 int4 striped over its lanes (eight loads in flight per thread), and
//     turns it through (padded) shared memory so that each lane holds 32
//     consecutive scan positions; results
//     go back the same way. Tiles are aligned in MEMORY: a reverse scan
//     walks the memory tiles from the last down, reads each span forwards
//     and reverses it while turning it, so the ragged tile comes first in a
//     reverse scan and last in a forward one. Positions at or past n read as
//     the identity. A 16-byte word that straddles n, and every word of a
//     leaf whose pointer is not 16-byte aligned, moves as four 4-byte words.
//   - The tile is a compromise found on the card: 8192 positions keep the
//     look-back short at n = 2^24 (2048 tiles a leaf) and put 128 bytes of
//     loads in flight per thread, while n = 2^15 at two leaves still makes 8
//     blocks; 71 registers a thread leave 3 blocks an SM.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 32;                 // scan positions per thread
constexpr int kVecs = kItems / 4;          // 16-byte words per thread
constexpr int kTile = kThreads * kItems;   // scan positions per block
constexpr int kWarps = kThreads / 32;
constexpr int kSpanVecs = 32 * kVecs;      // 16-byte words per warp span
constexpr int kSpanPadded = kSpanVecs + kSpanVecs / 8;
constexpr int kMaxLeaves = 4;
constexpr int kHeaderWords = 2;            // counter + one pad word
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEpochMask = (1u << 30) - 1u;
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

enum Kind { kMax = 0, kLast = 1, kAdd = 2 };

struct Leaves {
  const int* in[kMaxLeaves];
  int* out[kMaxLeaves];
  int kind[kMaxLeaves];
};

// max takes INT_MIN, its true identity, so the kernel equals a cumulative
// maximum on any input; on the path's leaves (values >= -1) that is the same
// as the TPU kernel's -1.
template <int K>
__device__ __forceinline__ int ident() {
  return K == kAdd ? 0 : (K == kMax ? INT_MIN : -1);
}

// `earlier` precedes `later` in scan order.
template <int K>
__device__ __forceinline__ int combine(int earlier, int later) {
  if (K == kMax) return max(earlier, later);
  if (K == kLast) return later >= 0 ? later : earlier;
  return static_cast<int>(static_cast<unsigned>(earlier) +
                          static_cast<unsigned>(later));
}

// One pad word per eight 16-byte words: both the striped and the turned
// access of a warp then touch every bank group once per quarter warp.
__device__ __forceinline__ int padq(int q) { return q + (q >> 3); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ unsigned long long pack(unsigned epoch,
                                                   unsigned long long flag,
                                                   int value) {
  return (static_cast<unsigned long long>(epoch) << 34) | (flag << 32) |
         static_cast<unsigned>(value);
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Exclusive carry-in of `tile` (> 0): the fold, in scan order, of every
// earlier tile of the leaf. Run by one whole warp; every lane returns it.
template <int K>
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         long long tile, unsigned epoch,
                                         int lane) {
  int acc = ident<K>();
  long long pred = tile - 1 - lane;  // lane 0 reads the newest predecessor
  for (;;) {
    const bool valid = pred >= 0;
    unsigned long long w = 0;
    unsigned prefixes, need;
    for (;;) {
      if (valid) w = ld_status(status + pred);
      const unsigned flag = static_cast<unsigned>(w >> 32) & 3u;
      const bool ready =
          valid && flag != 0 && static_cast<unsigned>(w >> 34) == epoch;
      const unsigned readies = __ballot_sync(kFull, ready);
      prefixes = __ballot_sync(kFull, ready && flag == kPrefix);
      // the window ends at its newest prefix; tile 0 always publishes one,
      // so lanes past the start of the leaf are never needed
      need = prefixes ? (2u << (__ffs(prefixes) - 1)) - 1u : kFull;
      if ((need & ~readies) == 0) break;
    }
    int v = (need >> lane) & 1u ? static_cast<int>(static_cast<unsigned>(w))
                                : ident<K>();
    // ordered tree reduction: a higher lane holds an EARLIER tile
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(kFull, v, o);
      if (lane + o < 32) v = combine<K>(y, v);
    }
    acc = combine<K>(__shfl_sync(kFull, v, 0), acc);
    if (prefixes) return acc;
    pred -= 32;
  }
}

template <int K>
__device__ __forceinline__ void scan_tile(
    const int* __restrict__ x, int* __restrict__ out, long long n,
    bool reverse, unsigned long long* status, long long tile,
    long long n_tiles, unsigned epoch, int4* stage, int* warp_tot,
    int* warp_incl, int* block_excl) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long mem_tile = reverse ? n_tiles - 1 - tile : tile;
  const int span = reverse ? kWarps - 1 - warp : warp;
  const long long span_base =
      mem_tile * kTile + static_cast<long long>(span) * (kSpanVecs * 4);
  int4* my = stage + warp * kSpanPadded;
  const bool vec_in = aligned16(x);
  const bool vec_out = aligned16(out);
  const int id = ident<K>();

  // the warp's span, forwards, striped over the lanes
  int4 v[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long e = span_base + 4 * (i * 32 + lane);
    if (vec_in && e + 3 < n) {
      v[i] = __ldg(reinterpret_cast<const int4*>(x + e));
    } else {
      v[i].x = e < n ? __ldg(x + e) : id;
      v[i].y = e + 1 < n ? __ldg(x + e + 1) : id;
      v[i].z = e + 2 < n ? __ldg(x + e + 2) : id;
      v[i].w = e + 3 < n ? __ldg(x + e + 3) : id;
    }
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) my[padq(i * 32 + lane)] = v[i];
  __syncwarp();

  // turned: this lane's consecutive scan positions, scanned serially
  int vals[kItems];
#pragma unroll
  for (int m = 0; m < kVecs; ++m) {
    const int qq = kVecs * lane + m;
    const int4 w = my[padq(reverse ? kSpanVecs - 1 - qq : qq)];
    vals[4 * m + 0] = reverse ? w.w : w.x;
    vals[4 * m + 1] = reverse ? w.z : w.y;
    vals[4 * m + 2] = reverse ? w.y : w.z;
    vals[4 * m + 3] = reverse ? w.x : w.w;
  }
  int acc = id;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    acc = combine<K>(acc, vals[j]);
    vals[j] = acc;
  }
  int t = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, t, o);
    if (lane >= o) t = combine<K>(y, t);
  }
  const int lane_excl = __shfl_up_sync(kFull, t, 1);  // junk in lane 0
  if (lane == 31) warp_tot[warp] = t;
  __syncthreads();

  if (warp == 0) {
    int wt = lane < kWarps ? warp_tot[lane] : id;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wt, o);
      if (lane >= o) wt = combine<K>(y, wt);
    }
    if (lane < kWarps) warp_incl[lane] = wt;
    const int aggregate = __shfl_sync(kFull, wt, kWarps - 1);
    int excl = id;
    if (tile == 0) {
      if (lane == 0 && n_tiles > 1)
        st_status(status, pack(epoch, kPrefix, aggregate));
    } else {
      if (lane == 0)
        st_status(status + tile, pack(epoch, kAggregate, aggregate));
      excl = look_back<K>(status, tile, epoch, lane);
      if (lane == 0 && tile + 1 < n_tiles)
        st_status(status + tile,
                   pack(epoch, kPrefix, combine<K>(excl, aggregate)));
    }
    if (lane == 0) *block_excl = excl;
  }
  __syncthreads();

  int prefix = *block_excl;
  if (warp > 0) prefix = combine<K>(prefix, warp_incl[warp - 1]);
  if (lane > 0) prefix = combine<K>(prefix, lane_excl);
#pragma unroll
  for (int j = 0; j < kItems; ++j) vals[j] = combine<K>(prefix, vals[j]);

  // back through the slots this lane alone read, then striped to memory
#pragma unroll
  for (int m = 0; m < kVecs; ++m) {
    const int qq = kVecs * lane + m;
    int4 w;  // selects on values: a runtime index would put vals in local memory
    w.x = reverse ? vals[4 * m + 3] : vals[4 * m + 0];
    w.y = reverse ? vals[4 * m + 2] : vals[4 * m + 1];
    w.z = reverse ? vals[4 * m + 1] : vals[4 * m + 2];
    w.w = reverse ? vals[4 * m + 0] : vals[4 * m + 3];
    my[padq(reverse ? kSpanVecs - 1 - qq : qq)] = w;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long e = span_base + 4 * (i * 32 + lane);
    const int4 w = my[padq(i * 32 + lane)];
    if (vec_out && e + 3 < n) {
      *reinterpret_cast<int4*>(out + e) = w;
    } else {
      if (e < n) out[e] = w.x;
      if (e + 1 < n) out[e + 1] = w.y;
      if (e + 2 < n) out[e + 2] = w.z;
      if (e + 3 < n) out[e + 3] = w.w;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    scan_lookback_kernel(Leaves lv, long long n, int reverse,
                         unsigned long long* scratch, long long n_tiles,
                         int n_leaves) {
  __shared__ int4 stage[kWarps * kSpanPadded];
  __shared__ int warp_tot[kWarps];
  __shared__ int warp_incl[kWarps];
  __shared__ int block_excl;
  __shared__ unsigned long long drawn;

  if (threadIdx.x == 0) {
    const unsigned long long total =
        static_cast<unsigned long long>(n_tiles) * n_leaves;
    const unsigned long long t = atomicAdd(scratch, 1ULL);
    drawn = t;
    // the last ticket of the call: hand the next call a new epoch and ticket 0
    if ((t & 0xffffffffULL) == total - 1)
      atomicExch(scratch, ((t >> 32) + 1ULL) << 32);
  }
  __syncthreads();
  const unsigned long long ticket = drawn & 0xffffffffULL;
  const unsigned epoch = static_cast<unsigned>(drawn >> 32) & kEpochMask;
  const int leaf = static_cast<int>(ticket % n_leaves);
  const long long tile = static_cast<long long>(ticket / n_leaves);

  unsigned long long* status = scratch + kHeaderWords + leaf * n_tiles;
  // constant indices keep the parameter struct out of local memory
  const int* x = leaf == 0 ? lv.in[0] : leaf == 1 ? lv.in[1] : leaf == 2 ? lv.in[2] : lv.in[3];
  int* o = leaf == 0 ? lv.out[0] : leaf == 1 ? lv.out[1] : leaf == 2 ? lv.out[2] : lv.out[3];
  const int kind = leaf == 0 ? lv.kind[0] : leaf == 1 ? lv.kind[1] : leaf == 2 ? lv.kind[2] : lv.kind[3];
  const bool rev = reverse != 0;
  switch (kind) {
    case kMax:
      scan_tile<kMax>(x, o, n, rev, status, tile, n_tiles, epoch, stage,
                      warp_tot, warp_incl, &block_excl);
      break;
    case kLast:
      scan_tile<kLast>(x, o, n, rev, status, tile, n_tiles, epoch, stage,
                       warp_tot, warp_incl, &block_excl);
      break;
    default:
      scan_tile<kAdd>(x, o, n, rev, status, tile, n_tiles, epoch, stage,
                      warp_tot, warp_incl, &block_excl);
      break;
  }
}

}  // namespace

extern "C" {

// Scan positions per tile, and the scratch's leading words that are not
// status words: the wrapper sizes the scratch as
// header + n_leaves * ceil(n / tile) 64-bit words, zeroed once.
int jt_scan_tile() { return kTile; }
int jt_scan_header_words() { return kHeaderWords; }

// Scan leaves in0..in{L-1} into out0..out{L-1} (each n contiguous int32 on
// device `device`). kinds packs 2 bits per leaf (0 max, 1 last, 2 add).
// `scratch` is this stream's persistent scratch of `scratch_words` 64-bit
// words. One launch on `stream`; does not synchronise; returns
// cudaGetLastError().
int jt_scan_leaves(const void* in0, const void* in1, const void* in2,
                   const void* in3, void* out0, void* out1, void* out2,
                   void* out3, int n_leaves, long long n, int kinds,
                   int reverse, void* scratch, long long scratch_words,
                   int device, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long total = n_tiles * n_leaves;
  if (total > INT_MAX || scratch == nullptr ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0 ||
      scratch_words < kHeaderWords + total)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Leaves lv;
  const void* ins[kMaxLeaves] = {in0, in1, in2, in3};
  void* outs[kMaxLeaves] = {out0, out1, out2, out3};
  for (int l = 0; l < kMaxLeaves; ++l) {
    lv.in[l] = static_cast<const int*>(ins[l]);
    lv.out[l] = static_cast<int*>(outs[l]);
    lv.kind[l] = (kinds >> (2 * l)) & 3;
  }
  scan_lookback_kernel<<<static_cast<unsigned>(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, n, reverse, static_cast<unsigned long long*>(scratch), n_tiles,
      n_leaves);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
