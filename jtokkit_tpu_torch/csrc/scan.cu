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
// Design: reduce-then-scan, three launches on the caller's stream.
//   1. reduce_kernel: one block per (tile, leaf) folds its tile of 4096 scan
//      positions to one aggregate, in scan order.
//   2. carry_kernel: one block per leaf scans the tile aggregates into each
//      tile's exclusive carry-in (tiles are in scan order, so reverse scans
//      need nothing special here).
//   3. scan_kernel: each block rescans its tile (thread-serial over 16
//      elements, warp shuffles over the 32 thread totals, shared memory over
//      the 8 warp totals) and folds in its carry-in.
// GPU blocks run in no order, so the carry between tiles is explicit (passes
// 1 and 2) instead of the TPU's sequential-grid scratch carry. This design
// reads the input twice (3*L*n*4 bytes); at the main path's sizes the input
// (at most 12.6 MB) stays in the 50 MB L2 between passes 1 and 3, which is
// what keeps the second read off device memory. A single-pass decoupled
// look-back would remove it. Tiles are staged through shared memory so that
// every global load and store is coalesced in both directions.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;     // scan positions per block
constexpr int kWarps = kThreads / 32;
constexpr int kPadded = kTile + kTile / 32;  // one pad word per 32 words
constexpr int kCarryThreads = 1024;
constexpr int kMaxLeaves = 4;
constexpr unsigned kFull = 0xffffffffu;

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

// Thread k reads words 16k..16k+15: padding one word per 32 spreads a warp's
// reads over all 32 banks.
__device__ __forceinline__ int pad(int s) { return s + (s >> 5); }

// Stage one tile (scan positions [tile*kTile, +kTile)) in scan order into
// shared memory; positions at or past n read as the identity.
template <int K>
__device__ __forceinline__ void load_tile(const int* __restrict__ x,
                                          long long n, bool reverse,
                                          long long tile, int* sm) {
  const long long base = tile * kTile;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int s = i * kThreads + threadIdx.x;
    const long long p = base + s;
    int v = ident<K>();
    if (p < n) v = __ldg(x + (reverse ? n - 1 - p : p));
    sm[pad(s)] = v;
  }
}

template <int K>
__device__ void reduce_body(const int* __restrict__ x, long long n,
                            bool reverse, int* agg, int* sm, int* warp_sm) {
  const long long tile = blockIdx.x;
  load_tile<K>(x, n, reverse, tile, sm);
  __syncthreads();
  int acc = ident<K>();
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    acc = combine<K>(acc, sm[pad(threadIdx.x * kItems + j)]);
  // ordered tree reduction: lane 0 ends with lanes 0..31 folded in order
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(kFull, acc, o);
    if (lane + o < 32) acc = combine<K>(acc, y);
  }
  if (lane == 0) warp_sm[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = ident<K>();
    for (int w = 0; w < kWarps; ++w) total = combine<K>(total, warp_sm[w]);
    agg[tile] = total;
  }
}

__global__ void __launch_bounds__(kThreads)
    reduce_kernel(Leaves lv, long long n, int reverse, int* agg,
                  long long n_tiles) {
  __shared__ int sm[kPadded];
  __shared__ int warp_sm[kWarps];
  const int leaf = blockIdx.y;
  int* a = agg + leaf * n_tiles;
  switch (lv.kind[leaf]) {
    case kMax: reduce_body<kMax>(lv.in[leaf], n, reverse, a, sm, warp_sm); break;
    case kLast: reduce_body<kLast>(lv.in[leaf], n, reverse, a, sm, warp_sm); break;
    default: reduce_body<kAdd>(lv.in[leaf], n, reverse, a, sm, warp_sm); break;
  }
}

// Exclusive scan of one leaf's tile aggregates, in chunks of kCarryThreads.
template <int K>
__device__ void carry_body(const int* agg, int* carry, long long n_tiles,
                           int* incl_sm, int* warp_sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int running = ident<K>();
  for (long long base = 0; base < n_tiles; base += kCarryThreads) {
    const long long t = base + threadIdx.x;
    int v = t < n_tiles ? agg[t] : ident<K>();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v = combine<K>(y, v);
    }
    if (lane == 31) warp_sm[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sm[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w = combine<K>(y, w);
      }
      warp_sm[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v = combine<K>(warp_sm[warp - 1], v);
    incl_sm[threadIdx.x] = v;
    __syncthreads();
    const int excl = threadIdx.x > 0 ? incl_sm[threadIdx.x - 1] : ident<K>();
    if (t < n_tiles) carry[t] = combine<K>(running, excl);
    running = combine<K>(running, incl_sm[kCarryThreads - 1]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kCarryThreads)
    carry_kernel(Leaves lv, const int* agg, int* carry, long long n_tiles) {
  __shared__ int incl_sm[kCarryThreads];
  __shared__ int warp_sm[32];
  const int leaf = blockIdx.x;
  const int* a = agg + leaf * n_tiles;
  int* c = carry + leaf * n_tiles;
  switch (lv.kind[leaf]) {
    case kMax: carry_body<kMax>(a, c, n_tiles, incl_sm, warp_sm); break;
    case kLast: carry_body<kLast>(a, c, n_tiles, incl_sm, warp_sm); break;
    default: carry_body<kAdd>(a, c, n_tiles, incl_sm, warp_sm); break;
  }
}

template <int K>
__device__ void scan_body(const int* __restrict__ x, int* __restrict__ out,
                          long long n, bool reverse, const int* carry,
                          int* sm, int* warp_sm, int* warp_incl) {
  const long long tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  load_tile<K>(x, n, reverse, tile, sm);
  __syncthreads();

  int vals[kItems];
  int acc = ident<K>();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    acc = combine<K>(acc, sm[pad(threadIdx.x * kItems + j)]);
    vals[j] = acc;
  }
  int w = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, w, o);
    if (lane >= o) w = combine<K>(y, w);
  }
  const int w_excl = __shfl_up_sync(kFull, w, 1);  // junk in lane 0
  if (lane == 31) warp_sm[warp] = w;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_sm[lane] : ident<K>();
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t = combine<K>(y, t);
    }
    if (lane < kWarps) warp_incl[lane] = t;
  }
  __syncthreads();

  int prefix = carry != nullptr ? carry[tile] : ident<K>();
  if (warp > 0) prefix = combine<K>(prefix, warp_incl[warp - 1]);
  if (lane > 0) prefix = combine<K>(prefix, w_excl);
  // each thread overwrites only the words it alone read
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    sm[pad(threadIdx.x * kItems + j)] = combine<K>(prefix, vals[j]);
  __syncthreads();

  const long long base = tile * kTile;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int s = i * kThreads + threadIdx.x;
    const long long p = base + s;
    if (p < n) out[reverse ? n - 1 - p : p] = sm[pad(s)];
  }
}

__global__ void __launch_bounds__(kThreads)
    scan_kernel(Leaves lv, long long n, int reverse, const int* carry,
                long long n_tiles) {
  __shared__ int sm[kPadded];
  __shared__ int warp_sm[kWarps];
  __shared__ int warp_incl[kWarps];
  const int leaf = blockIdx.y;
  const int* c = carry != nullptr ? carry + leaf * n_tiles : nullptr;
  const int* x = lv.in[leaf];
  int* o = lv.out[leaf];
  switch (lv.kind[leaf]) {
    case kMax: scan_body<kMax>(x, o, n, reverse, c, sm, warp_sm, warp_incl); break;
    case kLast: scan_body<kLast>(x, o, n, reverse, c, sm, warp_sm, warp_incl); break;
    default: scan_body<kAdd>(x, o, n, reverse, c, sm, warp_sm, warp_incl); break;
  }
}

}  // namespace

extern "C" {

// Scratch ints the caller allocates for jt_scan_leaves.
long long jt_scan_scratch_ints(int n_leaves, long long n) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  return n_tiles > 1 ? 2 * n_leaves * n_tiles : 0;
}

// Scan leaves in0..in{L-1} into out0..out{L-1} (each n contiguous int32 on
// device `device`). kinds packs 2 bits per leaf (0 max, 1 last, 2 add).
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int jt_scan_leaves(const void* in0, const void* in1, const void* in2,
                   const void* in3, void* out0, void* out1, void* out2,
                   void* out3, int n_leaves, long long n, int kinds,
                   int reverse, void* scratch, int device, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n < 1)
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
  const long long n_tiles = (n + kTile - 1) / kTile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_tiles), n_leaves);
  if (n_tiles > 1) {
    int* agg = static_cast<int*>(scratch);
    int* carry = agg + n_leaves * n_tiles;
    reduce_kernel<<<grid, kThreads, 0, st>>>(lv, n, reverse, agg, n_tiles);
    carry_kernel<<<n_leaves, kCarryThreads, 0, st>>>(lv, agg, carry, n_tiles);
    scan_kernel<<<grid, kThreads, 0, st>>>(lv, n, reverse, carry, n_tiles);
  } else {
    scan_kernel<<<grid, kThreads, 0, st>>>(lv, n, reverse, nullptr, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
