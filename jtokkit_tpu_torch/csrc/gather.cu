// Gather from a small int32 table held in on-chip memory, for Hopper
// (sm_90a): out[i] = table[clamp(idx[i], 0, table_len - 1)].
//
// Replaces the TPU kernel scripts/profile_gather.py::main -> pal (the
// pallas_call whose operands all sit in VMEM; wrapped here by
// jtokkit_tpu_torch/ops/gather.py::take_table). What that kernel computes is
// a lookup with the WHOLE table resident in fast memory for the whole call.
// Here every block copies the table into shared memory once and then walks
// its share of idx; the table is never read from global memory per lookup.
//
// Bound: bytes. 4 bytes read and 4 written per lookup plus the table once:
// 4.2 MB at 512 Ki lookups of a 2048-entry table, about 1.25 us at
// 3.35 TB/s. The arithmetic is one clamp per element. At that size the
// kernel is bound by latency, not by bytes: the card needs some 2 MB of
// loads in flight to run at its memory rate, so the design is about having
// them in flight early and all at once.
//
// Design: one launch.
//   - The table arrives by ONE asynchronous bulk copy (TMA's 1-D
//     cp.async.bulk, global to shared, completing on an mbarrier), started by
//     thread 0. Meanwhile every thread already loads its first index vectors
//     into registers; the wait on the barrier comes after those loads are
//     in flight. The copy moves whole 16-byte words from a 16-byte aligned
//     table; up to three last entries follow by plain loads. A table whose
//     pointer is not aligned, or that leaves no room for the barrier beside
//     it (over 58,108 entries), is copied by all threads with plain loads,
//     16 bytes each where the pointer allows.
//   - Each thread loads up to four independent 16-byte index vectors per
//     trip, then does all their lookups in shared memory, then stores four
//     16-byte words: the loads of a trip overlap instead of waiting on each
//     other. A warp's loads and stores are 512 contiguous bytes.
//   - Threads per block and the grid are chosen by the wrapper
//     (ops/gather.py::launch_plan) from the table's size: 256 threads and up
//     to 8 blocks an SM for small tables, whose copy is cheap, so that every
//     SM's 2,048 threads hold loads in flight; up to 1,024 threads where the
//     table lets only one or two blocks live on an SM, so that block still
//     has 32 warps to cover the memory latency. Blocks stride over the
//     vectors, so the table copy is paid once per resident block.
//   - A ragged tail (n % 4) and unaligned index or output pointers go
//     through a scalar loop. Random indices conflict on shared-memory banks;
//     that is inherent in the lookup. Tables above 48 KB opt in to the
//     larger dynamic shared memory; the limit is 232,448 bytes (58,112
//     entries), and the host function refuses a longer table instead of
//     reading it from global memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVecsPerTrip = 4;          // independent 16-byte loads per thread
constexpr int kMaxThreads = 1024;
constexpr int kMaxSharedBytes = 232448;  // 227 KB: a block's limit on sm_90
constexpr int kBarrierBytes = 16;        // the mbarrier's slot past the table
constexpr int kOptInAbove = 48 * 1024;

__device__ __forceinline__ int clampi(int i, int hi) {
  return min(max(i, 0), hi);
}

__device__ __forceinline__ int4 lookup4(const int* tbl, int4 i, int hi) {
  int4 o;
  o.x = tbl[clampi(i.x, hi)];
  o.y = tbl[clampi(i.y, hi)];
  o.z = tbl[clampi(i.z, hi)];
  o.w = tbl[clampi(i.w, hi)];
  return o;
}

// Thread 0: start the bulk copy of `bytes` (a multiple of 16) from `src` to
// the shared address `dst`, completing on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy_start(uint32_t dst, const void* src,
                                                uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Spin until the barrier's first phase (parity 0) has completed.
__device__ __forceinline__ void bulk_copy_wait(uint32_t bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(kMaxThreads)
    gather_kernel(const int* __restrict__ table, int table_len, int bulk_bytes,
                  const int* __restrict__ idx, int* __restrict__ out,
                  long long n, long long n_vec) {
  extern __shared__ __align__(16) int tbl[];
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const uint32_t tbl_addr = static_cast<uint32_t>(__cvta_generic_to_shared(tbl));
  const uint32_t bar = tbl_addr + ((table_len * 4 + 15) & ~15);

  int copied = bulk_bytes / 4;  // entries that need no plain load
  if (bulk_bytes > 0) {
    if (tid == 0) bulk_copy_start(tbl_addr, table, bulk_bytes, bar);
  } else if ((reinterpret_cast<uintptr_t>(table) & 15) == 0) {
    const int4* table4 = reinterpret_cast<const int4*>(table);
    int4* tbl4 = reinterpret_cast<int4*>(tbl);
    for (int i = tid; i < table_len / 4; i += n_threads)
      tbl4[i] = __ldg(table4 + i);
    copied = table_len & ~3;
  }
  for (int i = copied + tid; i < table_len; i += n_threads)
    tbl[i] = __ldg(table + i);

  const int hi = table_len - 1;
  const long long stride = static_cast<long long>(gridDim.x) * n_threads;
  const long long t = static_cast<long long>(blockIdx.x) * n_threads + tid;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);

  // the first trip's index vectors are in flight before the table is awaited
  int4 i4[kVecsPerTrip];
  long long v = t;
#pragma unroll
  for (int k = 0; k < kVecsPerTrip; ++k)
    if (v + k * stride < n_vec) i4[k] = __ldg(idx4 + v + k * stride);
  __syncthreads();  // plain-loaded entries and the barrier's init are visible
  if (bulk_bytes > 0) bulk_copy_wait(bar);

  while (v < n_vec) {
    int4 o[kVecsPerTrip];
#pragma unroll
    for (int k = 0; k < kVecsPerTrip; ++k)
      if (v + k * stride < n_vec) o[k] = lookup4(tbl, i4[k], hi);
#pragma unroll
    for (int k = 0; k < kVecsPerTrip; ++k)
      if (v + k * stride < n_vec) out4[v + k * stride] = o[k];
    v += kVecsPerTrip * stride;
#pragma unroll
    for (int k = 0; k < kVecsPerTrip; ++k)
      if (v + k * stride < n_vec) i4[k] = __ldg(idx4 + v + k * stride);
  }
  for (long long p = 4 * n_vec + t; p < n; p += stride)
    out[p] = tbl[clampi(__ldg(idx + p), hi)];
}

}  // namespace

extern "C" {

// Longest table (entries) jt_take_table accepts, and the longest it copies
// by the bulk copy (the barrier needs its slot beside the table).
int jt_take_table_max_entries() { return kMaxSharedBytes / 4; }
int jt_take_table_max_bulk_entries() {
  return (kMaxSharedBytes - kBarrierBytes) / 4;
}

// out[i] = table[clamp(idx[i])] for n contiguous int32 indices on device
// `device`, with the launch the wrapper planned: `threads` per block,
// `blocks`, `bulk_bytes` of the table by the bulk copy (0: plain loads) and
// `n_vec` 16-byte index vectors (0: scalar loop only). Launches on `stream`,
// does not synchronise, returns the CUDA error of the launch
// (cudaErrorInvalidValue for a table that does not fit or a plan the kernel
// cannot run).
int jt_take_table(const void* table, int table_len, const void* idx, void* out,
                  long long n, int threads, long long blocks, int bulk_bytes,
                  long long n_vec, int device, void* stream) {
  if (table_len < 1 || table_len > kMaxSharedBytes / 4 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int padded = (table_len * 4 + 15) & ~15;
  const int shared_bytes = bulk_bytes > 0 ? padded + kBarrierBytes : table_len * 4;
  const uintptr_t moved =
      reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      blocks < 1 || blocks > 0x7fffffffLL || bulk_bytes < 0 ||
      bulk_bytes % 16 != 0 || bulk_bytes > table_len * 4 ||
      (bulk_bytes > 0 && (reinterpret_cast<uintptr_t>(table) & 15) != 0) ||
      shared_bytes > kMaxSharedBytes || n_vec < 0 || 4 * n_vec > n ||
      (n_vec > 0 && (moved & 15) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared_bytes > kOptInAbove) {
    err = cudaFuncSetAttribute(gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_kernel<<<static_cast<unsigned>(blocks), threads, shared_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), table_len, bulk_bytes,
      static_cast<const int*>(idx), static_cast<int*>(out), n, n_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
