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
// 3.35 TB/s. The arithmetic is one clamp per element.
//
// Design: one launch. Each thread loads four indices as one 16-byte word,
// looks the four up in shared memory and stores one 16-byte word, so a
// warp's global loads and stores are 512 contiguous bytes. Blocks stride
// over the vectors so that a block's table copy is spread over several
// vectors per thread; the grid is capped at the blocks the card can hold at
// once for this table size. A ragged tail (n % 4) and unaligned pointers go
// through a scalar loop. Random indices conflict on shared-memory banks;
// that is inherent in the lookup. Tables above 48 KB opt in to the larger
// dynamic shared memory; the limit is 232,448 bytes (58,112 entries), and
// the host function refuses a longer table instead of reading it from
// global memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;        // aimed-at 16-byte words per thread
constexpr int kMaxBlocksPerSm = 8;       // 2048 threads per SM / kThreads
constexpr int kMaxSharedBytes = 232448;  // 227 KB: a block's limit on sm_90
constexpr int kOptInAbove = 48 * 1024;

__device__ __forceinline__ int clampi(int i, int hi) {
  return min(max(i, 0), hi);
}

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const int* __restrict__ table, int table_len,
                  const int* __restrict__ idx, int* __restrict__ out,
                  long long n, long long n_vec) {
  extern __shared__ int tbl[];
  for (int i = threadIdx.x; i < table_len; i += kThreads)
    tbl[i] = __ldg(table + i);
  __syncthreads();

  const int hi = table_len - 1;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long v = t; v < n_vec; v += stride) {
    const int4 i4 = __ldg(idx4 + v);
    int4 o;
    o.x = tbl[clampi(i4.x, hi)];
    o.y = tbl[clampi(i4.y, hi)];
    o.z = tbl[clampi(i4.z, hi)];
    o.w = tbl[clampi(i4.w, hi)];
    out4[v] = o;
  }
  for (long long p = 4 * n_vec + t; p < n; p += stride)
    out[p] = tbl[clampi(__ldg(idx + p), hi)];
}

}  // namespace

extern "C" {

// Longest table (entries) jt_take_table accepts.
int jt_take_table_max_entries() { return kMaxSharedBytes / 4; }

// out[i] = table[clamp(idx[i])] for n contiguous int32 indices on device
// `device`. Launches on `stream`, does not synchronise, returns the CUDA
// error of the launch (cudaErrorInvalidValue for a table that does not fit).
int jt_take_table(const void* table, int table_len, const void* idx, void* out,
                  long long n, int device, void* stream) {
  if (table_len < 1 || table_len > kMaxSharedBytes / 4 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int shared_bytes = table_len * 4;
  if (shared_bytes > kOptInAbove) {
    err = cudaFuncSetAttribute(gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const long long n_vec = aligned ? n / 4 : 0;
  const long long work = n_vec > 0 ? n_vec : n;  // loop trips of the longer loop
  const long long per_block = static_cast<long long>(kThreads) * kVecsPerThread;
  long long blocks = (work + per_block - 1) / per_block;
  int resident = kMaxSharedBytes / shared_bytes;
  if (resident > kMaxBlocksPerSm) resident = kMaxBlocksPerSm;
  const long long cap = static_cast<long long>(sms) * resident;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  gather_kernel<<<static_cast<unsigned>(blocks), kThreads, shared_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), table_len, static_cast<const int*>(idx),
      static_cast<int*>(out), n, n_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
