// The byte-pair merge of one Stage B bucket, every piece merged to its end
// in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel. It is the counterpart of the JAX package's XLA
// while loop around merge_rows_t3 (jtokkit_tpu/ops/merge.py), which runs
// the merge as global rounds over a [lanes, cap] matrix, one merge a piece a
// round, because that is how a loop fits into XLA. The merge of one piece
// depends on no other piece, so here each piece (a column of the matrix)
// runs the reference's sequential min-rank merge
// (M/GptBytePairEncoding.java:200-275) to its end on its own: no global
// round, no read by the host. Wrapped by
// jtokkit_tpu_torch/ops/merge.py::merge_rows_t3 (and merge_rows, the
// long-piece fallback's, over the transposed matrix), which keeps the round
// loop as the plain version.
//
// Semantics, bit for bit those of the plain loop: ids[w, r] and active[w, r]
// for every lane w < lanes of every column r < cap, the ids left at lanes
// that went inactive included, -1 and inactive past a piece's length. A
// merge takes the leftmost pair of least rank, gives the left span the
// merged id (rank == id in tiktoken vocabularies), drops the right span and
// looks up the two affected neighbour ranks in the two cuckoo halves of
// pair_rows_cat. `limit` caps the merges of each piece: after k global
// rounds each piece has made min(k, its merges) merges, so limit k equals k
// rounds of the loop. `rounds` (optional, zeroed by the caller) receives by
// atomicMax the most merges any piece made: the rounds the global loop
// would have run.
//
// Bound: latency, not bytes. A piece's merges form a chain, each waiting on
// two 16-byte row loads from the cuckoo table (4 MB for r50k, 8 MB for
// cl100k: L2-resident) and on the minimum of its ranks; the kernel's time is
// the longest piece's chain, about a microsecond a merge (403 merges in
// 0.48 ms on an H100). The bytes (the bucket's matrix in, ids and active
// lanes out) take 0.00002-0.004 ms at 3.35 TB/s.
//
// Design: one algorithm, its mapping taken from the bucket's width.
//   - A group of G threads merges one piece; G = 1, 2, 4 for 8, 16, 32
//     lanes (a thread, or a few, per piece: neighbouring columns sit in
//     neighbouring threads, so a warp's loads of the matrix are coalesced),
//     G = 32 (a warp) from 64 lanes up. Each thread owns S = lanes / G
//     positions, p = j * G + t.
//   - The piece's spans live in shared memory as a doubly-linked list
//     (int16 next and prev, prev = -2 for a span merged away) beside each
//     span's id and the key of its pair: (rank << 12) | position, or
//     0xFFFFFFFF where no pair merges. The least key is the leftmost least
//     rank, exactly. Slot of position p: (p / G) * BLOCK + group * G + p % G,
//     so a warp's threads touch consecutive words at every step.
//   - Each thread keeps the least key of its own positions in a register. A
//     merge is a group minimum by shuffles, the leader's four row loads (both
//     sites, both cuckoo halves, issued together) and its updates of the
//     list, then only the owners of the three positions that changed scan
//     their S keys again.
//   - Blocks of 128 threads where S <= 16 (up to 24 KB of shared memory),
//     of one warp beyond (the 4096-lane bucket: 48 KB, 128 positions a
//     thread).
// The key packs ranks below 2^20 - 1; the wrapper refuses tables with
// larger ranks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRank = 0x7FFFFFFF;       // the plain version's "no pair"
constexpr unsigned kNoKey = 0xFFFFFFFFu;   // key of a span whose pair does not merge
constexpr int kPosBits = 12;
constexpr int kMaxLanes = 1 << kPosBits;
constexpr int kKeyRankLimit = (1 << (32 - kPosBits)) - 1;  // ranks below it pack
constexpr short kGone = -2;                // prev of a span merged away
constexpr int kBytesPerSlot = 4 + 4 + 2 + 2;  // key, id, next, prev
constexpr int kDefaultSharedBytes = 48 * 1024;

// the two cuckoo hashes (ops/stage4.py::_mix with merge.py's _H1, _H2)
__device__ __forceinline__ unsigned mix(unsigned u, unsigned v, unsigned a,
                                        unsigned b, unsigned c, unsigned mask) {
  unsigned h = (u * a) ^ (v * b);
  h ^= h >> 15;
  h *= c;
  h ^= h >> 13;
  return h & mask;
}

// (u, v) -> merged id, or kMaxRank: both halves of the stacked table read
// unconditionally (their indices are masked), the second half winning a tie
// as in merge.py::pair_lookup_cat.
__device__ __forceinline__ int lookup(int u, int v, const int4* __restrict__ rows,
                                      unsigned mask) {
  const unsigned uu = static_cast<unsigned>(u), vv = static_cast<unsigned>(v);
  const int4 r1 = __ldg(rows + mix(uu, vv, 0x9E3779B1u, 0x85EBCA77u, 0x2C1B3C6Du, mask));
  const int4 r2 = __ldg(rows + (mask + 1) +
                        mix(uu, vv, 0xC2B2AE3Du, 0x27D4EB2Fu, 0x165667B1u, mask));
  int out = -1;
  if (r1.x == u && r1.y == v) out = r1.z;
  if (r2.x == u && r2.y == v) out = r2.z;
  return out < 0 ? kMaxRank : out;
}

__device__ __forceinline__ unsigned make_key(int rank, int p) {
  return rank == kMaxRank ? kNoKey
                          : (static_cast<unsigned>(rank) << kPosBits) | static_cast<unsigned>(p);
}

template <int G>
__device__ __forceinline__ unsigned group_min(unsigned v, unsigned gmask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(gmask, v, off, G));
  return v;
}

template <int G, int S, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
merge_t3_kernel(const uint8_t* __restrict__ mat, const int* __restrict__ lens,
                const int* __restrict__ byte_to_id, const int* __restrict__ byte_pair_id,
                const int4* __restrict__ rows, unsigned mask, int lanes, long long cap,
                int limit, int* __restrict__ ids_out, bool* __restrict__ active_out,
                int* rounds_out) {
  constexpr int kGroups = BLOCK / G;
  constexpr int kSlots = S * BLOCK;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* key = reinterpret_cast<unsigned*>(smem);
  int* ids = reinterpret_cast<int*>(key + kSlots);
  short* nxt = reinterpret_cast<short*>(ids + kSlots);
  short* prv = nxt + kSlots;

  const int g = threadIdx.x / G;
  const int t = threadIdx.x % G;
  const long long r = static_cast<long long>(blockIdx.x) * kGroups + g;
  if (r >= cap) return;  // the whole group leaves together
  const unsigned gmask =
      G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const int own = g * G + t;  // slot of this thread's position j * G + t is j * BLOCK + own
  auto slot = [&](int p) { return (p / G) * BLOCK + g * G + (p % G); };
  const int len = min(max(lens[r], 0), lanes);

  // seed: single-byte spans, each pair's rank from the 64 K byte-pair table
  unsigned best = kNoKey;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int p = j * G + t;
    const int s = j * BLOCK + own;
    int id = -1;
    unsigned k = kNoKey;
    short nx = -1, pv = kGone;
    if (p < len) {
      const int b = mat[p * cap + r];
      id = __ldg(byte_to_id + b);
      pv = static_cast<short>(p - 1);
      if (p + 1 < len) {
        const int rank = __ldg(byte_pair_id + b * 256 + mat[(p + 1) * cap + r]);
        if (rank >= 0) k = make_key(rank, p);
        nx = static_cast<short>(p + 1);
      }
    }
    key[s] = k;
    ids[s] = id;
    nxt[s] = nx;
    prv[s] = pv;
    best = min(best, k);
  }
  if (G > 1) __syncwarp(gmask);

  int done = 0;
  while (done < limit) {
    const unsigned k = group_min<G>(best, gmask);
    if (k == kNoKey) break;
    const int m = static_cast<int>(k & (kMaxLanes - 1));
    const int rk = static_cast<int>(k >> kPosBits);
    int nx = 0, pv = 0;
    if (t == 0) {
      const int sm = slot(m);
      nx = nxt[sm];
      pv = prv[sm];
      const int snx = slot(nx);
      const int nx2 = nxt[snx];
      const int id_nx2 = nx2 >= 0 ? ids[slot(nx2)] : kMaxRank;
      const int id_pv = pv >= 0 ? ids[slot(pv)] : kMaxRank;
      const int rank_m = lookup(rk, id_nx2, rows, mask);
      const int rank_pv = lookup(id_pv, rk, rows, mask);
      ids[sm] = rk;
      key[sm] = nx2 >= 0 ? make_key(rank_m, m) : kNoKey;
      if (pv >= 0) key[slot(pv)] = make_key(rank_pv, pv);
      key[snx] = kNoKey;
      nxt[sm] = static_cast<short>(nx2);
      if (nx2 >= 0) prv[slot(nx2)] = static_cast<short>(m);
      prv[snx] = kGone;
    }
    if (G > 1) {
      nx = __shfl_sync(gmask, nx, 0, G);
      pv = __shfl_sync(gmask, pv, 0, G);
      __syncwarp(gmask);
    }
    // the owners of the three changed positions take their least key again
    if (m % G == t || nx % G == t || (pv >= 0 && pv % G == t)) {
      best = kNoKey;
#pragma unroll 8
      for (int j = 0; j < S; ++j) best = min(best, key[j * BLOCK + own]);
    }
    ++done;
  }
  if (t == 0 && rounds_out != nullptr && done > 0) atomicMax(rounds_out, done);
  if (G > 1) __syncwarp(gmask);

#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int p = j * G + t;
    if (p < lanes) {
      const int s = j * BLOCK + own;
      ids_out[p * cap + r] = ids[s];
      active_out[p * cap + r] = prv[s] != kGone;
    }
  }
}

struct Args {
  const uint8_t* mat;
  const int* lens;
  const int* byte_to_id;
  const int* byte_pair_id;
  const int4* rows;
  unsigned mask;
  int lanes;
  long long cap;
  int limit;
  int* ids;
  bool* active;
  int* rounds;
};

template <int G, int S>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kBlock = S <= 16 ? 128 : 32;
  constexpr int kGroups = kBlock / G;
  const int shared = S * kBlock * kBytesPerSlot;
  auto kernel = merge_t3_kernel<G, S, kBlock>;
  if (shared > kDefaultSharedBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (a.cap + kGroups - 1) / kGroups;
  kernel<<<static_cast<unsigned>(blocks), kBlock, shared, stream>>>(
      a.mat, a.lens, a.byte_to_id, a.byte_pair_id, a.rows, a.mask, a.lanes, a.cap,
      a.limit, a.ids, a.active, a.rounds);
  return cudaGetLastError();
}

// threads a piece for a bucket of `lanes` (0: no mapping)
int group_for(int lanes) {
  if (lanes < 1 || lanes > kMaxLanes) return 0;
  return lanes <= 8 ? 1 : lanes <= 16 ? 2 : lanes <= 32 ? 4 : 32;
}

}  // namespace

extern "C" {

// Widest bucket, and the bound on ranks that the key packs.
int jt_merge_max_lanes() { return kMaxLanes; }
int jt_merge_key_rank_limit() { return kKeyRankLimit; }

// Merge every column of mat (uint8[lanes, cap], column r holds piece r's
// lens[r] <= lanes bytes) to its end, or to `limit` merges, into ids
// (int32[lanes, cap]) and active (bool[lanes, cap]); where `rounds` is not
// null, atomicMax of the most merges of a piece into *rounds (zeroed by the
// caller). `pair_rows` is the stacked cuckoo table int32[2 (mask + 1), 4],
// 16-byte aligned. Launches on `stream`, does not synchronise; returns the
// CUDA error of the launch (cudaErrorInvalidValue for a shape it does not
// take).
int jt_merge_t3(const void* mat, const void* lens, const void* byte_to_id,
                const void* byte_pair_id, const void* pair_rows, int table_mask,
                int lanes, long long cap, int limit, void* ids, void* active,
                void* rounds, int device, void* stream) {
  const int G = group_for(lanes);
  if (G == 0 || cap < 1 || cap > (1LL << 31) - 1 || limit < 0 || table_mask < 0 ||
      (reinterpret_cast<uintptr_t>(pair_rows) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const uint8_t*>(mat), static_cast<const int*>(lens),
               static_cast<const int*>(byte_to_id), static_cast<const int*>(byte_pair_id),
               static_cast<const int4*>(pair_rows), static_cast<unsigned>(table_mask),
               lanes, cap, limit, static_cast<int*>(ids), static_cast<bool*>(active),
               static_cast<int*>(rounds)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 1) return static_cast<int>(launch<1, 8>(a, s));
  if (G == 2) return static_cast<int>(launch<2, 8>(a, s));
  if (G == 4) return static_cast<int>(launch<4, 8>(a, s));
  if (lanes <= 64) return static_cast<int>(launch<32, 2>(a, s));
  if (lanes <= 128) return static_cast<int>(launch<32, 4>(a, s));
  if (lanes <= 256) return static_cast<int>(launch<32, 8>(a, s));
  if (lanes <= 384) return static_cast<int>(launch<32, 12>(a, s));
  if (lanes <= 512) return static_cast<int>(launch<32, 16>(a, s));
  if (lanes <= 1024) return static_cast<int>(launch<32, 32>(a, s));
  if (lanes <= 2048) return static_cast<int>(launch<32, 64>(a, s));
  return static_cast<int>(launch<32, 128>(a, s));
}

}  // extern "C"
