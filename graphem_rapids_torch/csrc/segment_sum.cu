// Deterministic row sums: out[ids[j]] += values[j], each row's terms added
// in ascending j.
//
// Port-only: no Pallas kernel. It takes the place of the XLA scatter-adds
// of the JAX package's step ops and spectral init (`jax.ops.segment_sum`
// and `.at[].add`: graphem_rapids_tpu/ops/forces.py:1210 in
// `intersection_forces`, :922 in `apply_overflow_plan`, :1131 in
// `spring_forces`; graphem_rapids_tpu/ops/laplacian.py:116/:123), which
// XLA adds in a fixed order. PyTorch's `index_add_` on a card adds with
// float atomics, in an order that changes from run to run, so the same
// seed gave another layout.
//
// Semantics are those of `index_add_` on the CPU, whose loop adds a row's
// terms in ascending contribution order: each row's terms are added to the
// row's current value in that order, in fp32 with round-to-nearest
// (__fadd_rn). The result is the same on every run, and bit-equal to the
// CPU's index_add_ of the same terms.
//
// What bounds it on an H100: the bytes. Each id (4 or 8 bytes) and each
// value row (4 * d) is read once, and each touched row of out is read and
// written once; one add per term. At the intersection repulsion of the
// main path (30,720 terms of d = 3) that is under 1 MB, a fraction of a
// microsecond at 3.35 TB/s: the launches and the latency of the steps
// cost more than the work.
//
// Design. Two kernels. The terms come in T tiles of L <= 1024 consecutive
// terms, and `sort_tiles_kernel` sorts each tile in one block of 1024
// threads, one term a thread: a bitonic sort of (id << 32 | position in
// the tile), whose keys are distinct, so equal ids keep their term order;
// the stages within a warp exchange by shuffles, the 15 across warps
// through shared memory, one barrier each. The block then marks its tile
// in its ids' tile masks, W = ceil(T / 64) 64-bit words a row (bit t % 64
// of word t / 64; zeroed by the wrapper). Tile order is term order, so a
// row's terms in ascending order are its run in its first tile, then its
// run in the next tile of its mask, and so on. `segment_sum_kernel` runs
// one thread per sorted position: a thread whose key differs from the key
// before it in its tile starts a run, and the run in the row's first tile
// owns the row. The owner adds its own run, then takes the row's later
// tiles from its mask kBatch at a time, finds the row's run in each by
// binary searches in step, so that their loads are in flight together,
// and adds those runs in tile order, four columns at a time in registers,
// reading the keys and term ids of eight sorted positions at once and then
// the values of those in the run. Every other thread returns at once. A
// row is summed by one thread because the sum is sequential by
// definition: any split would round differently from the CPU's loop. A
// static plan's ids come sorted once as one tile, with no mask, and run
// no tile sort. Keys equal to the largest value of their type pad the
// last tile and are skipped.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // the wrapper's TILE: one term a thread
constexpr int kBatch = 4;  // binary searches in flight together
constexpr int kCols = 4;  // columns summed together, in registers
constexpr int kGroup = 8;  // terms of a run read together

template <typename K>
__host__ __device__ constexpr K pad_key() {
  return static_cast<K>(~(1ull << (8 * sizeof(K) - 1)));
}

// One block per tile t: terms [t * L, min((t + 1) * L, M)) sorted by id,
// ties in term order. keys (T * L,) get the ids (pad_key past M), perm
// (T * L,) each sorted position's place in its tile, and, where mask is
// not null, bit t % 64 of mask[id * W + t / 64] is set for each id of the
// tile.
template <typename I>
__global__ void __launch_bounds__(kTile)
    sort_tiles_kernel(const I* __restrict__ ids, long long M, int L,
                      int32_t* __restrict__ keys,
                      long long* __restrict__ perm,
                      unsigned long long* __restrict__ mask, int W) {
  __shared__ unsigned long long buf[2][kTile];
  const int j = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * L;
  unsigned long long id = static_cast<unsigned>(pad_key<int32_t>());
  if (j < L && base + j < M) id = static_cast<unsigned>(ids[base + j]);
  unsigned long long v = (id << 32) | static_cast<unsigned>(j);
  int b = 0;
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      unsigned long long w;
      if (h >= 32) {
        // two buffers in turn: the barrier of the next exchange through
        // shared memory separates this one's reads from its writes
        buf[b][j] = v;
        __syncthreads();
        w = buf[b][j ^ h];
        b ^= 1;
      } else {
        w = __shfl_xor_sync(0xffffffffu, v, h);
      }
      // the lower element of an ascending pair keeps the smaller
      const bool ascending = (j & k) == 0;
      const bool lower = (j & h) == 0;
      v = (lower == ascending) ? min(v, w) : max(v, w);
    }
  }
  buf[b][j] = v;
  __syncthreads();
  // real terms and the tile's pads (position < L) sort before the fill of
  // a short tile (position >= L)
  if (j < L) {
    const int32_t key = static_cast<int32_t>(v >> 32);
    keys[base + j] = key;
    perm[base + j] = static_cast<long long>(v & 0xffffffffull);
    if (mask != nullptr && key != pad_key<int32_t>() &&
        (j == 0 || static_cast<int32_t>(buf[b][j - 1] >> 32) != key)) {
      atomicOr(mask + static_cast<long long>(key) * W + (blockIdx.x >> 6),
               1ull << (blockIdx.x & 63));
    }
  }
}

// Adds to acc, columns [c0, c0 + nc), the terms of the run of `key` that
// starts at sorted position j of the tile at `base` (L keys), in order,
// and returns the run's end. A group of kGroup keys and their terms' ids
// is read at once, then the values of the group's terms in the run.
template <typename K>
__device__ __forceinline__ long long add_run(
    float (&acc)[kCols], int nc, const K* __restrict__ tile, long long L,
    K key, const long long* __restrict__ perm,
    const float* __restrict__ values, long long base, long long j, int d,
    int c0) {
  for (;; j += kGroup) {
    long long term[kGroup];
    int in_run = 0;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const long long at = j + g;
      const bool inside = at < L;
      const K k = inside ? tile[at] : pad_key<K>();
      term[g] = base + (perm != nullptr && inside ? perm[base + at] : at);
      if (in_run == g && k == key) in_run = g + 1;
    }
    float v[kGroup][kCols];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (g < in_run && c < nc) v[g][c] = values[term[g] * d + c0 + c];
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (g < in_run && c < nc) acc[c] = __fadd_rn(acc[c], v[g][c]);
      }
    }
    if (in_run < kGroup) return j + in_run;
  }
}

// One thread per sorted position of T tiles of L keys; `mask` (T > 1)
// holds each key's tiles, W words a key.
template <typename K>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const K* __restrict__ keys,
                       const long long* __restrict__ perm,
                       const unsigned long long* __restrict__ mask, int W,
                       const float* __restrict__ values,
                       float* __restrict__ out, int T, long long L, int d) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= T * L) return;
  const int t = static_cast<int>(p / L);
  const long long i = p - t * L;
  const K* tile = keys + t * L;
  const K key = tile[i];
  if (key == pad_key<K>() || (i > 0 && tile[i - 1] == key)) return;
  const unsigned long long* words = nullptr;
  if (mask != nullptr) {
    // the row's first tile: the lowest bit of its first nonzero word
    words = mask + static_cast<long long>(key) * W;
    int w = 0;
    while (words[w] == 0) ++w;
    if (64 * w + __ffsll(static_cast<long long>(words[w])) - 1 != t) return;
  }
  long long top = 1;
  while (top * 2 <= L) top *= 2;
  for (int c0 = 0; c0 < d; c0 += kCols) {
    const int nc = min(kCols, d - c0);
    float* dst = out + static_cast<long long>(key) * d + c0;
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) acc[c] = dst[c];
    }
    add_run(acc, nc, tile, L, key, perm, values, t * L, i, d, c0);
    if (words != nullptr) {
      // the later tiles of the mask, kBatch at a time in tile order: bits
      // above t in word t / 64, then the words after it
      int w = t >> 6;
      unsigned long long rest = words[w] & ~((2ull << (t & 63)) - 1);
      while (true) {
        int u[kBatch];
        long long at[kBatch];
        int got = 0;
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          while (rest == 0 && w + 1 < W) rest = words[++w];
          u[b] = -1;
          at[b] = 0;
          if (rest != 0) {
            u[b] = 64 * w + __ffsll(static_cast<long long>(rest)) - 1;
            rest &= rest - 1;
            ++got;
          }
        }
        if (got == 0) break;
        // at[b]: the number of keys below `key` in tile u[b]
        for (long long step = top; step > 0; step >>= 1) {
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            if (u[b] >= 0 && at[b] + step <= L &&
                keys[u[b] * L + at[b] + step - 1] < key) {
              at[b] += step;
            }
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (u[b] >= 0) {
            add_run(acc, nc, keys + u[b] * L, L, key, perm, values,
                    u[b] * L, at[b], d, c0);
          }
        }
        if (got < kBatch) break;
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) dst[c] = acc[c];
    }
  }
}

}  // namespace

// Sorts the (M,) ids, int32 (id_bytes 4) or int64 (8) in [0, 2^31 - 1),
// as T tiles of L <= 1024 consecutive terms (T * L >= M), each on
// `stream` by one block: keys (T * L,) int32 get each tile's ids in
// ascending order, equal ids in term order, and 2^31 - 1 past M; perm
// (T * L,) int64 each sorted position's place in its tile. With T > 1,
// mask (rows, W) 64-bit words, W = ceil(T / 64), zeroed by the caller, get
// bit t % 64 of word t / 64 for each id in tile t; with T == 1 it is null.
// Returns cudaGetLastError().
extern "C" int graphem_segment_sort_tiles_launch(
    const void* ids, int id_bytes, long long M, int T, int L, int32_t* keys,
    long long* perm, unsigned long long* mask, int W, void* stream) {
  if (M < 1 || T < 1 || L < 1 || L > kTile ||
      static_cast<long long>(T) * L < M ||
      (id_bytes != 4 && id_bytes != 8) ||
      ((T > 1) != (mask != nullptr)) || (T > 1 && W != (T + 63) / 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4) {
    sort_tiles_kernel<int32_t><<<T, kTile, 0, st>>>(
        static_cast<const int32_t*>(ids), M, L, keys, perm, mask, W);
  } else {
    sort_tiles_kernel<int64_t><<<T, kTile, 0, st>>>(
        static_cast<const int64_t*>(ids), M, L, keys, perm, mask, W);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the row sums on `stream` and returns cudaGetLastError() (0 on
// success). keys (T * L,) are T tiles of L, each sorted ascending, int32
// (key_bytes 4) or int64 (8), each in [0, rows of out) or the type's
// largest value (a pad, skipped); T > 1 takes the tile sort's mask
// (rows, W), W = ceil(T / 64), and T == 1 none (null). perm (T * L,)
// int64 gives the term of each sorted position within its tile (tile t's
// position j holds term t * L + perm[t * L + j]), or is null for terms in
// key order; values (terms, d) and out (rows, d) are contiguous fp32, and
// out is updated in place. The wrapper checks shapes, types and devices,
// and launches nothing without terms.
extern "C" int graphem_segment_sum_launch(const void* keys, int key_bytes,
                                          const long long* perm,
                                          const unsigned long long* mask,
                                          int W, const float* values,
                                          float* out, int T, long long L,
                                          int d, void* stream) {
  if (T < 1 || L < 1 || d < 1 || (key_bytes != 4 && key_bytes != 8) ||
      ((T > 1) != (mask != nullptr)) || (T > 1 && W != (T + 63) / 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (T * L + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (key_bytes == 4) {
    segment_sum_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(keys), perm, mask, W, values, out, T, L,
        d);
  } else {
    segment_sum_kernel<int64_t><<<grid, kThreads, 0, st>>>(
        static_cast<const int64_t*>(keys), perm, mask, W, values, out, T, L,
        d);
  }
  return static_cast<int>(cudaGetLastError());
}
