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
// CPU's index_add_ of the same terms. A row is summed by one thread because
// the sum is sequential by definition: any split would round differently
// from the CPU's loop.
//
// What bounds it on an H100: the bytes. Each id (4 or 8 bytes) and each
// value row (4 * d) is read once, and each touched row of out is read and
// written once; one add per term. At the intersection repulsion of the
// main path (30,720 terms of d = 3) that is under 1 MB, a fraction of a
// microsecond at 3.35 TB/s: launches, barriers and the latency of chains
// of dependent reads cost more than the work, so the design counts
// barriers and round trips.
//
// Which kernel runs, by the number of terms M of a dynamic call:
//
// - M up to the capacity of one cluster (kCluster = 16 blocks of kItems *
//   kClusterThreads = 8,192 keys: 131,072 on an H100, as far as the card's
//   shared memory a block allows; every call of the engines' steps):
//   `cluster_sum_kernel`, one launch of up to kMaxClusters thread-block
//   clusters of 16 blocks (non-portable size), as many as the card runs at
//   once (7 on an H100): one cluster of 8 or 16 SMs is too narrow for a
//   step's ~15,000 scattered rows and its latency-bound passes. Cluster g
//   takes the rows of one range [g * span, g * span + span), so that every
//   row belongs to one cluster and the clusters work apart; the wrapper works
//   out the ranges and digits. Its block b reads terms [b * M / 16, ...) of
//   all M as packed keys (row << 32 | term) and keeps those of its rows. An
//   LSD radix sort by the digits of the row's offset in the range (as few
//   passes of at most 10 bits as the range needs: two at 100K and 1M rows)
//   puts the cluster's keys in one stable order by row across its blocks'
//   shared memory: each pass ranks a block's keys stably per warp (the lanes
//   of a digit found by a ballot a bit; each warp its own digit counters, its
//   keys in order), scans the counters, writes the block's digit counts to
//   the cluster's rows of a global scratch, reads every block's from L2 after
//   a cluster barrier (distributed shared memory is far slower than L2 for
//   such bulk reads), and stores each key at its place in the block that
//   holds it, through distributed shared memory, then a second cluster
//   barrier. The passes are stable and pass 0 takes the terms in order, so
//   every row's terms end in one contiguous run, in ascending term order.
//   Then each warp walks 32 places at a time: the run's first lane adds the
//   run's values (read by term from global memory and staged in shared
//   memory) in order from the row's current value, and a run that goes on
//   past the 32 places is carried by lane 0 into the next ones, into the next
//   block if need be. Each row of out is read and written once. No mask, no
//   memset, no global keys: the launch writes out and the digit counts.
// - Larger M (the unplanned `spring_forces`, the edge-sharded sum; off the
//   engines' paths): two kernels. The terms come in T tiles of L <= 1024
//   consecutive terms, and `sort_tiles_kernel` sorts each tile in one
//   block of 1024 threads, one term a thread: a bitonic sort of (id << 32
//   | position in the tile), whose keys are distinct, so equal ids keep
//   their term order; the stages within a warp exchange by shuffles, the
//   15 across warps through shared memory, one barrier each. The block
//   then marks its tile in its ids' tile masks, W = ceil(T / 64) 64-bit
//   words a row (bit t % 64 of word t / 64; zeroed by the wrapper). Tile
//   order is term order, so a row's terms in ascending order are its run
//   in its first tile, then its run in the next tile of its mask, and so
//   on. `segment_sum_kernel` runs one thread per sorted position: a thread
//   whose key differs from the key before it in its tile starts a run, and
//   the run in the row's first tile owns the row. The owner adds its own
//   run, then takes the row's later tiles from its mask kBatch at a time,
//   finds the row's run in each by binary searches in step, so that their
//   loads are in flight together, and adds those runs in tile order, four
//   columns at a time in registers, reading the keys and term ids of eight
//   sorted positions at once and then the values of those in the run.
//   Every other thread returns at once.
//
//   Keys equal to the largest value of their type pad the last tile and are
//   skipped.
//
// A static plan's keys come sorted once (the hub block plans' `block_hub`,
// the COO overflow tails, the scatter plan), so each row's terms are one
// run of consecutive places, and `static_sum_kernel` takes them in one
// launch. Its bound on an H100 is not the bytes (1.7 MB at the 1M
// heavy-tail graph's hub plan: 0.5 us) but the order: a row's adds are one
// chain of dependent __fadd_rn, 22,841 for that plan's widest hub, 0.046 ms
// at 4 cycles each and 1980 MHz. So the design keeps that chain fed and
// starts it at once. A warp takes 32 consecutive places, a lane each; a
// lane whose key differs from the one before it starts a run. On a call
// whose terms are its values in key order, 8 columns at most (the hub
// block plans, the COO tails), a run is long when the key kLongRun - 1 = 63
// places on is still its own (all three keys read in one round trip), and
// a warp holds one long run's start at most. A search of 32 probes a round
// (doubling steps, then 32-way splits: four rounds for 22,841) finds the
// run's end, and the warp streams the run's values through a ring of slots
// of kStage terms in its shared memory while lane c adds column c of each
// staged term in order, so that the only chain left is the adds and up to 8
// columns add side by side. A stage is one slab of floats, which one bulk
// copy of the tensor memory accelerator brings, completing on the slot's
// mbarrier, issued amid the adds of the stage before. Every other run (a
// short one; any run of a call with a perm or more than 8 columns) is added
// by the lane at its start as the tiled sum's owner does (`add_run`). The
// hub plans' launches (663 blocks of 4 warps at 84,827 terms) are resident
// at once on an H100, so every long run starts at once.
//
// Each kernel is held bit-equal to the CPU's index_add_ and to its plain
// version in ops/segment.py (`segment_sum_cluster_reference`: one stable
// sort of the whole id list, then the ascending loop; `sort_tiles_reference`
// and `segment_sum_reference`; `static_runs_reference` is the static
// kernel's table of runs) by the CPU tests, which model the kernels' orders
// in numpy, by `python -m pytest --noconftest -m cuda
// tests/test_torch_determinism.py` on a card, and by phase 25 of
// chip_smoke.py on every layout path's own calls.

#include <cstdint>

#include <cooperative_groups.h>
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

// One thread per sorted position of T > 1 tiles of L keys; `mask` holds
// each key's tiles, W words a key.
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
  // the row's first tile: the lowest bit of its first nonzero word
  const unsigned long long* words = mask + static_cast<long long>(key) * W;
  {
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
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) dst[c] = acc[c];
    }
  }
}

// The static form: one warp per 32 sorted places, kStaticWarps a block.
constexpr int kStaticWarps = 4;
constexpr int kStaticThreads = 32 * kStaticWarps;
// Runs of this many places or more are streamed by a warp (set from a sweep
// on an H100; ops/segment.py's LONG_RUN mirrors it). A run that long covers
// the rest of its warp's 32 places, so a warp holds one long run's start at
// most.
constexpr int kLongRun = 64;
static_assert(kLongRun > 32, "one long run a warp at most");
constexpr int kStage = 128;     // terms a stage of a streamed run
constexpr int kStreamCols = 8;  // the most columns a streamed run has
// floats of a slot a column: a stage's kStage terms and the 16-byte words
// a bulk copy takes on either side; slots stay 16-byte aligned
constexpr int kColStride = kStage + 4;
// a warp's ring: two slots of kStreamCols columns, more of fewer
constexpr int kRingFloats = 2 * kColStride * kStreamCols;
constexpr int kMaxSlots = 16;   // slots of one column
constexpr int kAhead = 8;       // reads of a slot ahead of the adds
static_assert(kStage % kAhead == 0, "whole groups");

// Slots of nc <= kStreamCols columns in a ring: a power of 2, 2 at least.
__host__ __device__ constexpr int ring_slots(int nc) {
  return nc == 1 ? 16 : nc == 2 ? 8 : nc <= 4 ? 4 : 2;
}
static_assert(ring_slots(1) <= kMaxSlots &&
                  ring_slots(1) * kColStride <= kRingFloats &&
                  ring_slots(2) * kColStride * 2 <= kRingFloats &&
                  ring_slots(4) * kColStride * 4 <= kRingFloats,
              "the slots fit the ring");

// Shared memory of a static block: each warp's ring, then each warp's
// kMaxSlots mbarriers (34,304 bytes: under the 48 KB a launch takes
// without an attribute).
__host__ __device__ constexpr int static_smem_bytes() {
  return kStaticWarps * (kRingFloats * 4 + kMaxSlots * 8);
}

// Waits until the phase of parity `parity` of the mbarrier `bar` completes.
__device__ __forceinline__ void wait_parity(unsigned long long* bar,
                                            unsigned parity) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(at), "r"(parity)
        : "memory");
  }
}

// The end of the run of `key` that holds sorted place `lo` (keys[lo] ==
// key): the first place after it whose key differs, or N. Warp-wide, all
// lanes with the same arguments; keys ascend, so the places of the run are
// a prefix of those probed. Lane l first probes lo + 2^l, then each round
// splits what is left in 32 steps and lane l probes step l + 1.
template <typename K>
__device__ long long run_end(const K* __restrict__ keys, long long N,
                             long long lo, K key, int lane) {
  long long hi = N;
  {
    const long long q = lo + (1ll << lane);
    const int m = __popc(__ballot_sync(0xffffffffu, q < N && keys[q] == key));
    const long long base = lo;
    if (m > 0) lo = base + (1ll << (m - 1));
    if (m < 32) hi = min(N, base + (1ll << m));
  }
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + step * (lane + 1);
    const int m = __popc(__ballot_sync(0xffffffffu, q < hi && keys[q] == key));
    hi = min(hi, lo + step * (m + 1));
    lo += step * m;
  }
  return hi;
}

// Lane 0 (`leader`) sets the mbarrier at shared address `bar` to expect
// `bytes` and has the tensor memory accelerator copy them from `src` to
// shared address `dst`, completing on it; the other lanes run the same
// instructions predicated off, so the warp does not diverge.
__device__ __forceinline__ void bulk_copy(bool leader, unsigned bar,
                                          unsigned dst, const float* src,
                                          unsigned bytes) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %4, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %3;\n"
      " @p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%1], [%2], %3, [%0];\n}\n" ::"r"(bar),
      "r"(dst), "l"(src), "r"(bytes), "r"(static_cast<int>(leader))
      : "memory");
}

// acc plus the kStage terms of a slot, v[t * nc] for t = 0, 1, ..., in
// order, kAhead reads ahead of the adds; `mid` runs after the first group.
template <typename F>
__device__ __forceinline__ float add_stage(float acc, const float* v, int nc,
                                           F mid) {
  float x[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) x[j] = v[j * nc];
#pragma unroll
  for (int g = 1; g < kStage / kAhead; ++g) {
    float y[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) y[j] = v[(kAhead * g + j) * nc];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) acc = __fadd_rn(acc, x[j]);
    if (g == 1) mid();
#pragma unroll
    for (int j = 0; j < kAhead; ++j) x[j] = y[j];
  }
#pragma unroll
  for (int j = 0; j < kAhead; ++j) acc = __fadd_rn(acc, x[j]);
  return acc;
}

// Lane c < d of the warp adds column c of the values of sorted places
// [p, e) (the run of row `row`, its terms in place order, d <=
// kStreamCols, values 16-byte aligned) onto out[row], in order, through its
// ring `buf` of S = ring_slots(d) slots of kStage terms. A stage's terms
// are one slab of floats: lane 0 copies it by one bulk copy of the tensor
// memory accelerator, from the 16-byte word at or below its start to the
// one at or above its end (inside the allocation, which holds whole 16-byte
// words), completing on the slot's mbarrier in `bars`, S - 1 stages ahead;
// it issues each copy amid the adds of the stage before, into the slot
// freed by the stage before that. Only the adding lanes take part. The
// mbarriers are fresh, so stage k completes phase k / S of its slot.
__device__ void stream_run(const float* __restrict__ values,
                           float* __restrict__ out, long long p, long long e,
                           long long row, int d, float* buf,
                           unsigned long long* bars, int lane) {
  if (lane >= d) return;
  const long long n = e - p;
  const int n_st = static_cast<int>((n + kStage - 1) / kStage);
  const int S = ring_slots(d);
  const unsigned adders = (1u << d) - 1u;
  // the 16-byte word at or below stage s's first float
  auto first_word = [&](int s) {
    return (p + static_cast<long long>(s) * kStage) * d & ~3ll;
  };
  auto issue = [&](int s) {
    const long long q1 = min(p + static_cast<long long>(s + 1) * kStage, e);
    const long long a0 = first_word(s), a1 = (q1 * d + 3) & ~3ll;
    const int i = s & (S - 1);
    bulk_copy(lane == 0 && s < n_st,
              static_cast<unsigned>(__cvta_generic_to_shared(bars + i)),
              static_cast<unsigned>(
                  __cvta_generic_to_shared(buf + i * kColStride * d)),
              values + a0, static_cast<unsigned>((a1 - a0) * 4));
  };
  for (int s = 0; s < S - 1; ++s) issue(s);
  float acc = out[row * d + lane];
  for (int k = 0; k < n_st; ++k) {
    const int i = k & (S - 1);
    wait_parity(bars + i, static_cast<unsigned>(k / S) & 1);
    const float* v =
        buf + i * kColStride * d +
        ((p + static_cast<long long>(k) * kStage) * d - first_word(k)) + lane;
    const long long left = n - static_cast<long long>(k) * kStage;
    if (left >= kStage) {
      // stage k + S - 1 takes the slot that stage k - 1 held
      acc = add_stage(acc, v, d, [&] { issue(k + S - 1); });
    } else {
      for (int t = 0; t < left; ++t) acc = __fadd_rn(acc, v[t * d]);
    }
    __syncwarp(adders);  // the slot is read before it is refilled
  }
  out[row * d + lane] = acc;
}

// Places [32 w, 32 w + 32) of the N sorted keys go to warp w of the grid: a
// place whose key differs from the one before it starts a run. Where a call
// can stream (no perm, d <= kStreamCols, 16-byte aligned values), a run of
// kLongRun places or more is long: the key kLongRun - 1 places on is its
// own (all three keys read in one round trip), and the warp finds its end
// (run_end) and streams it (stream_run). Every other run is added by the
// lane at its start (add_run). Dynamic shared memory: static_smem_bytes().
// Six blocks an SM (at most 85 registers): 792 at once on an H100, the 1M
// heavy-tail graph's 663 among them.
template <typename K>
__global__ void __launch_bounds__(kStaticThreads, 6)
    static_sum_kernel(const K* __restrict__ keys,
                      const long long* __restrict__ perm,
                      const float* __restrict__ values,
                      float* __restrict__ out, long long N, int d) {
  extern __shared__ __align__(16) float stage[];
  const int lane = threadIdx.x & 31;
  const long long p =
      static_cast<long long>(blockIdx.x) * kStaticThreads + threadIdx.x;
  const bool in = p < N;
  const bool streams = perm == nullptr && d <= kStreamCols &&
                       (reinterpret_cast<uintptr_t>(values) & 15) == 0;
  const bool reach = streams && in && p + kLongRun - 1 < N;
  K key = pad_key<K>(), before = pad_key<K>(), probe = pad_key<K>();
  if (in) key = keys[p];
  if (in && p > 0) before = keys[p - 1];
  if (reach) probe = keys[p + kLongRun - 1];
  const bool start = in && key != pad_key<K>() && (p == 0 || before != key);
  const bool is_long = start && reach && probe == key;
  const unsigned longs = __ballot_sync(0xffffffffu, is_long);
  if (longs != 0) {
    const int w = threadIdx.x >> 5;
    unsigned long long* bars =
        reinterpret_cast<unsigned long long*>(stage +
                                              kStaticWarps * kRingFloats) +
        w * kMaxSlots;
    if (lane == 0) {
      for (int i = 0; i < ring_slots(d); ++i) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         static_cast<unsigned>(
                             __cvta_generic_to_shared(bars + i)))
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    const int src = __ffs(longs) - 1;
    const long long q = __shfl_sync(0xffffffffu, p, src);
    const K k = __shfl_sync(0xffffffffu, key, src);
    const long long e = run_end(keys, N, q + kLongRun - 1, k, lane);
    stream_run(values, out, q, e, static_cast<long long>(k), d,
               stage + w * kRingFloats, bars, lane);
  }
  if (!start || is_long) return;
  for (int c0 = 0; c0 < d; c0 += kCols) {
    const int nc = min(kCols, d - c0);
    float* dst = out + static_cast<long long>(key) * d + c0;
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) acc[c] = dst[c];
    }
    add_run(acc, nc, keys, N, key, perm, values, 0, p, d, c0);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) dst[c] = acc[c];
    }
  }
}


namespace cg = cooperative_groups;

// Clusters of 16 blocks (non-portable; an H100's GPCs hold 16 or more SMs),
// at most kMaxClusters of them, each summing the terms of one range of rows.
constexpr int kCluster = 16;
constexpr int kMaxClusters = 8;
constexpr int kClusterThreads = 1024;
constexpr int kWarps = kClusterThreads / 32;
constexpr int kItems = 8;  // keys a thread holds in a pass, at most
constexpr int kMaxDigitBits = 10;  // row bits a pass sorts by, at most
constexpr int kMaxDigits = 1 << kMaxDigitBits;
// u16 counters of a digit's row, one a warp: 32 used; 17 words a row keep
// the leaders' updates, 32 digits apart at most, free of bank conflicts
constexpr int kHistStride = 34;
static_assert(kMaxDigits == kClusterThreads, "one digit a thread");
static_assert(kWarps == 32, "a digit's row of warp counters is 16 words");
// A key's rank within its warp's keys (< kItems * 32) while a pass holds it
// in registers: bits [kRankShift, kRankShift + kRankBits) of the key, above
// its term (< kCluster * kItems * kClusterThreads).
constexpr int kRankShift = 17;
constexpr int kRankBits = 8;
static_assert(kCluster * kItems * kClusterThreads <= (1 << kRankShift),
              "the terms fit below the rank");
static_assert(kItems * 32 <= (1 << kRankBits), "the rank fits its bits");
static_assert(kRankShift + kRankBits <= 32, "the rank stays in the term");
constexpr unsigned long long kRankMask = ((1ull << kRankBits) - 1)
                                         << kRankShift;
constexpr unsigned kTermMask = (1u << kRankShift) - 1;
// Shared memory of a cluster block besides its keys: the warps' digit
// counters (16-bit: a block holds fewer than 2^16 keys), the digits'
// places in the cluster's order, the scan's warp totals, the warps' kept
// counts.
constexpr int kFixedBytes =
    kMaxDigits * kHistStride * 2 + kMaxDigits * 4 + 2 * kWarps * 4;
static_assert(kFixedBytes % 8 == 0, "the keys start 8-byte aligned");

// Keys a cluster block can hold in what is left of `smem` bytes of shared
// memory, kItems a thread at most.
__host__ __device__ constexpr int cluster_block_capacity(int smem) {
  return (smem - kFixedBytes) / 8 < kItems * kClusterThreads
             ? (smem - kFixedBytes) / 8
             : kItems * kClusterThreads;
}

// p / c for p < 2^17 and c < 2^14, by a multiply: magic = ceil(2^32 / c).
__device__ __forceinline__ unsigned div_c(unsigned p,
                                          unsigned long long magic) {
  return static_cast<unsigned>((p * magic) >> 32);
}

// Cluster g of the grid sums the terms whose rows lie in [g * span_rows,
// g * span_rows + span_rows): block b of it reads terms [b * m0, b * m0 +
// m0) of all M and keeps those; `passes` radix passes of `width` bits of
// the row's offset in the range put the kept terms in one stable order by
// row across the cluster's blocks, c of it to a block; the thread at each
// run's start adds the run. `counts` (gridDim.x * kMaxDigits) carries each
// block's digit counts to its cluster.
template <typename I>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_sum_kernel(const I* __restrict__ ids, int M, long long span_rows,
                       int passes, int width,
                       const float* __restrict__ values,
                       float* __restrict__ out, int d,
                       unsigned* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned b = cluster.block_rank();
  const int g = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  unsigned short* hist = reinterpret_cast<unsigned short*>(smem);
  unsigned* base = reinterpret_cast<unsigned*>(hist + kMaxDigits *
                                                          kHistStride);
  unsigned* totals = base + kMaxDigits;  // the scan's warp totals
  unsigned* kept = totals + kWarps;      // pass 0: each warp's kept keys
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(kept + kWarps);
  unsigned* cluster_counts = counts + (blockIdx.x - b) * kMaxDigits;
  const long long row_lo = g * span_rows;
  const int digits = 1 << width;
  // pass 0 takes terms [lo, lo + n) of all M, later passes the cluster's
  // places [lo, lo + n) of its order
  const int m0 = (M + kCluster - 1) / kCluster;
  int lo = static_cast<int>(b) * m0;
  int n = max(0, min(m0, M - lo));
  int rounds = (n + kClusterThreads - 1) / kClusterThreads;
  int span = rounds * 32;  // a warp's keys: [w * span, w * span + span)
  int total = 0, c = 1;  // the cluster's kept keys, a block's share
  unsigned long long magic = 1ull << 32;
  // a thread's keys, 32 apart in its warp's span: (row << 32 | term); this
  // cluster's kept in order at the start of the warp's span
  unsigned long long key[kItems];
  {
    int got = 0;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (r < rounds) {
        const int q = w * span + r * 32 + lane;
        bool keep = false;
        unsigned long long k = 0;
        if (q < n) {
          const long long row = static_cast<long long>(ids[lo + q]);
          keep = row >= row_lo && row < row_lo + span_rows;
          k = (static_cast<unsigned long long>(row) << 32) |
              static_cast<unsigned>(lo + q);
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          keys[w * span + got + __popc(ballot & ((1u << lane) - 1u))] = k;
        }
        got += __popc(ballot);
      }
    }
    if (lane == 0) kept[w] = got;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int q = r * 32 + lane;
      key[r] = r < rounds && q < got ? keys[w * span + q] : 0ull;
    }
  }
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = width * pass;
    {
      uint4* h = reinterpret_cast<uint4*>(hist);
      for (int i = tid; i < (digits * kHistStride + 7) / 8;
           i += kClusterThreads) {
        h[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (pass > 0) {
      // this block's places of the order, as in pass 0
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int q = w * span + r * 32 + lane;
        if (r < rounds && q < n) key[r] = keys[q];
      }
    }
    __syncthreads();
    // 1. each key's rank among the keys of its digit before it in its
    //    warp, taken 32 keys a round, in order (the lanes of a digit found
    //    by a ballot a bit); the rank rides in the key's bits kRankShift..
    const int mine = pass == 0 ? static_cast<int>(kept[w])
                               : max(0, min(span, n - w * span));
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (r * 32 < mine) {
        const bool valid = r * 32 + lane < mine;
        const unsigned dg = static_cast<unsigned>(
                                ((key[r] >> 32) - row_lo) >> shift) &
                            (digits - 1);
        unsigned peers = __ballot_sync(0xffffffffu, valid);
        for (int bit = 0; bit < width; ++bit) {
          const bool set = (dg >> bit) & 1u;
          const unsigned m = __ballot_sync(0xffffffffu, set);
          peers &= set ? m : ~m;
        }
        const int leader = __ffs(peers) - 1;
        unsigned old = 0;
        if (valid && lane == leader) {
          old = hist[dg * kHistStride + w];
          hist[dg * kHistStride + w] =
              static_cast<unsigned short>(old + __popc(peers));
        }
        old = __shfl_sync(0xffffffffu, old, valid ? leader : lane);
        key[r] |= static_cast<unsigned long long>(
                      old + __popc(peers & ((1u << lane) - 1u)))
                  << kRankShift;
        __syncwarp();
      }
    }
    __syncthreads();
    // 2. a digit's warp counters become each warp's first rank of the
    //    digit in the block; the block's digit counts go to the cluster
    if (tid < digits) {
      unsigned* row = reinterpret_cast<unsigned*>(hist + tid * kHistStride);
      unsigned s = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const unsigned u = row[k], x = u & 0xffffu;
        row[k] = s | ((s + x) << 16);
        s += x + (u >> 16);
      }
      __stcg(cluster_counts + b * kMaxDigits + tid, s);
    }
    cluster.sync();  // every block's counts are out, its keys held
    // 3. base: a digit's first place in the cluster's order (the keys of
    //    smaller digits, then this digit's in earlier blocks)
    unsigned tot = 0, before = 0, a = 0;
    const int digit_warps = (digits + 31) / 32;
    if (w < digit_warps) {
      if (tid < digits) {
        unsigned v[kCluster];
#pragma unroll
        for (int r = 0; r < kCluster; ++r) {
          v[r] = __ldcg(cluster_counts + r * kMaxDigits + tid);
        }
#pragma unroll
        for (int r = 0; r < kCluster; ++r) {
          tot += v[r];
          if (r < static_cast<int>(b)) before += v[r];
        }
      }
      a = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(0xffffffffu, a, o);
        if (lane >= o) a += x;
      }
      if (lane == 31) totals[w] = a;
    }
    __syncthreads();
    if (tid < 32) {
      unsigned t = tid < digit_warps ? totals[tid] : 0u;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += x;
      }
      totals[tid] = t;
    }
    __syncthreads();
    if (tid < digits) {
      base[tid] = a - tot + before + (w > 0 ? totals[w - 1] : 0u);
    }
    if (pass == 0) {
      // the cluster's kept keys, c of them to a block
      total = static_cast<int>(totals[31]);
      c = max(1, (total + kCluster - 1) / kCluster);
      magic = 0xffffffffu / static_cast<unsigned>(c) + 1ull;
    }
    __syncthreads();
    // 4. each key to its place in the cluster's order, in the block that
    //    holds the place
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (r * 32 + lane < mine) {
        const unsigned dg = static_cast<unsigned>(
                                ((key[r] >> 32) - row_lo) >> shift) &
                            (digits - 1);
        const unsigned p =
            base[dg] + hist[dg * kHistStride + w] +
            static_cast<unsigned>((key[r] & kRankMask) >> kRankShift);
        const unsigned blk = div_c(p, magic);
        *cluster.map_shared_rank(keys + (p - blk * c), blk) =
            key[r] & ~kRankMask;
      }
    }
    cluster.sync();  // the order is complete in every block
    lo = static_cast<int>(b) * c;
    n = max(0, min(c, total - lo));
    rounds = (n + kClusterThreads - 1) / kClusterThreads;
    span = rounds * 32;
  }
  // 5. the runs: warp w takes places [s0, s1) of this block, 32 at a time,
  //    a lane a place; a run's first lane adds the run's values in order
  //    (staged in shared memory), and the last run of 32 places, if it may
  //    go on, is carried into the next places by lane 0, past s1 if need
  //    be. Keys come from the cluster's shared memory, values by term from
  //    global memory.
  const int wspan = (n + kWarps * 32 - 1) / (kWarps * 32) * 32;
  const int s0 = min(n, w * wspan), s1 = min(n, s0 + wspan);
  float4* staged = reinterpret_cast<float4*>(hist) + w * 32;
  auto key_at = [&](int p) {
    const unsigned blk = div_c(static_cast<unsigned>(p), magic);
    const unsigned long long* at = keys + (p - static_cast<int>(blk) * c);
    return blk == b ? *at : *cluster.map_shared_rank(at, blk);
  };
  for (int c0 = 0; c0 < d; c0 += 4) {
    const int nc = min(4, d - c0);
    unsigned open = ~0u, last = ~0u;  // the carried run's row; lane 31's
    float carry[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = s0; s < s1 || open != ~0u;
         s = s < s1 ? min(s + 32, s1) : s + 32) {
      const int gp = lo + s + lane;
      bool in = s < s1 ? s + lane < s1 : gp < total;
      const unsigned long long k = in ? key_at(gp) : ~0ull;
      const unsigned row = static_cast<unsigned>(k >> 32);
      if (s >= s1) {
        // past this warp's places: only the carried run's
        const unsigned other = __ballot_sync(0xffffffffu, !in || row != open);
        in = lane < (other ? __ffs(other) - 1 : 32);
      }
      unsigned prev = __shfl_up_sync(0xffffffffu, row, 1);
      if (lane == 0) {
        prev = s > s0 ? last
                      : (gp > 0 ? static_cast<unsigned>(key_at(gp - 1) >> 32)
                                : ~0u);
      }
      const bool first = in && row != prev && s < s1;
      const bool carried = lane == 0 && open != ~0u && in && row == open;
      const unsigned owners = __ballot_sync(0xffffffffu, first || carried);
      const int n_in = __popc(__ballot_sync(0xffffffffu, in));
      const unsigned later = lane == 31 ? 0u : owners >> (lane + 1);
      const int end = later ? lane + __ffs(later) : n_in;
      const int len = first || carried ? end - lane : 0;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) {
        const float* src = values + static_cast<long long>(
                                        static_cast<unsigned>(k) & kTermMask) *
                                        d + c0;
        v.x = src[0];
        if (nc > 1) v.y = src[1];
        if (nc > 2) v.z = src[2];
        if (nc > 3) v.w = src[3];
      }
      staged[lane] = v;
      __syncwarp();
      float acc[4];
      float* dst = out + static_cast<long long>(row) * d + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j] = first && j < nc ? dst[j] : carry[j];
      }
      if (lane == 0 && open != ~0u && !carried) {
        // the carried run ended with the last places
        float* o = out + static_cast<long long>(open) * d + c0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nc) o[j] = carry[j];
        }
      }
      for (int i = 0; i < len; ++i) {
        const float4 x = staged[lane + i];
        acc[0] = __fadd_rn(acc[0], x.x);
        if (nc > 1) acc[1] = __fadd_rn(acc[1], x.y);
        if (nc > 2) acc[2] = __fadd_rn(acc[2], x.z);
        if (nc > 3) acc[3] = __fadd_rn(acc[3], x.w);
      }
      // the last run of these places stays open if it reaches their end
      // and more places may follow
      const int top = owners ? 31 - __clz(owners) : -1;
      const int top_end = __shfl_sync(0xffffffffu, end, max(top, 0));
      const bool keep = top >= 0 && top_end == n_in && lo + s + n_in < total &&
                        (n_in == 32 || s < s1);
      if ((first || carried) && !(keep && lane == top)) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nc) dst[j] = acc[j];
        }
      }
      open = keep ? __shfl_sync(0xffffffffu, row, top) : ~0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        carry[j] = __shfl_sync(0xffffffffu, acc[j], max(top, 0));
      }
      last = __shfl_sync(0xffffffffu, row, 31);
      __syncwarp();  // the staged rows are read before the next places
    }
  }
  cluster.sync();  // the peers' reads of this block's keys are done
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

// Launches the tiled row sums on `stream` and returns cudaGetLastError() (0
// on success). keys (T * L,) int32 are T > 1 tiles of L, each sorted
// ascending, each in [0, rows of out) or 2^31 - 1 (a pad, skipped), with
// the tile sort's mask (rows, W), W = ceil(T / 64). perm (T * L,) int64
// gives the term of each sorted position within its tile (tile t's
// position j holds term t * L + perm[t * L + j]); values (terms, d) and out
// (rows, d) are contiguous fp32, and out is updated in place. The wrapper
// checks shapes, types and devices, and launches nothing without terms.
// (One sorted tile is a static call: graphem_segment_sum_sorted_launch.)
extern "C" int graphem_segment_sum_launch(const int32_t* keys,
                                          const long long* perm,
                                          const unsigned long long* mask,
                                          int W, const float* values,
                                          float* out, int T, long long L,
                                          int d, void* stream) {
  if (T < 2 || L < 1 || d < 1 || mask == nullptr || W != (T + 63) / 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (T * L + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<int32_t>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(keys, perm, mask, W, values,
                                              out, T, L, d);
  return static_cast<int>(cudaGetLastError());
}

// Launches the static form on `stream` and returns cudaGetLastError() (0 on
// success): keys (N,) sorted ascending, int32 (key_bytes 4) or int64 (8),
// each in [0, rows of out); perm (N,) int64 the term of each place, or null
// for terms in key order; values (terms, d) and out (rows, d) contiguous
// fp32, out updated in place. One launch of ceil(N / 128) blocks, under
// 48 KB of shared memory each, so no attribute needs setting before a
// capture.
extern "C" int graphem_segment_sum_sorted_launch(
    const void* keys, int key_bytes, const long long* perm,
    const float* values, float* out, long long N, int d, void* stream) {
  if (N < 1 || d < 1 || (key_bytes != 4 && key_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (N + kStaticThreads - 1) / kStaticThreads;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const size_t smem = static_cast<size_t>(static_smem_bytes());
  if (key_bytes == 4) {
    static_sum_kernel<int32_t><<<grid, kStaticThreads, smem, st>>>(
        static_cast<const int32_t*>(keys), perm, values, out, N, d);
  } else {
    static_sum_kernel<int64_t><<<grid, kStaticThreads, smem, st>>>(
        static_cast<const int64_t*>(keys), perm, values, out, N, d);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Sets the cluster kernel's attributes for `smem` bytes of dynamic shared
// memory on the current device (once per device, before any capture) and
// returns the clusters of kCluster blocks it can run there at once (0:
// none).
template <typename I>
cudaError_t cluster_setup(int device, int smem, int* clusters) {
  static int opted[64] = {};
  cudaError_t e = cudaSuccess;
  if (device >= 64 || opted[device] < smem) {
    e = cudaFuncSetAttribute(cluster_sum_kernel<I>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(cluster_sum_kernel<I>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    }
    if (e != cudaSuccess) return e;
    if (device < 64) opted[device] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, cluster_sum_kernel<I>,
                                        &cfg);
}

// The clusters one launch takes on each device: as many as run at once, at
// most kMaxClusters; 0 where none can run. Set by the capacity query.
int cluster_count[64] = {};

}  // namespace

// The most terms that one cluster launch sums on `device`: what one cluster
// of kCluster blocks holds in the shared memory a block may opt in to
// (131,072 on an H100), 0 where the device cannot run such a cluster; minus
// the CUDA error on failure. Sets the kernel up on the device, so it comes
// before the first launch there.
extern "C" int graphem_segment_cluster_capacity(int device) {
  int smem = 0, clusters = 0, other = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int cap = cluster_block_capacity(smem);
  if (cap < 1 || device >= 64) return 0;
  int current = 0;
  e = cudaGetDevice(&current);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cluster_setup<int64_t>(device, smem, &clusters);
  if (e == cudaSuccess) e = cluster_setup<int32_t>(device, smem, &other);
  const cudaError_t back = cudaSetDevice(current);
  if (e == cudaSuccess) e = back;
  if (e != cudaSuccess) return -static_cast<int>(e);
  clusters = min(clusters, other);
  cluster_count[device] = min(clusters, kMaxClusters);
  return clusters > 0 ? kCluster * cap : 0;
}

// The clusters one launch takes on `device` (0 before the capacity query).
extern "C" int graphem_segment_cluster_groups(int device) {
  return device >= 0 && device < 64 ? cluster_count[device] : 0;
}

// Sums the (M,) ids' terms into out on `stream` with one launch of
// `groups` clusters: ids int32 (id_bytes 4) or int64 (8) in [0, groups *
// span_rows), rows of out; cluster g takes the rows [g * span_rows, g *
// span_rows + span_rows) and sorts their offsets by `passes` digits of
// `width` bits; values (M, d) and out (rows, d) contiguous fp32, out
// updated in place; counts (groups * kCluster * 1024,) int32 scratch. M must
// not pass graphem_segment_cluster_capacity, which sets the kernel up and
// so comes first, nor groups graphem_segment_cluster_groups. Returns
// cudaGetLastError() (0 on success).
extern "C" int graphem_segment_cluster_launch(
    const void* ids, int id_bytes, int M, int groups, long long span_rows,
    int passes, int width, const float* values, float* out, int d,
    unsigned* counts, void* stream) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int smem = 0;
  e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cap = cluster_block_capacity(smem);
  if (M < 1 || d < 1 || groups < 1 || device >= 64 ||
      groups > cluster_count[device] || span_rows < 1 || passes < 1 ||
      width < 1 || width > kMaxDigitBits ||
      (passes * width < 64 && ((span_rows - 1) >> (passes * width)) != 0) ||
      (M + kCluster - 1) / kCluster > cap ||
      (id_bytes != 4 && id_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster * groups);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = kFixedBytes + 8 * static_cast<size_t>(cap);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (id_bytes == 8) {
    e = cudaLaunchKernelEx(&cfg, cluster_sum_kernel<int64_t>,
                           static_cast<const int64_t*>(ids), M, span_rows,
                           passes, width, values, out, d, counts);
  } else {
    e = cudaLaunchKernelEx(&cfg, cluster_sum_kernel<int32_t>,
                           static_cast<const int32_t*>(ids), M, span_rows,
                           passes, width, values, out, d, counts);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
