// Independent-Cascade cascade kernel: one cooperative launch runs every
// step of one cascade on bit-packed state.
//
// Replaces graphem_rapids_tpu/ops/ic_sim.py:116 `_ic_run_table` under jit,
// which is an XLA while_loop (not a Pallas kernel): XLA fuses the coin
// draw, the (n, cap, B) frontier gather and the row-any of each step, and
// the loop's test stays on the device. Here the loop, the frontier test
// and the coins stay on the card too: the host launches once per cascade
// and reads nothing until the counts.
//
// Semantics (graphem_rapids_torch/ops/ic_cascade.py has the plain version,
// bit for bit): column b of vertex v is bit b % 32 of word v * W + b / 32.
// At step t, hit(v, b) holds when some slot j < cap has frontier(table[v,
// j], b) and coin(t, v, j, b), or some overflow in-edge o of v (ov_ptr[v]
// <= o < ov_ptr[v + 1]) has frontier(ov_src[o], b) and coin(t, v, cap + o,
// b); newly = hit & ~active; active |= newly; frontier = newly. The
// cascade stops after the first step whose newly is empty, or after
// max_iters steps. coin(t, v, j, b) = philox4x32_10(counter = (r >> 2, j,
// v, t), key)[r & 3] < thr, r = b mod runs (runs = B unless the columns
// are groups whose run r shares its coins), thr = floor(p * 2^32) in
// [0, 2^32].
//
// Design. The step is ic_common.cuh's frontier-driven step, shared with the
// scatter form (ic_scatter.cu): a step whose queue has few out-pairs pushes
// from the frontier's vertices along their push lists (the table slots and
// overflow in-edges regrouped by source), and only the vertices hit and
// the queue's are touched besides; one grid barrier a step. This file
// brings the dense pass, taken where the queue's pairs pass dense_limit
// (the wrapper's DENSE_BETA times G times the n * cap + O slots). Its work
// items are of two kinds, handed out warp-strided over the whole grid in
// one pass, the longest chains first:
// - (chunk, word): the plan's chunk list cuts every overflow row of at
//   least long_row in-edges (ops/ic_cascade.py LONG_ROW) into chunks of
//   chunk_len in-edges (CHUNK_EDGES), the last of a row partial. A warp
//   takes one such item: it reads the word's open columns (neither active,
//   in the frontier, nor hit yet), skips the chunk if none is open, and
//   walks its in-edges, each lane kRowBatch of them (ids, then frontier
//   words, before any coin) a round, until the chunk ends or every open
//   column has fired; the lanes' fired bits are OR-reduced
//   (__reduce_or_sync) and one lane ORs them into hit_t with atomicOr.
// - (vertex, word), 32 a warp: a walk of the table row, which loads kBatch
//   table ids and their frontier words before it draws any coin, so the
//   loads of a batch are in flight together, the early exit (every column
//   active or hit) tested once a batch; then the overflow row, if it is
//   shorter than long_row, by the owner alone. The owner stores its hit
//   word, or ORs it in atomically where chunks of its row may write the
//   same word.
//
// What bounds it on an H100: not bytes. What a cascade must move is the
// seed words read and the active words written (2 n W words) and, of the
// push lists, only the pairs behind the frontier and their sources' row
// starts: at the 1M-vertex plan (ring + 3M chords, cap 13, 35,188
// overflow in-edges) with B = 64 (W = 2) and p = 0.1 about 16 MB, 0.005
// ms at 3.35 TB/s; the rest of the table need not be read. A push step is
// bound by latency: a chain of about a dozen dependent L2 round trips
// (the offsets' search, the pair, the frontier word, the receiver's
// words, the stamp, the append) and one grid barrier of 264 arrivals;
// what is left is the n W state's initialization and count, once a
// cascade. A dense step reads the table (52 MB at 1M) and a sector per
// gathered frontier word, as the kernel once did every step; "auto" takes
// it only where a step's frontier has many pairs behind it. PERF.md has
// the times (scripts/torch_ic_times.py).
//
// Load balance: a push step hands out the queue's pairs by their offsets
// (a hub's row spreads over as many warps as its pairs fill); a dense step
// hands out a long overflow row's chunks over the grid. A row walked by one
// warp would set the step's pace: on the heavy-tail plan (zipf ranks, so
// vertices 0-15 are the 16 largest hubs, 1.88M in-edges) the one warp of
// vertices 0-15 would walk their rows one after another in every dense
// step while the rest of the grid waits at its barrier.

#include <cstdint>

#include <cuda_runtime.h>

#include "ic_common.cuh"

namespace {

using ic::kFull;
using ic::kThreads;

constexpr int kBatch = 8;     // table slots loaded before their coins
constexpr int kRowBatch = 4;  // a chunk's in-edges a lane loads a round

struct GatherDense {
  const int32_t* table;
  const int32_t* ov_ptr;
  const int32_t* ov_src;
  const int32_t* chunks;  // (n_chunks, 2): row v, first in-edge o0
  int cap;
  int n_chunks;
  int long_row;   // overflow rows this long are walked by their chunks
  int chunk_len;  // in-edges of a chunk (the last of a row fewer)

  // Item q = k * W + w of the chunk items, by the whole warp: chunk k's
  // in-edges against word w of its row's vertex.
  __device__ __forceinline__ void chunk(const ic::Cascade& c, int t,
                                        long long q, uint32_t last,
                                        uint32_t k0, uint32_t k1) const {
    const int lane = threadIdx.x & 31;
    const uint32_t tt = static_cast<uint32_t>(t);
    const uint32_t runs = static_cast<uint32_t>(c.runs);
    const uint32_t* frontier = c.hit((t + 2) % 3);
    uint32_t* hit_t = c.hit(t % 3);
    const long long k = q / c.W;
    const int w = static_cast<int>(q - k * c.W);
    int v = __ldg(chunks + 2 * k);
    const int o0 = __ldg(chunks + 2 * k + 1);
    // a chunk whose first in-edge lies outside its row's (a list not of
    // this plan) walks nothing, and reads nothing out of range
    if (v < 0 || v >= c.n) v = 0;
    const int r1 = __ldg(ov_ptr + v + 1);
    const int o1 = o0 >= __ldg(ov_ptr + v) && o0 < r1
                       ? o0 + min(chunk_len, r1 - o0)
                       : o0;
    const long long vi = static_cast<long long>(v) * c.W + w;
    // one lane reads the word, so that every lane holds the same columns
    uint32_t open = 0u;
    if (lane == 0 && o1 > o0) {
      open = ~(__ldcg(c.active + vi) | __ldcg(frontier + vi) |
               __ldcg(hit_t + vi)) &
             (w == c.W - 1 ? last : kFull);
    }
    open = __shfl_sync(kFull, open, 0);
    uint32_t acc = 0u;
    for (int a = o0; a < o1 && open; a += 32 * kRowBatch) {
      uint32_t f[kRowBatch];
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r) {
        const int o = a + 32 * r + lane;
        f[r] = o < o1 ? __ldcg(frontier +
                               static_cast<long long>(__ldg(ov_src + o)) *
                                   c.W + w)
                      : 0u;
      }
      uint32_t mine = 0u;
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r) {
        const uint32_t cand = f[r] & open & ~mine;
        if (cand) {
          mine |= ic::fired(cand, tt, v,
                            static_cast<uint32_t>(cap + a + 32 * r + lane), w,
                            runs, k0, k1, c.thr);
        }
      }
      mine = __reduce_or_sync(kFull, mine);
      acc |= mine;
      open &= ~mine;
    }
    bool app = false;
    if (lane == 0 && acc) {
      atomicOr(hit_t + vi, acc);
      app = ic::touch(c.stamp(), v, t);
    }
    ic::append(c, t % 3, app, v);
  }

  __device__ __forceinline__ void operator()(const ic::Cascade& c, int t,
                                             uint32_t k0, uint32_t k1) const {
    const int lane = threadIdx.x & 31;
    const long long items = static_cast<long long>(c.n) * c.W;
    const long long chunk_items = static_cast<long long>(n_chunks) * c.W;
    const long long tasks = chunk_items + (items + 31) / 32;
    const uint32_t last = (c.B & 31) ? (1u << (c.B & 31)) - 1u : kFull;
    const uint32_t tt = static_cast<uint32_t>(t);
    const uint32_t runs = static_cast<uint32_t>(c.runs);
    const uint32_t* frontier = c.hit((t + 2) % 3);
    uint32_t* hit_t = c.hit(t % 3);
    for (long long task = ic::global_warp(); task < tasks;
         task += ic::grid_warps()) {
      if (task < chunk_items) {
        chunk(c, t, task, last, k0, k1);
        continue;
      }
      const long long i = (task - chunk_items) * 32 + lane;
      int v = 0, w = 0, o0 = 0, o1 = 0;
      uint32_t need = 0u;  // columns neither active nor hit yet
      uint32_t hit = 0u;
      if (i < items) {
        v = static_cast<int>(i / c.W);
        w = static_cast<int>(i - static_cast<long long>(v) * c.W);
        need = ~(__ldcg(c.active + i) | __ldcg(frontier + i)) &
               (w == c.W - 1 ? last : kFull);
      }
      if (need) {
        const int32_t* row = table + static_cast<long long>(v) * cap;
        for (int j0 = 0; j0 < cap && (need & ~hit); j0 += kBatch) {
          uint32_t f[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            f[k] = j0 + k < cap
                       ? __ldcg(frontier +
                                static_cast<long long>(__ldg(row + j0 + k)) *
                                    c.W + w)
                       : 0u;
          }
          uint32_t pending = 0u;
#pragma unroll
          for (int k = 0; k < kBatch; ++k) pending |= (f[k] & need) ? 1u << k : 0u;
          while (pending) {
            const int k = __ffs(pending) - 1;
            pending &= pending - 1u;
            uint32_t fk = 0u;
#pragma unroll
            for (int kk = 0; kk < kBatch; ++kk) fk = kk == k ? f[kk] : fk;
            const uint32_t cand = fk & need & ~hit;
            if (cand) {
              hit |= ic::fired(cand, tt, v, static_cast<uint32_t>(j0 + k), w,
                               runs, k0, k1, c.thr);
            }
          }
        }
        o0 = __ldg(ov_ptr + v);
        o1 = __ldg(ov_ptr + v + 1);
      }
      const bool chunked = o1 - o0 >= long_row;  // the chunk items walk it
      if (!chunked) {
        for (int o = o0; o < o1 && (need & ~hit); ++o) {
          const long long u = __ldg(ov_src + o);
          const uint32_t cand = __ldcg(frontier + u * c.W + w) & need & ~hit;
          if (cand) {
            hit |= ic::fired(cand, tt, v, static_cast<uint32_t>(cap + o), w,
                             runs, k0, k1, c.thr);
          }
        }
      }
      bool app = false;
      if (hit) {
        if (chunked) {
          atomicOr(hit_t + i, hit);
        } else {
          hit_t[i] = hit;  // this item's own word: no other writer this step
        }
        app = ic::touch(c.stamp(), v, t);
      }
      ic::append(c, t % 3, app, v);
    }
  }
};

__global__ void __launch_bounds__(kThreads, ic::kMinBlocks)
ic_cascade_kernel(ic::Cascade c, GatherDense dense) {
  ic::run(c, dense);
}

}  // namespace

// Resident blocks per SM of the cascade kernel at `threads` threads a block
// (which must be ic::kThreads), or minus a CUDA error.
extern "C" int graphem_ic_cascade_blocks_per_sm(int threads) {
  if (threads != kThreads) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ic_cascade_kernel, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launches one cascade on `stream` as a cooperative kernel and returns a
// CUDA error code (0 on success). table (n, cap), ov_ptr (n + 1,) and
// ov_src (O,) are int32; chunks (n_chunks, 2) int32 is the chunk list of
// the overflow rows of at least long_row in-edges (row, first in-edge; a
// chunk of chunk_len in-edges, the last of a row fewer), which must cover
// those rows exactly (a chunk whose first in-edge lies outside its row
// walks nothing); out_ptr (n + 1,), out_recv and out_slot (P,) are
// the plan's push lists (int32); seed and active are (n, W) 32-bit words
// and hits (3, n, W), the last two uninitialized; lists is (7, n) int32
// scratch; key is (2,) int64 on the device (two 32-bit Philox key words);
// ctl is CTL_WORDS + B int32, zeroed by the caller: the control block,
// then the (B,) counts. Column b draws the coins of run b mod runs. G is
// min(32, 2^ceil(log2 W)); a step of more than dense_limit pairs behind
// the frontier is dense. nb is the grid, at most the resident block count.
// The wrapper checks the shapes and types.
extern "C" int graphem_ic_cascade_launch(
    const int32_t* table, const int32_t* ov_ptr, const int32_t* ov_src,
    const int32_t* chunks, const int32_t* out_ptr, const int32_t* out_recv,
    const int32_t* out_slot, const uint32_t* seed, uint32_t* active,
    uint32_t* hits, int* lists, const long long* key, int* ctl_words, int n,
    int cap, int n_chunks, int long_row, int chunk_len, int W, int B,
    int runs, int G, unsigned long long thr, int max_iters,
    long long dense_limit, int nb, void* stream) {
  if (n < 1 || cap < 1 || W < 1 || B < 1 || B > 32 * W || runs < 1 ||
      G < 1 || G > 32 || (G & (G - 1)) || nb < 1 || max_iters < 0 ||
      thr > (1ull << 32) || n_chunks < 0 || (n_chunks && !chunks) ||
      long_row < 1 || chunk_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ic::Cascade c{seed, active, hits, lists, out_ptr, out_recv,
                out_slot, key, reinterpret_cast<ic::Ctl*>(ctl_words),
                ctl_words + sizeof(ic::Ctl) / sizeof(int), n, W, B, runs, G,
                max_iters, thr, dense_limit};
  GatherDense dense{table, ov_ptr, ov_src, chunks, cap,
                    n_chunks, long_row, chunk_len};
  void* args[] = {&c, &dense};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ic_cascade_kernel), dim3(nb),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
