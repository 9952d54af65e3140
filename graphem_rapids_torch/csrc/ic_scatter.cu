// Independent-Cascade cascade kernel, scatter form: one cooperative launch
// runs every step of one cascade over the directed edge list, on
// bit-packed state.
//
// Replaces graphem_rapids_tpu/ops/ic_sim.py:49 `_ic_run` under jit, an XLA
// while_loop (not a Pallas kernel) whose step draws a (num_sims, 2E) coin
// block and folds the attempts into hit with a segment max over dst. JAX
// and the port take it where the gather form's cascade table would pass
// TABLE_BUDGET_SLOTS = 2^27 slots, so for the largest graphs. Here the
// loop, the stop test and the coins stay on the card, and no (num_sims,
// 2E) array exists: the host launches once per cascade.
//
// Semantics (graphem_rapids_torch/ops/ic_scatter.py has the plain version,
// bit for bit): the (2E,) int32 lists src = [e0; e1], dst = [e1; e0] (JAX's
// order); column b of vertex v is bit b % 32 of word v * W + b / 32. At
// step t, for every directed edge e and column b, hit(dst[e], b) |=
// frontier(src[e], b) & coin(t, dst[e], e, b); then newly = hit & ~active,
// active |= newly, frontier = newly. The cascade stops after the first
// step whose newly is empty, or after max_iters steps. coin(t, v, j, b) =
// philox4x32_10(counter = (r >> 2, j, v, t), key)[r & 3] < thr with r = b
// mod runs, the gather form's coin with the directed edge index as the
// slot, so each coin is a pure function of (t, e, b mod runs) and the key.
//
// Design: edge-parallel, three passes over a grid of resident blocks (a
// cooperative launch, so the grid barrier is safe).
//   0. (vertex, word) pairs: active = frontier = seed, hit = 0; barrier.
//   Each step t:
//   1. a thread takes one directed edge e (consecutive threads, consecutive
//      edges: src is read coalesced) and walks its W words: for a frontier
//      word of src[e] that is not zero it reads dst[e] once, keeps the bits
//      whose column is neither active nor (by a racy read) already hit at
//      the receiver, draws Philox only for those, and ORs the fired bits
//      into hit[dst[e]] with atomicOr. OR is order-free, so hit is the same
//      whatever the order; the racy read only skips coins that could not
//      change it (the number of coins drawn depends on timing, the result
//      does not). Barrier.
//   2. (vertex, word) pairs: newly = hit & ~active, active |= newly,
//      frontier = newly, hit = 0 for the next step (the barrier after this
//      pass keeps the clear from racing the next step's ORs); the block's
//      popcount(newly) goes to the stop test (ic_common.cuh), whose barrier
//      ends the step.
// The coins, the barrier, the stop test and the final count are
// ic_common.cuh's, shared with the gather form (ic_cascade.cu). 2E and
// n * W each stay below 2^31 (the wrapper checks), so e and v fit the
// 32-bit counter words.
//
// What bounds it on an H100: the bytes of each step. At the smallest graph
// of bench.py's scale family that takes this path (ring + 36M chords,
// n = 12,000,000, 2E = 95,999,964) with B = 64 (W = 2), pass 1 reads src
// (384 MB) and one 32-byte sector per edge's frontier row (the 96 MB of
// frontier words do not stay in the 50 MB L2: at most 3.1 GB), pass 2 the
// hit and frontier words (192 MB): 0.3-1.1 ms a step at 3.35 TB/s. dst and
// active are read only behind a non-zero frontier word. Reading src once,
// dst only behind a frontier bit (the coin's counter holds dst[e]) and
// the seed words once, and writing the active words once, is about 576 MB
// (0.17 ms); the gap is the per-step sweep over every edge, which a
// frontier-driven sweep (only the frontier's out-edges) would cut.

#include <cstdint>

#include <cuda_runtime.h>

#include "ic_common.cuh"

namespace {

using ic::Ctl;
using ic::kThreads;

__global__ void __launch_bounds__(kThreads)
ic_scatter_kernel(const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst,
                  const uint32_t* __restrict__ seed, uint32_t* active,
                  uint32_t* frontier, uint32_t* hit,
                  const long long* __restrict__ key, Ctl* ctl, int* counts,
                  int n, long long E2, int W, int B, int runs,
                  unsigned long long thr, int max_iters) {
  const long long items = static_cast<long long>(n) * W;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  unsigned long long epoch = 0;
  unsigned long long seen[2] = {0ull, 0ull};  // thread 0's last totals

  for (long long i = first; i < items; i += stride) {
    const uint32_t s = seed[i];
    active[i] = s;
    frontier[i] = s;
    hit[i] = 0u;
  }
  ic::grid_barrier(&ctl->barrier, epoch);

  int t = 0;
  while (t < max_iters) {
    for (long long e = first; e < E2; e += stride) {
      const long long u = __ldg(src + e);
      const uint32_t* fu = frontier + u * W;
      long long v = -1;
      for (int w = 0; w < W; ++w) {
        uint32_t f = __ldcg(fu + w);
        if (!f) continue;
        if (v < 0) v = __ldg(dst + e);
        const long long vi = v * W + w;
        f &= ~(__ldcg(active + vi) | __ldcg(hit + vi));
        if (!f) continue;
        const uint32_t fire =
            ic::fired(f, static_cast<uint32_t>(t), static_cast<uint32_t>(v),
                      static_cast<uint32_t>(e), static_cast<uint32_t>(w),
                      static_cast<uint32_t>(runs), k0, k1, thr);
        if (fire) atomicOr(hit + vi, fire);
      }
    }
    ic::grid_barrier(&ctl->barrier, epoch);

    unsigned long long mine = 0;
    for (long long i = first; i < items; i += stride) {
      const uint32_t h = __ldcg(hit + i);
      if (h) {
        const uint32_t a = __ldcg(active + i);
        const uint32_t newly = h & ~a;
        active[i] = a | newly;
        frontier[i] = newly;
        hit[i] = 0u;
        mine += __popc(newly);
      } else if (__ldcg(frontier + i)) {
        frontier[i] = 0u;
      }
    }
    const bool go = ic::step_continues(ctl, t, mine, epoch, seen);
    ++t;
    if (!go) break;
  }
  ic::count_columns(active, counts, n, W, B);
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl->steps = t;
}

}  // namespace

// Resident blocks per SM of the scatter kernel at `threads` threads a block
// (which must be 256), or minus a CUDA error.
extern "C" int graphem_ic_scatter_blocks_per_sm(int threads) {
  if (threads != kThreads) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ic_scatter_kernel, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launches one cascade on `stream` as a cooperative kernel and returns a
// CUDA error code (0 on success). src and dst are (E2,) int32 directed
// edges with endpoints in [0, n); seed, active, frontier and hit are (n,
// W) 32-bit words, the last three uninitialized; key is (2,) int64 on the
// device (two 32-bit Philox key words); ctl is CTL_WORDS + B int32, zeroed
// by the caller: the control block, then the (B,) counts. Column b draws
// the coins of run b mod runs. nb is the grid, at most the resident block
// count. The wrapper checks the shapes and types.
extern "C" int graphem_ic_scatter_launch(
    const int32_t* src, const int32_t* dst, const uint32_t* seed,
    uint32_t* active, uint32_t* frontier, uint32_t* hit,
    const long long* key, int* ctl_words, int n, long long E2, int W, int B,
    int runs, unsigned long long thr, int max_iters, int nb, void* stream) {
  if (n < 1 || E2 < 0 || E2 >= (1ll << 31) || W < 1 || B < 1 ||
      B > 32 * W || static_cast<long long>(n) * W >= (1ll << 31) ||
      runs < 1 || nb < 1 || max_iters < 0 || thr > (1ull << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ctl* ctl = reinterpret_cast<Ctl*>(ctl_words);
  int* counts = ctl_words + sizeof(Ctl) / sizeof(int);
  void* args[] = {&src, &dst,    &seed, &active, &frontier, &hit,
                  &key, &ctl,    &counts, &n,    &E2,       &W,
                  &B,   &runs,   &thr,   &max_iters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ic_scatter_kernel), dim3(nb),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
