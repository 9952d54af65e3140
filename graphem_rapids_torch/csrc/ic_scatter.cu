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
// Design. The step is ic_common.cuh's frontier-driven step, shared with the
// gather form (ic_cascade.cu): a step whose queue has few out-pairs pushes
// from the frontier's vertices along the push lists (the directed edges
// sorted by source: receiver dst[e], slot e), and only the vertices hit
// and the queue's are touched besides; one grid barrier a step. This file
// brings the dense pass, taken where the queue's pairs pass dense_limit
// (the wrapper's DENSE_BETA times G times 2E): the edge sweep, a thread
// per directed edge (consecutive threads, consecutive edges: src is read
// coalesced) walking its W words; for a frontier word of src[e] that is
// not zero it reads dst[e], keeps the bits whose column is neither active
// nor (by a racy read) already hit at the receiver, draws Philox only for
// those and ORs the fired bits into the step's hit buffer with atomicOr.
// 2E and n * W each stay below 2^31 (the wrapper checks), so e and v fit
// the 32-bit counter words.
//
// What bounds it on an H100: latency. What a cascade must move is the seed
// words read and the active words written (2 n W words) and, of the push
// lists, only the pairs behind the frontier and their sources' row
// starts: at the smallest graph of bench.py's scale family that takes
// this path (ring + 36M chords, n = 12,000,000, 2E = 95,999,964) with B =
// 64 (W = 2) and p = 0.1 about 192 MB, 0.057 ms at 3.35 TB/s (at p = 0.1
// about 13,000 directed edges lie behind the frontier over the whole
// cascade). A push step is a chain of dependent L2 round trips and one
// grid barrier of 264 arrivals; what is left is the n W state's
// initialization and count, once a cascade. A dense step reads src (384
// MB) and a 32-byte sector of every edge's frontier row (the 96 MB of a
// frontier buffer does not stay in the 50 MB L2): about 1.1 ms, what every
// step cost before the push steps. PERF.md has the times
// (scripts/torch_ic_times.py).
//
// Load balance: a push step hands out the queue's pairs by their offsets,
// so a hub's row spreads over as many warps as its pairs fill; a dense step
// gives every edge one thread.

#include <cstdint>

#include <cuda_runtime.h>

#include "ic_common.cuh"

namespace {

using ic::kThreads;

struct ScatterDense {
  const int32_t* src;
  const int32_t* dst;
  long long E2;

  __device__ __forceinline__ void operator()(const ic::Cascade& c, int t,
                                             uint32_t k0, uint32_t k1) const {
    const int lane = threadIdx.x & 31;
    const uint32_t* frontier = c.hit((t + 2) % 3);
    uint32_t* hit = c.hit(t % 3);
    for (long long base = ic::global_warp() * 32; base < E2;
         base += ic::grid_warps() * 32) {
      const long long e = base + lane;
      bool app = false;
      int v = -1;
      if (e < E2) {
        const long long u = __ldg(src + e);
        const uint32_t* fu = frontier + u * c.W;
        bool any = false;
        for (int w = 0; w < c.W; ++w) {
          uint32_t f = __ldcg(fu + w);
          if (!f) continue;
          if (v < 0) v = __ldg(dst + e);
          const long long vi = static_cast<long long>(v) * c.W + w;
          f &= ~(__ldcg(c.active + vi) | __ldcg(frontier + vi) |
                 __ldcg(hit + vi));
          if (!f) continue;
          const uint32_t fire =
              ic::fired(f, static_cast<uint32_t>(t), static_cast<uint32_t>(v),
                        static_cast<uint32_t>(e), static_cast<uint32_t>(w),
                        static_cast<uint32_t>(c.runs), k0, k1, c.thr);
          if (fire) {
            atomicOr(hit + vi, fire);
            any = true;
          }
        }
        app = any && ic::touch(c.stamp(), v, t);
      }
      ic::append(c, t % 3, app, v);
    }
  }
};

__global__ void __launch_bounds__(kThreads, ic::kMinBlocks)
ic_scatter_kernel(ic::Cascade c, ScatterDense dense) {
  ic::run(c, dense);
}

}  // namespace

// Resident blocks per SM of the scatter kernel at `threads` threads a block
// (which must be ic::kThreads), or minus a CUDA error.
extern "C" int graphem_ic_scatter_blocks_per_sm(int threads) {
  if (threads != kThreads) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ic_scatter_kernel, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launches one cascade on `stream` as a cooperative kernel and returns a
// CUDA error code (0 on success). src and dst are (E2,) int32 directed
// edges with endpoints in [0, n); out_ptr (n + 1,), out_recv and out_slot
// (P,) are their push lists (int32); seed and active are (n, W) 32-bit
// words and hits (3, n, W), the last two uninitialized; lists is (7, n)
// int32 scratch; key is (2,) int64 on the device (two 32-bit Philox key words);
// ctl is CTL_WORDS + B int32, zeroed by the caller: the control block,
// then the (B,) counts. Column b draws the coins of run b mod runs. G is
// min(32, 2^ceil(log2 W)); a step of more than dense_limit pairs behind
// the frontier is dense. nb is the grid, at most the resident block count.
// The wrapper checks the shapes and types.
extern "C" int graphem_ic_scatter_launch(
    const int32_t* src, const int32_t* dst, const int32_t* out_ptr,
    const int32_t* out_recv, const int32_t* out_slot, const uint32_t* seed,
    uint32_t* active, uint32_t* hits, int* lists,
    const long long* key, int* ctl_words, int n, long long E2, int W, int B,
    int runs, int G, unsigned long long thr, int max_iters,
    long long dense_limit, int nb, void* stream) {
  if (n < 1 || E2 < 0 || E2 >= (1ll << 31) || W < 1 || B < 1 ||
      B > 32 * W || static_cast<long long>(n) * W >= (1ll << 31) ||
      runs < 1 || G < 1 || G > 32 || (G & (G - 1)) || nb < 1 ||
      max_iters < 0 || thr > (1ull << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ic::Cascade c{seed, active, hits, lists, out_ptr, out_recv,
                out_slot, key, reinterpret_cast<ic::Ctl*>(ctl_words),
                ctl_words + sizeof(ic::Ctl) / sizeof(int), n, W, B, runs, G,
                max_iters, thr, dense_limit};
  ScatterDense dense{src, dst, E2};
  void* args[] = {&c, &dense};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ic_scatter_kernel), dim3(nb),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
