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
// Design. The grid is the card's resident block count (a cooperative
// launch, so every block is resident and a grid-wide barrier is safe).
// Each step strides over the (vertex, word) pairs; a thread reads one
// frontier word per in-neighbour, keeps the bits whose column is neither
// active nor already hit at v, and draws Philox only for those (one draw
// serves the four columns of a nibble), then writes newly and active. A
// block sums popcount(newly) and adds it to a 64-bit total for the step's
// parity; after the grid barrier every block reads that total, and the
// cascade stops where it did not grow. Stopping needs nothing reset: a
// parity's total is next added to two steps later, after the barrier that
// every block passes only once it has read it. The frontier is double
// buffered by step parity (step 0 reads the seed words); state written
// during the launch is read with ld.global.cg, so no stale L1 line is
// seen across the barrier. At the end each block counts the active bits
// of its columns in shared memory (one ballot per bit over 32 vertices of
// a word) and adds one integer per column to the (B,) counts: integer
// sums, deterministic. The coins, the barrier, the stop test and the count
// are ic_common.cuh's, shared with the scatter form (ic_scatter.cu).
//
// What bounds it on an H100: the bytes of each step. At the 1M-vertex
// plan (ring + 3M chords, cap 13, 35,188 overflow in-edges) with B = 64
// (W = 2) one step reads the table (n * cap * 4 = 52 MB), one 32-byte
// sector per gathered frontier word (13M * 32 = 416 MB) and the active and
// frontier words (about 32 MB): about 0.5 GB, 0.15 ms at 3.35 TB/s, so
// about 5 ms for 33 steps. At 100K vertices the whole state fits in the
// 50 MB L2. Reading each input once and writing each output once is far
// less (72 MB at 1M, 0.02 ms); the gap is the per-step gather, which only a
// cascade that keeps its state on chip would avoid. On an NVIDIA H100 80GB
// HBM3 at 700 W a 22-step cascade at 1M took 2.26 ms back to back, below
// the per-step model: the 8 MB of frontier words stay in L2 (PERF.md).
//
// Load balance: one thread per (vertex, word) walks the vertex's cap slots
// and its overflow range. The plan's overflow is at most 10 in-edges a
// vertex at 1M; a star's hub walks its whole overflow list (77 in-edges
// past cap 3 for the 80-leaf hub of the greedy test graph) while the other
// threads of its warp wait, once per step and word, until every column of
// the word is active or hit.

#include <cstdint>

#include <cuda_runtime.h>

#include "ic_common.cuh"

namespace {

using ic::Ctl;
using ic::kThreads;

__global__ void __launch_bounds__(kThreads)
ic_cascade_kernel(const int32_t* __restrict__ table,
                  const int32_t* __restrict__ ov_ptr,
                  const int32_t* __restrict__ ov_src,
                  const uint32_t* __restrict__ seed, uint32_t* active,
                  uint32_t* frontier, const long long* __restrict__ key,
                  Ctl* ctl, int* counts, int n, int cap, int W, int B,
                  int runs, unsigned long long thr, int max_iters) {
  const long long items = static_cast<long long>(n) * W;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  unsigned long long epoch = 0;
  unsigned long long seen[2] = {0ull, 0ull};  // thread 0's last totals

  int t = 0;
  if (max_iters <= 0) {
    for (long long i = first; i < items; i += stride) active[i] = seed[i];
    ic::grid_barrier(&ctl->barrier, epoch);
  }
  while (t < max_iters) {
    const uint32_t* cur = t == 0 ? seed : frontier + (t & 1) * items;
    uint32_t* nxt = frontier + ((t + 1) & 1) * items;
    unsigned long long mine = 0;
    for (long long i = first; i < items; i += stride) {
      const int v = static_cast<int>(i / W);
      const int w = static_cast<int>(i - static_cast<long long>(v) * W);
      const uint32_t a = t == 0 ? seed[i] : active[i];
      uint32_t hit = 0;
      const int32_t* row = table + static_cast<long long>(v) * cap;
      for (int j = 0; j < cap && ~(a | hit); ++j) {
        const long long u = __ldg(row + j);
        const uint32_t f = __ldcg(cur + u * W + w) & ~(a | hit);
        if (f) hit |= ic::fired(f, t, v, j, w, runs, k0, k1, thr);
      }
      const int o1 = __ldg(ov_ptr + v + 1);
      for (int o = __ldg(ov_ptr + v); o < o1 && ~(a | hit); ++o) {
        const long long u = __ldg(ov_src + o);
        const uint32_t f = __ldcg(cur + u * W + w) & ~(a | hit);
        if (f) hit |= ic::fired(f, t, v, cap + o, w, runs, k0, k1, thr);
      }
      active[i] = a | hit;  // hit holds only columns not active at v
      nxt[i] = hit;
      mine += __popc(hit);
    }
    const bool go = ic::step_continues(ctl, t, mine, epoch, seen);
    ++t;
    if (!go) break;
  }
  ic::count_columns(active, counts, n, W, B);
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl->steps = t;
}

}  // namespace

// Resident blocks per SM of the cascade kernel at `threads` threads a block
// (which must be 256), or minus a CUDA error.
extern "C" int graphem_ic_cascade_blocks_per_sm(int threads) {
  if (threads != kThreads) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ic_cascade_kernel, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launches one cascade on `stream` as a cooperative kernel and returns a
// CUDA error code (0 on success). table (n, cap), ov_ptr (n + 1,) and
// ov_src (O,) are int32; seed, active and frontier are (n, W), (n, W) and
// (2, n, W) 32-bit words, active and frontier uninitialized; key is (2,)
// int64 on the device (two 32-bit Philox key words); ctl is CTL_WORDS + B
// int32, zeroed by the caller: the control block, then the (B,) counts.
// Column b draws the coins of run b mod runs. nb is the grid, at most the
// resident block count. The wrapper checks the shapes and types.
extern "C" int graphem_ic_cascade_launch(
    const int32_t* table, const int32_t* ov_ptr, const int32_t* ov_src,
    const uint32_t* seed, uint32_t* active, uint32_t* frontier,
    const long long* key, int* ctl_words, int n, int cap, int W, int B,
    int runs, unsigned long long thr, int max_iters, int nb, void* stream) {
  if (n < 1 || cap < 1 || W < 1 || B < 1 || B > 32 * W || runs < 1 ||
      nb < 1 || max_iters < 0 || thr > (1ull << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ctl* ctl = reinterpret_cast<Ctl*>(ctl_words);
  int* counts = ctl_words + sizeof(Ctl) / sizeof(int);
  void* args[] = {&table, &ov_ptr, &ov_src, &seed,  &active,
                  &frontier, &key, &ctl, &counts, &n,
                  &cap, &W, &B, &runs, &thr, &max_iters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ic_cascade_kernel), dim3(nb),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
