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
// max_iters steps. coin(t, v, j, b) = philox4x32_10(counter = (b >> 2, j,
// v, t), key)[b & 3] < thr, thr = floor(p * 2^32) in [0, 2^32].
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
// sums, deterministic.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Columns counted per pass of the final count (shared memory, 16 KB).
constexpr int kCountCols = 4096;

// The wrapper's zeroed control words (ops/ic_cascade.py CTL_WORDS).
struct Ctl {
  unsigned long long newly[2];  // activations so far, by step parity
  unsigned long long barrier;   // grid-barrier arrivals, monotonic
  unsigned int steps;           // steps run, written at the end
  unsigned int pad;
};
static_assert(sizeof(Ctl) == 32, "Ctl is CTL_WORDS int32 words");

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
  }
}

// The bits of `cand` (columns 32 w + i of vertex v) whose coin at step t,
// slot j fires: one Philox draw per nibble that holds a candidate.
__device__ __forceinline__ uint32_t fired(uint32_t cand, uint32_t t,
                                          uint32_t v, uint32_t j, uint32_t w,
                                          uint32_t k0, uint32_t k1,
                                          unsigned long long thr) {
  uint32_t out = 0;
  while (cand) {
    const int g = (__ffs(cand) - 1) >> 2;
    uint32_t c[4] = {w * 8u + static_cast<uint32_t>(g), j, v, t};
    philox4x32_10(c, k0, k1);
    const uint32_t f = (c[0] < thr ? 1u : 0u) | (c[1] < thr ? 2u : 0u) |
                       (c[2] < thr ? 4u : 0u) | (c[3] < thr ? 8u : 0u);
    out |= (f << (4 * g)) & cand;
    cand &= ~(0xFu << (4 * g));
  }
  return out;
}

// All blocks of the (cooperative) grid meet here; `epoch` counts this
// block's barriers. Writes before it are visible to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned long long* bar,
                                             unsigned long long& epoch) {
  __syncthreads();
  ++epoch;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1ull);
    const unsigned long long target = epoch * gridDim.x;
    while (*reinterpret_cast<volatile unsigned long long*>(bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ic_cascade_kernel(const int32_t* __restrict__ table,
                  const int32_t* __restrict__ ov_ptr,
                  const int32_t* __restrict__ ov_src,
                  const uint32_t* __restrict__ seed, uint32_t* active,
                  uint32_t* frontier, const long long* __restrict__ key,
                  Ctl* ctl, int* counts, int n, int cap, int W, int B,
                  unsigned long long thr, int max_iters) {
  __shared__ unsigned long long s_sum[kWarps];
  __shared__ int s_go;
  __shared__ int s_cnt[kCountCols];
  const long long items = static_cast<long long>(n) * W;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long epoch = 0;
  unsigned long long seen[2] = {0ull, 0ull};  // thread 0's last totals

  int t = 0;
  if (max_iters <= 0) {
    for (long long i = first; i < items; i += stride) active[i] = seed[i];
    grid_barrier(&ctl->barrier, epoch);
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
        if (f) hit |= fired(f, t, v, j, w, k0, k1, thr);
      }
      const int o1 = __ldg(ov_ptr + v + 1);
      for (int o = __ldg(ov_ptr + v); o < o1 && ~(a | hit); ++o) {
        const long long u = __ldg(ov_src + o);
        const uint32_t f = __ldcg(cur + u * W + w) & ~(a | hit);
        if (f) hit |= fired(f, t, v, cap + o, w, k0, k1, thr);
      }
      active[i] = a | hit;  // hit holds only columns not active at v
      nxt[i] = hit;
      mine += __popc(hit);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) mine += __shfl_down_sync(~0u, mine, d);
    if (lane == 0) s_sum[warp] = mine;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long block = 0;
      for (int k = 0; k < kWarps; ++k) block += s_sum[k];
      if (block) atomicAdd(&ctl->newly[t & 1], block);
    }
    grid_barrier(&ctl->barrier, epoch);
    if (threadIdx.x == 0) {
      const unsigned long long total = __ldcg(&ctl->newly[t & 1]);
      s_go = total != seen[t & 1];
      seen[t & 1] = total;
    }
    __syncthreads();
    ++t;
    if (!s_go) break;
  }

  // counts: per pass, kCountCols columns; a warp takes 32 vertices of one
  // word, one ballot per bit, and lane i adds column 32 w + i's count
  const long long gwarp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long nwarps = stride >> 5;
  const long long vchunks = (n + 31) / 32;
  for (int c0 = 0; c0 < B; c0 += kCountCols) {
    const int ncol = min(kCountCols, B - c0);
    const int w0 = c0 / 32;
    const int nw = (ncol + 31) / 32;
    for (int c = threadIdx.x; c < ncol; c += kThreads) s_cnt[c] = 0;
    __syncthreads();
    for (long long u = gwarp; u < vchunks * nw; u += nwarps) {
      const int wl = static_cast<int>(u % nw);
      const long long v = (u / nw) * 32 + lane;
      const uint32_t x = v < n ? __ldcg(active + v * W + w0 + wl) : 0u;
      int my = 0;
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        const int c = __popc(__ballot_sync(~0u, (x >> bit) & 1u));
        if (lane == bit) my = c;
      }
      const int col = wl * 32 + lane;
      if (my && col < ncol) atomicAdd(&s_cnt[col], my);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < ncol; c += kThreads) {
      if (s_cnt[c]) atomicAdd(counts + c0 + c, s_cnt[c]);
    }
    __syncthreads();
  }
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
// nb is the grid, at most the resident block count. The wrapper checks the
// shapes and types.
extern "C" int graphem_ic_cascade_launch(
    const int32_t* table, const int32_t* ov_ptr, const int32_t* ov_src,
    const uint32_t* seed, uint32_t* active, uint32_t* frontier,
    const long long* key, int* ctl_words, int n, int cap, int W, int B,
    unsigned long long thr, int max_iters, int nb, void* stream) {
  if (n < 1 || cap < 1 || W < 1 || B < 1 || B > 32 * W || nb < 1 ||
      max_iters < 0 || thr > (1ull << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ctl* ctl = reinterpret_cast<Ctl*>(ctl_words);
  int* counts = ctl_words + sizeof(Ctl) / sizeof(int);
  void* args[] = {&table, &ov_ptr, &ov_src, &seed,  &active,
                  &frontier, &key, &ctl, &counts, &n,
                  &cap, &W, &B, &thr, &max_iters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ic_cascade_kernel), dim3(nb),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
