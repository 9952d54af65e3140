// Ring bin-fold kernel (K3): fold one rank's ref tile into the per-bin
// minima of a query shard, min-merge the carry that arrived from the left
// neighbour, and hand the merged carry to the right neighbour.
//
// Replaces the TPU Pallas kernels graphem_rapids_tpu/parallel/ring_binfold.py
// `_kernel` and `_kernel_hbm` (launched by `ring_binfold_topk`). The TPU runs
// the whole ring in one pallas_call, grid (ndev, G, n_super), and its
// `_merge_send` stores the merged carry into the right neighbour's
// double-buffered slot by an in-kernel remote copy, with semaphores for flow
// control, so the transfer of hop h overlaps the fold of hop h + 1. A Hopper
// kernel can do the same over NVLink: it stores into, and polls, memory of
// another card once that memory is mapped into its process (CUDA IPC). Two
// launches here:
//   - ring_run_kernel, the ring: one launch per ring call runs every hop (or
//     a range of hops, for the one-card checks); see "The whole ring" below;
//   - ring_fold_kernel, one hop: the fold and the merge of one hop into a
//     caller's buffer, as each hop of the ring runs it; kept for the timing
//     script and the per-hop checks.
// The VMEM/HBM split of the TPU is not needed: the carry lives in device
// memory.
//
// Semantics, bit for bit those of the TPU kernels and of the plain version
// ring_fold_reference, hop by hop:
//   - the ref at local position p (tile p / T, lane p % 128) folds into bin
//     ((p / T) % G) * 128 + p % 128 with the global id offset + p, where
//     offset = rank * R_pad (the caller keeps ranks * R_pad below 2^24, so
//     the ids are the TPU's fp32 id lanes, exactly);
//   - its squared distance to a query is accumulated coordinate by
//     coordinate in order, d = 0; d = d + diff * diff, in fp32 with
//     round-to-nearest and no fused multiply-add (the intrinsics, and
//     --fmad=false); the first add, 0 + diff * diff, is exact and not
//     issued;
//   - a bin keeps (value, id) of the first strict minimum in visit order,
//     starting from (3.0e38, 0), so the lowest p wins ties inside a tile and
//     a bin that only sees +inf (the engine's 1e30 pad refs) keeps
//     (3.0e38, 0);
//   - positions p >= E read the pad coordinate 1.0e15 (finite squared
//     distance ~1e30), as the TPU wrapper pads its transposed refs;
//   - the merge keeps the tile's bin only where it is strictly below the
//     carry's (bins < carry), so the carry, the ranks folded before, wins a
//     tie. Without a carry (hop 0) the bins are written as they are, which
//     equals a merge with (3.0e38, 0);
//   - at hop h rank i folds query shard (i - h) mod ndev; after ndev hops
//     rank i holds the merged bins of shard (i + 1) mod ndev.
// The output of one hop may alias the carry: the one thread that writes a
// bin reads the carry there first, and no other thread touches either.
//
// What bounds it on an H100: 3 * DIM + 2 fp32 instructions per (query,
// ref) pair, as in K1 (binfold.cu), 11 at d=3: 512 x 5,701,632 x 11 =
// 3.21e10 per hop at the one-rank 1M-vertex shape, 0.960 ms at 132 SMs x
// 128 lanes x 1980 MHz, against 4 * (S * DIM + E * DIM) bytes of queries
// and refs plus 8 * S * G * 128 of bins out and as much of carry in, about
// 0.1 GB and 0.03 ms: issue slots are the limit. The carry a hop sends is
// 8 * S_loc * G * 128 bytes, 3.1 MB on a four-card 1M tile: ~7 us at
// NVLink's 450 GB/s each way, against a hop's fold of ~0.11 ms.
//
// Why this plan: a grid of one block per (bin group, 16 queries), each
// sweeping all n_super super-tiles, does not match the card's resident
// slots at any shape the ring runs: 768 blocks on 660 slots (1.16 waves)
// at the one-rank 1M shape, 192 (29% of them) on a four-card tile, 96 on
// 64 queries. A grid of the resident count over equal unit ranges runs one
// full wave at every shape (PERF.md has the times of both).
//
// Design of a hop: K1's plan (fold_plan.cuh), with the ring epilogue
// (merge_bins): the grid is the resident block count, each block walks
// an equal range of (bin group, query block, super-tile) units, and the
// pieces of a cut run, which pack the local p, are folded by the block that
// completes their segment. Only the thread that writes a bin applies the
// offset and reads the carry, after the sweep, which does not touch it;
// the thread loads all its carry bins before it stores any. The carry and
// the output are not __restrict__, for the in-place merge.
//
// The whole ring. Each rank owns one region of device memory (RingLayout),
// allocated once per ring geometry by cudaMalloc (IPC maps base
// allocations only, not a caching allocator's sub-blocks), zeroed, and
// mapped by its two neighbours through cudaIpcOpenMemHandle:
//   slot[2]     the carry's double buffer, which the LEFT neighbour stores
//               into;
//   arrived[2]  one flag per block of the left neighbour, per slot;
//   freed[2]    one flag per block of the RIGHT neighbour, per slot: it has
//               merged out of the slot of ours that we store into;
//   counters    epoch (ring calls completed), hop_done[2] (block-hops
//               done here, by hop parity), done (blocks that finished a
//               ring call);
//   seg[2], part[2]  the plan's segment counts and pieces, one per hop
//               parity, so a block may start hop g + 1 while another still
//               folds the pieces of hop g.
// Transfers are numbered t = epoch * (ndev - 1) + h for the carry sent at
// hop h < ndev - 1; it goes to the right neighbour's slot t % 2, which that
// rank merges at its hop h + 1. Every number is monotonic over the life of
// the region: flags hold t + 1, counts only grow, and the epoch is advanced
// by the kernel itself (the block that finishes a ring call last), so a
// replay of a captured graph reads the next epoch and never a stale flag,
// and nothing is reset between ring calls. Per hop, per block:
//   1. wait until every block here finished hop g - 2, whose parity
//      buffers hop g reuses: hop_done[g % 2] >= nb * (g / 2). One count per
//      parity, because blocks finish hops out of order: a block may finish
//      hop g - 1 while another is still in hop g - 2, and one count of all
//      hops would then reach nb * (g - 1) too early (the one-card
//      concurrent test caught that race);
//   2. the sweep of hop g (no waiting: this overlaps the neighbours);
//   3. before the block's first epilogue (the hook): wait until all of the
//      left's blocks flagged arrived[t_in % 2] >= t_in + 1 (the carry is
//      complete) and, before storing into the right's slot t_out % 2, until
//      all of the right's blocks flagged freed[t_out % 2] >= t_out - 1 (it
//      merged transfer t_out - 2 out of it): JAX's ready_sem rule, whose
//      comment records the one-hop overrun a sender without it commits;
//   4. merge, storing into the right's slot (the last hop: the output);
//   5. __threadfence_system(), then thread 0 flags arrived[t_out % 2] = t_out
//      + 1 in the right's region, freed[t_in % 2] = t_in + 1 in the left's
//      (st.release.sys), and counts the hop in hop_done[g % 2].
// Readers poll with ld.acquire.sys and read the carry through L2.
// Why no deadlock: every wait of hop h is for hops below h, of this rank
// or a neighbour, and every block is resident (the grid is at most the
// resident count, the plan's one wave), so no waiting block keeps a block
// it waits for off the card. Across ranks, every rank issues the same
// collectives in the same order before K3, so every rank reaches its
// launch. A wait that exceeds kWaitNs of the global timer traps: the launch
// fails with a CUDA error and the run exits non-zero instead of hanging.

#include <string.h>

#include "fold_plan.cuh"

using namespace graphem_fold;

namespace {

template <int DIM>
__global__ void __launch_bounds__(kLanes, Fold<DIM>::kMinBlocks)
ring_fold_kernel(const float* __restrict__ queries,
                 const float* __restrict__ refs, const float* carry_vals,
                 const int32_t* carry_idx, float* out_vals, int32_t* out_idx,
                 float* __restrict__ part_v, int32_t* __restrict__ part_i,
                 int* __restrict__ seg_done, int S, int E, int T, int G,
                 int n_super, int offset, int n_qblk, int nb) {
  fold_units<DIM, true>(queries, refs, carry_vals, carry_idx, out_vals,
                        out_idx, part_v, part_i, seg_done, S, E, T, G,
                        n_super, n_qblk, nb, offset);
}

template <int DIM>
int launch(const float* q, const float* refs, const float* cv,
           const int32_t* ci, float* ov, int32_t* oi, float* part_v,
           int32_t* part_i, int* seg_done, int S, int E, int T, int G,
           int n_super, int offset, int nb, cudaStream_t stream) {
  const int n_qblk = (S + Fold<DIM>::QB - 1) / Fold<DIM>::QB;
  const int err = zero_segments(seg_done, G, n_qblk, stream);
  if (err != 0) return err;
  ring_fold_kernel<DIM><<<nb, kLanes, 0, stream>>>(
      q, refs, cv, ci, ov, oi, part_v, part_i, seg_done, S, E, T, G, n_super,
      offset, n_qblk, nb);
  return static_cast<int>(cudaGetLastError());
}

template <int DIM>
int occupancy() {
  return blocks_per_sm(ring_fold_kernel<DIM>);
}

// ---- the whole ring ------------------------------------------------------

using u64 = unsigned long long;

// A wait that has not been met after this long traps (10 s of the global
// timer, some 10^8 polls).
constexpr u64 kWaitNs = 10ull * 1000 * 1000 * 1000;

size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

// Byte offsets of a rank's region; every rank's has the same layout.
struct RingLayout {
  long long slot_v[2], slot_i[2], arrived, freed, ctr, seg[2], part_v[2],
      part_i[2], total;
};

RingLayout ring_layout(int S, int G, int qb, int nb) {
  RingLayout L;
  const size_t bins = (size_t)S * G * kLanes;
  const size_t n_seg = (size_t)G * ((S + qb - 1) / qb);
  const size_t part = (size_t)nb * 2 * qb * kLanes;
  size_t off = 0;
  for (int x = 0; x < 2; ++x) {
    L.slot_v[x] = off;
    off = align_up(off + bins * sizeof(float));
    L.slot_i[x] = off;
    off = align_up(off + bins * sizeof(int32_t));
  }
  L.arrived = off;
  off = align_up(off + 2 * (size_t)nb * sizeof(u64));
  L.freed = off;
  off = align_up(off + 2 * (size_t)nb * sizeof(u64));
  L.ctr = off;
  off = align_up(off + 4 * sizeof(u64));
  for (int x = 0; x < 2; ++x) {
    L.seg[x] = off;
    off = align_up(off + n_seg * sizeof(u64));
    L.part_v[x] = off;
    off = align_up(off + part * sizeof(float));
    L.part_i[x] = off;
    off = align_up(off + part * sizeof(int32_t));
  }
  L.total = off;
  return L;
}

__device__ __forceinline__ u64 ld_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Until every flags[0, n) >= want, polled by the whole block; traps after
// kWaitNs. Uniform in the block.
__device__ __forceinline__ void wait_flags(const u64* flags, int n,
                                           u64 want) {
  const u64 t0 = global_ns();
  for (;;) {
    int ok = 1;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      ok &= ld_acquire_sys(flags + j) >= want;
    }
    if (__syncthreads_and(ok)) break;
    if (global_ns() - t0 > kWaitNs) __trap();
  }
}

// One hop's pointers and waits, set by thread 0 of each block before the
// hop's fold and read by its threads where they are used: kept in
// registers through the sweep, they cost the sweep its registers (ptxas
// spilled at d=3).
struct HopState {
  const float* queries;
  const float* carry_vals;  // NULL at hop 0
  const int32_t* carry_idx;
  float* out_vals;  // the right's slot, or the output at the last hop
  int32_t* out_idx;
  float* part_v;
  int32_t* part_i;
  u64* seg_done;
  u64 seg_target;
  const u64* arrived;  // NULL: no carry (hop 0)
  u64 arrived_want;
  const u64* freed;  // NULL: no wait (the last hop, or a slot never used)
  u64 freed_want;
  u64* hops_done;      // hop_done[g % 2]
  u64 hops_done_want;  // to wait for first (0: none)
  // this block's flag in the right's arrived[] (-1 at the last hop, which
  // sends nothing) and in the left's freed[] (-1 at hop 0, which merges
  // nothing), and the values they get
  long long arrive_flag;
  u64 arrive_value;
  long long free_flag;
  u64 free_value;
  u64* counters;  // the loop's state: this region's counters, the epoch,
  u64 epoch;      // the hop, and whether this hop's waits are behind
  int h;
  int waited;
  int offset;
  int nb;
};

__shared__ HopState hop_state;

// The ring's hop hook (fold_plan.cuh): segment counts that run on over
// hops and ring calls, the waits for the carry and the right's slot before
// the block's first epilogue of the hop, and the hop's pointers from
// shared memory.
struct RingHop {
  using Count = u64;
  __device__ __forceinline__ Count target(int) const {
    return hop_state.seg_target;
  }
  __device__ __forceinline__ void before_epilogue() {
    if (hop_state.waited) return;
    if (hop_state.arrived != nullptr) {
      wait_flags(hop_state.arrived, hop_state.nb, hop_state.arrived_want);
    }
    if (hop_state.freed != nullptr) {
      wait_flags(hop_state.freed, hop_state.nb, hop_state.freed_want);
    }
    __syncthreads();  // every thread has read `waited`
    if (threadIdx.x == 0) hop_state.waited = 1;
    __syncthreads();
  }
  __device__ __forceinline__ const float* queries(const float*) const {
    return hop_state.queries;
  }
  __device__ __forceinline__ const float* carry_vals(const float*) const {
    return hop_state.carry_vals;
  }
  __device__ __forceinline__ const int32_t* carry_idx(const int32_t*) const {
    return hop_state.carry_idx;
  }
  __device__ __forceinline__ float* out_vals(float*) const {
    return hop_state.out_vals;
  }
  __device__ __forceinline__ int32_t* out_idx(int32_t*) const {
    return hop_state.out_idx;
  }
  __device__ __forceinline__ float* part_v(float*) const {
    return hop_state.part_v;
  }
  __device__ __forceinline__ int32_t* part_i(int32_t*) const {
    return hop_state.part_i;
  }
  __device__ __forceinline__ Count* seg_done(Count*) const {
    return hop_state.seg_done;
  }
  __device__ __forceinline__ int offset(int) const { return hop_state.offset; }
};

// One of two byte offsets, without indexing the parameter array (which
// would copy it to the stack).
__device__ __forceinline__ long long pick(const long long (&off)[2],
                                          u64 parity) {
  return (parity & 1) ? off[1] : off[0];
}

// Thread 0's set-up of hop h of the ring (hop_state), and its flags after
// the hop; see the header.
__device__ __forceinline__ void set_up_hop(
    const float* q_pad, char* self, char* right, const RingLayout& L,
    float* out_vals, int32_t* out_idx, int dim, int rank, int ndev, int h,
    int S, int n_super, int R_pad, int nb) {
  HopState& st = hop_state;
  st.waited = 0;
  const u64 g = st.epoch * ndev + h;
  const u64 t_in = st.epoch * (ndev - 1) + h - 1;  // merged here (h > 0)
  const u64 t_out = t_in + 1;                      // sent right (h < ndev - 1)
  const int shard = ((rank - h) % ndev + ndev) % ndev;
  st.queries = q_pad + (long long)shard * S * dim;
  st.carry_vals = nullptr;
  st.carry_idx = nullptr;
  st.arrived = nullptr;
  st.freed = nullptr;
  st.out_vals = out_vals;
  st.out_idx = out_idx;
  st.arrive_flag = -1;
  st.free_flag = -1;
  if (h > 0) {
    st.carry_vals = reinterpret_cast<const float*>(self + pick(L.slot_v, t_in));
    st.carry_idx =
        reinterpret_cast<const int32_t*>(self + pick(L.slot_i, t_in));
    st.arrived =
        reinterpret_cast<const u64*>(self + L.arrived) + (t_in & 1) * nb;
    st.arrived_want = t_in + 1;
    st.free_flag = (t_in & 1) * nb + blockIdx.x;
    st.free_value = t_in + 1;
  }
  if (h < ndev - 1) {
    st.out_vals = reinterpret_cast<float*>(right + pick(L.slot_v, t_out));
    st.out_idx = reinterpret_cast<int32_t*>(right + pick(L.slot_i, t_out));
    if (t_out >= 2) {
      st.freed =
          reinterpret_cast<const u64*>(self + L.freed) + (t_out & 1) * nb;
      st.freed_want = t_out - 1;
    }
    st.arrive_flag = (t_out & 1) * nb + blockIdx.x;
    st.arrive_value = t_out + 1;
  }
  st.part_v = reinterpret_cast<float*>(self + pick(L.part_v, g));
  st.part_i = reinterpret_cast<int32_t*>(self + pick(L.part_i, g));
  st.seg_done = reinterpret_cast<u64*>(self + pick(L.seg, g));
  st.seg_target = (u64)n_super * (g / 2 + 1);
  st.hops_done = st.counters + 1 + (g & 1);
  st.hops_done_want = (u64)nb * (g / 2);
  st.offset = rank * R_pad;
  st.nb = nb;
}

// Hops [h0, h1) of rank `rank`'s ring; see the header. q_pad (ndev * S,
// DIM) holds every shard; out (S, G * 128) receives the last hop's bins.
// The loop's state (hop, epoch) and each hop's pointers live in shared
// memory, so that the sweep keeps all of its registers.
template <int DIM>
__global__ void __launch_bounds__(kLanes, Fold<DIM>::kMinBlocks)
ring_run_kernel(const float* __restrict__ q_pad,
                const float* __restrict__ refs, char* self, char* right,
                char* left, RingLayout L, float* out_vals, int32_t* out_idx,
                int rank, int ndev, int h0, int h1, int S, int E, int T,
                int G, int n_super, int R_pad, int n_qblk, int nb) {
  if (threadIdx.x == 0) {
    // counters: epoch, hop_done[2], done
    hop_state.counters = reinterpret_cast<u64*>(self + L.ctr);
    hop_state.epoch = *reinterpret_cast<volatile u64*>(hop_state.counters);
    hop_state.h = h0;
  }
  __syncthreads();
  while (hop_state.h < h1) {
    if (threadIdx.x == 0) {
      set_up_hop(q_pad, self, right, L, out_vals, out_idx, DIM, rank, ndev,
                 hop_state.h, S, n_super, R_pad, nb);
    }
    __syncthreads();
    // every block here is done with hop g - 2, whose parity buffers hop g
    // reuses
    if (hop_state.hops_done_want != 0) {
      wait_flags(hop_state.hops_done, 1, hop_state.hops_done_want);
    }
    // the pointer arguments are unused: the hook hands out hop_state's
    fold_units<DIM, true, RingHop>(nullptr, refs, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, S, E,
                                   T, G, n_super, n_qblk, nb, 0, RingHop{});
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0) {
      if (hop_state.arrive_flag >= 0) {
        st_release_sys(reinterpret_cast<u64*>(right + L.arrived) +
                           hop_state.arrive_flag,
                       hop_state.arrive_value);
      }
      if (hop_state.free_flag >= 0) {
        st_release_sys(reinterpret_cast<u64*>(left + L.freed) +
                           hop_state.free_flag,
                       hop_state.free_value);
      }
      atomicAdd(hop_state.hops_done, 1ull);
      hop_state.h += 1;
    }
    __syncthreads();
  }
  if (h1 == ndev && threadIdx.x == 0) {
    __threadfence();
    u64* ctr = hop_state.counters;
    const u64 epoch = hop_state.epoch;
    if (atomicAdd(ctr + 3, 1ull) + 1 == (u64)nb * (epoch + 1)) {
      *reinterpret_cast<volatile u64*>(ctr) = epoch + 1;
    }
  }
}

template <int DIM>
int run_launch(const float* q, const float* refs, char* self, char* right,
               char* left, float* ov, int32_t* oi, int rank, int ndev, int h0,
               int h1, int S, int E, int T, int G, int n_super, int R_pad,
               int nb, cudaStream_t stream) {
  const int qb = Fold<DIM>::QB;
  const RingLayout L = ring_layout(S, G, qb, nb);
  ring_run_kernel<DIM><<<nb, kLanes, 0, stream>>>(
      q, refs, self, right, left, L, ov, oi, rank, ndev, h0, h1, S, E, T, G,
      n_super, R_pad, (S + qb - 1) / qb, nb);
  return static_cast<int>(cudaGetLastError());
}

template <int DIM>
int run_occupancy() {
  return blocks_per_sm(ring_run_kernel<DIM>);
}

int queries_per_block(int dim) { return dim <= 3 ? Fold<3>::QB : Fold<4>::QB; }

}  // namespace

// Resident blocks per SM of the ring hop for this dim, or minus a CUDA
// error.
extern "C" int graphem_ring_fold_blocks_per_sm(int dim) {
  switch (dim) {
    case 1: return occupancy<1>();
    case 2: return occupancy<2>();
    case 3: return occupancy<3>();
    case 4: return occupancy<4>();
    case 5: return occupancy<5>();
    case 6: return occupancy<6>();
    case 7: return occupancy<7>();
    case 8: return occupancy<8>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches one ring hop on `stream` and returns a CUDA error code (0 on
// success). q_shard (S, dim) and refs (E, dim) are contiguous fp32; the
// carry (S, G * 128) fp32 values and int32 ids may be NULL (hop 0); the
// output (S, G * 128) may alias the carry. part_v / part_i are
// (nb, 2, QB, 128) scratch and seg_done is (G * ceil(S / QB),) int
// scratch, zeroed here, with QB = 16 for dim <= 3 and 8 above; nb is the
// grid, 1 <= nb <= the unit count G * ceil(S / QB) * n_super. T must be a
// multiple of 128, dim in 1..8, E <= n_super * G * T and
// offset + n_super * G * T below 2^31; the wrapper checks all of it.
extern "C" int graphem_ring_fold_launch(const float* q_shard, const float* refs,
                                        const float* carry_vals,
                                        const int32_t* carry_idx,
                                        float* out_vals, int32_t* out_idx,
                                        float* part_v, int32_t* part_i,
                                        int* seg_done, int S, int E, int dim,
                                        int T, int G, int n_super, int offset,
                                        int nb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || T < kLanes || T % kLanes || G < 1 || n_super < 1 || nb < 1 ||
      offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define RING_FOLD_CASE(D)                                                   \
  case D:                                                                   \
    return launch<D>(q_shard, refs, carry_vals, carry_idx, out_vals,        \
                     out_idx, part_v, part_i, seg_done, S, E, T, G, n_super, \
                     offset, nb, st);
  switch (dim) {
    RING_FOLD_CASE(1)
    RING_FOLD_CASE(2)
    RING_FOLD_CASE(3)
    RING_FOLD_CASE(4)
    RING_FOLD_CASE(5)
    RING_FOLD_CASE(6)
    RING_FOLD_CASE(7)
    RING_FOLD_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RING_FOLD_CASE
}

// Resident blocks per SM of the whole-ring kernel for this dim, or minus a
// CUDA error.
extern "C" int graphem_ring_run_blocks_per_sm(int dim) {
  switch (dim) {
    case 1: return run_occupancy<1>();
    case 2: return run_occupancy<2>();
    case 3: return run_occupancy<3>();
    case 4: return run_occupancy<4>();
    case 5: return run_occupancy<5>();
    case 6: return run_occupancy<6>();
    case 7: return run_occupancy<7>();
    case 8: return run_occupancy<8>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of one rank's region for shards of S queries of `dim` coordinates,
// G bin groups and a grid of nb blocks.
extern "C" long long graphem_ring_region_bytes(int S, int G, int dim, int nb) {
  return ring_layout(S, G, queries_per_block(dim), nb).total;
}

// A zeroed region of `bytes` on the current device (cudaMalloc, so that
// CUDA IPC can map it); a CUDA error code.
extern "C" int graphem_ring_region_alloc(long long bytes, void** out) {
  *out = nullptr;
  cudaError_t err = cudaMalloc(out, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*out, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

extern "C" int graphem_ring_region_free(void* p) {
  return static_cast<int>(cudaFree(p));
}

// The region's IPC handle, CUDA_IPC_HANDLE_SIZE (64) bytes into `out`.
extern "C" int graphem_ring_ipc_handle(void* p, void* out) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, p);
  if (err == cudaSuccess) memcpy(out, &h, sizeof(h));
  return static_cast<int>(err);
}

// Maps another process's region into this one (peer access enabled).
extern "C" int graphem_ring_ipc_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  *out = nullptr;
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int graphem_ring_ipc_close(void* p) {
  return static_cast<int>(cudaIpcCloseMemHandle(p));
}

// Launches hops [h0, h1) of rank `rank` of an ndev-rank ring on `stream`;
// a CUDA error code. q_pad (ndev * S, dim) and refs (E, dim) are contiguous
// fp32 on the card; `self` is this rank's region, `right` and `left` its
// neighbours' as mapped here (all three the same for one rank), made for
// (S, G, dim, nb); out (S, G * 128) fp32 values and int32 ids receive the
// last hop's bins when h1 == ndev. nb must be the same on every rank and
// at most the kernel's resident block count on the card; the wrapper
// checks the rest as graphem_ring_fold_launch's does.
extern "C" int graphem_ring_run_launch(
    const float* q_pad, const float* refs, void* self, void* right, void* left,
    float* out_vals, int32_t* out_idx, int rank, int ndev, int h0, int h1,
    int S, int E, int dim, int T, int G, int n_super, int R_pad, int nb,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || T < kLanes || T % kLanes || G < 1 || n_super < 1 || nb < 1 ||
      ndev < 1 || rank < 0 || rank >= ndev || h0 < 0 || h1 > ndev ||
      h0 >= h1 || R_pad < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  char* me = static_cast<char*>(self);
  char* r = static_cast<char*>(right);
  char* l = static_cast<char*>(left);
#define RING_RUN_CASE(D)                                                    \
  case D:                                                                   \
    return run_launch<D>(q_pad, refs, me, r, l, out_vals, out_idx, rank,    \
                         ndev, h0, h1, S, E, T, G, n_super, R_pad, nb, st);
  switch (dim) {
    RING_RUN_CASE(1)
    RING_RUN_CASE(2)
    RING_RUN_CASE(3)
    RING_RUN_CASE(4)
    RING_RUN_CASE(5)
    RING_RUN_CASE(6)
    RING_RUN_CASE(7)
    RING_RUN_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RING_RUN_CASE
}
