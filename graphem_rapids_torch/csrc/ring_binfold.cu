// Ring bin-fold hop kernel (K3): fold one rank's ref tile into the per-bin
// minima of a query shard, then min-merge the carry that arrived from the
// left neighbour.
//
// Replaces the TPU Pallas kernels graphem_rapids_tpu/parallel/ring_binfold.py
// `_kernel` and `_kernel_hbm` (launched by `ring_binfold_topk`). On the TPU
// one kernel runs every hop of the ring and moves the carry to the right
// neighbour by an in-kernel remote copy with semaphore flow control. Hopper
// has no remote copy across processes from inside a kernel, so here each hop
// is one launch of this kernel, and the carry travels between launches by
// NCCL point-to-point (torch.distributed batch_isend_irecv, in
// graphem_rapids_torch/parallel/ring_binfold.py). The VMEM/HBM split of the
// TPU is not needed: the carry lives in device memory.
//
// Semantics, bit for bit those of the TPU kernels and of the plain version
// ring_fold_reference:
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
//     equals a merge with (3.0e38, 0).
// The output may alias the carry: the one thread that writes a bin reads
// the carry there first, and no other thread touches either.
//
// What bounds it on an H100: 3 * DIM + 2 fp32 instructions per (query,
// ref) pair, as in K1 (binfold.cu), 11 at d=3: 512 x 5,701,632 x 11 =
// 3.21e10 per hop at the one-rank 1M-vertex shape, 0.960 ms at 132 SMs x
// 128 lanes x 1980 MHz, against 4 * (S * DIM + E * DIM) bytes of queries
// and refs plus 8 * S * G * 128 of bins out and as much of carry in, about
// 0.1 GB and 0.03 ms: issue slots are the limit.
//
// Why this plan: a grid of one block per (bin group, 16 queries), each
// sweeping all n_super super-tiles, does not match the card's resident
// slots at any shape the ring runs: 768 blocks on 660 slots (1.16 waves)
// at the one-rank 1M shape, 192 (29% of them) on a four-card tile, 96 on
// 64 queries. A grid of the resident count over equal unit ranges runs one
// full wave at every shape (PERF.md has the times of both).
//
// Design: K1's plan (fold_plan.cuh), with the ring epilogue
// (merge_bins): the grid is the resident block count, each block walks
// an equal range of (bin group, query block, super-tile) units, and the
// pieces of a cut run, which pack the local p, are folded by the block that
// completes their segment. Only the thread that writes a bin applies the
// offset and reads the carry, after the sweep, which does not touch it;
// the thread loads all its carry bins before it stores any. The carry and
// the output are not __restrict__, for the in-place merge. Overlapping the
// fold with the transfer is later work.

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
