// Bin-fold kNN kernel (fused squared distances + per-bin running arg-min).
//
// Replaces the TPU Pallas kernel graphem_rapids_tpu/ops/knn_binfold.py
// `_kernel` :87 (launched by `_binfold_padded`). Semantics are the TPU
// kernel's, bit for bit:
//   - the reference at flat position p (tile p / T, lane p % 128) folds into
//     bin ((p / T) % G) * 128 + p % 128;
//   - its squared distance to a query is accumulated coordinate by coordinate
//     in order, d = 0; d = d + diff * diff, in fp32 with round-to-nearest and
//     no fused multiply-add (the intrinsics below, and --fmad=false). The
//     first add, 0 + diff * diff, is exact (a square is +0, positive or NaN),
//     so it is not issued: the bits are the same;
//   - a bin keeps (value, index) of the first strict minimum in visit order
//     (super-tile s, then 128-lane chunk c, which is ascending p), starting
//     from (3.0e38, 0), so the lowest p wins ties and a bin that only sees
//     +inf keeps (3.0e38, 0);
//   - positions p >= E read the pad coordinate 1.0e15 (finite squared
//     distance ~1e30) exactly as the TPU wrapper pads its transposed refs.
// Phase 2 (top-k over the G*128 bins) stays outside, in the Python wrapper.
//
// What bounds it on an H100: 3 * DIM + 2 fp32 instructions per (query,
// ref) pair (DIM subtractions, DIM multiplies, DIM - 1 adds, the compare
// and the two selects of (value, index)), 11 at d=3: 4.71e9 at S=512
// against 800,000 refs (E_pad 835,584), 0.141 ms, and 3.21e10 at 5,699,741
// refs, 0.960 ms, at 132 SMs x 128 lanes x 1980 MHz. The bytes (refs once,
// queries, the (S, G*128) bins) are 10-80 MB, a quarter of that time or
// less, so issue slots are the limit. The sweep (fold_plan.cuh) issues
// those 11 per pair plus a load and the loop step per chunk.
//
// What held the first design back: a grid of (G, ceil(S / 16)) blocks of
// 128 threads, each sweeping all n_super super-tiles of its bin group for
// 16 queries. At 95-96 registers 5 blocks fit on an SM, 660 on the card,
// and S=512, G=24 gives 768 blocks: 1.16 waves, the second running 108
// blocks while 552 slots idle. On an NVIDIA H100 80GB HBM3 at 700.00 W it
// took 0.28-0.33 ms a call at 800,000 refs and 2.33-2.36 ms at 5,699,741;
// back to back at S=416 (624 blocks, one wave) the 1M shape took 52% of
// the S=512 time, not 81% (PERF.md).
//
// Design: the plan of fold_plan.cuh, shared with the ring hop (K3). The
// grid is exactly the resident block count, each block walks an equal
// range of (bin group, query block, super-tile) units, a whole run writes
// the bins directly, and the pieces of a cut run are folded as 64-bit
// (value, p) keys by the block that completes their segment. This file
// instantiates it with the plain epilogue (the ring flag off).

#include "fold_plan.cuh"

using namespace graphem_fold;

namespace {

template <int DIM>
__global__ void __launch_bounds__(kLanes, Fold<DIM>::kMinBlocks)
binfold_kernel(const float* __restrict__ queries, const float* __restrict__ refs,
               float* __restrict__ out_vals, int32_t* __restrict__ out_idx,
               float* __restrict__ part_v, int32_t* __restrict__ part_i,
               int* __restrict__ seg_done, int S, int E, int T, int G,
               int n_super, int n_qblk, int nb) {
  fold_units<DIM, false>(queries, refs, nullptr, nullptr, out_vals, out_idx,
                         part_v, part_i, seg_done, S, E, T, G, n_super,
                         n_qblk, nb, 0);
}

template <int DIM>
int launch(const float* q, const float* refs, float* out_vals, int32_t* out_idx,
           float* part_v, int32_t* part_i, int* seg_done, int S, int E, int T,
           int G, int n_super, int nb, cudaStream_t stream) {
  const int n_qblk = (S + Fold<DIM>::QB - 1) / Fold<DIM>::QB;
  const int err = zero_segments(seg_done, G, n_qblk, stream);
  if (err != 0) return err;
  binfold_kernel<DIM><<<nb, kLanes, 0, stream>>>(
      q, refs, out_vals, out_idx, part_v, part_i, seg_done, S, E, T, G,
      n_super, n_qblk, nb);
  return static_cast<int>(cudaGetLastError());
}

template <int DIM>
int occupancy() {
  return blocks_per_sm(binfold_kernel<DIM>);
}

}  // namespace

// Resident blocks per SM of the fold for this dim, or minus a CUDA error.
extern "C" int graphem_binfold_blocks_per_sm(int dim) {
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

// Launches the bin fold on `stream` and returns a CUDA error code (0 on
// success). queries (S, dim) and refs (E, dim) are contiguous fp32;
// out_vals / out_idx are (S, G * 128); part_v / part_i are (nb, 2, QB, 128)
// scratch and seg_done is (G * ceil(S / QB),) int scratch, zeroed here,
// with QB = 16 for dim <= 3 and 8 above. nb is the grid: 1 <= nb <= the
// unit count G * ceil(S / QB) * n_super. T must be a multiple of 128, dim
// in 1..8 and n_super * G * T < 2^31; the wrapper checks all of it.
extern "C" int graphem_binfold_launch(const float* queries, const float* refs,
                                      float* out_vals, int32_t* out_idx,
                                      float* part_v, int32_t* part_i,
                                      int* seg_done, int S, int E, int dim,
                                      int T, int G, int n_super, int nb,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || T < kLanes || T % kLanes || G < 1 || n_super < 1 || nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define GRAPHEM_CASE(D) \
  case D:               \
    return launch<D>(queries, refs, out_vals, out_idx, part_v, part_i, \
                     seg_done, S, E, T, G, n_super, nb, st);
  switch (dim) {
    GRAPHEM_CASE(1)
    GRAPHEM_CASE(2)
    GRAPHEM_CASE(3)
    GRAPHEM_CASE(4)
    GRAPHEM_CASE(5)
    GRAPHEM_CASE(6)
    GRAPHEM_CASE(7)
    GRAPHEM_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GRAPHEM_CASE
}
