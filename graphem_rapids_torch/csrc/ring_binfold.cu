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
//     round-to-nearest and no fused multiply-add (the intrinsics below, and
//     --fmad=false);
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
// The output may alias the carry: each thread reads its carry bins before
// it writes the same addresses, and no other thread touches them.
//
// Design: K1's (csrc/binfold.cu), with the offset ids and the merge in the
// epilogue. Grid (G, ceil(S / QB)), 128 threads, one thread per bin lane; a
// thread keeps QB running (value, id) pairs and the QB queries in registers
// and sweeps s = 0..n_super-1, c = 0..T/128-1 over the refs in the engine's
// (E, DIM) row-major layout. The carry is read once, after the sweep, so it
// adds no registers to the inner loop.
//
// Bound on an H100: (3 * DIM + 3) fp32 instructions per (query, ref) pair,
// 512 x 5,701,632 x 12 ~ 3.5e10 per hop at the one-rank 1M-vertex shape,
// against 4 * (S * DIM + R_pad * DIM) + 16 * S * G * 128 bytes (queries,
// refs, carry in, bins out) ~ 0.1 GB: bound by instruction throughput.
// Overlapping the fold with the transfer, and a faster fold, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kQB = 16;
constexpr float kBig = 3.0e38f;
constexpr float kPadCoord = 1.0e15f;

template <int DIM>
__global__ void __launch_bounds__(kLanes)
ring_fold_kernel(const float* __restrict__ queries,
                 const float* __restrict__ refs, const float* carry_vals,
                 const int32_t* carry_idx, float* out_vals, int32_t* out_idx,
                 int S, long long E, int T, int G, int n_super,
                 long long offset) {
  const int g = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int lane = threadIdx.x;

  float q[kQB][DIM];
#pragma unroll
  for (int j = 0; j < kQB; ++j) {
    const int qi = q0 + j;
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      q[j][k] = qi < S ? queries[(long long)qi * DIM + k] : 0.0f;
    }
  }

  float v[kQB];
  int32_t ix[kQB];
#pragma unroll
  for (int j = 0; j < kQB; ++j) {
    v[j] = kBig;
    ix[j] = 0;
  }

  const int chunks = T / kLanes;
  for (int s = 0; s < n_super; ++s) {
    const long long tile = ((long long)s * G + g) * T;
    for (int c = 0; c < chunks; ++c) {
      const long long p = tile + (long long)c * kLanes + lane;
      const int32_t id = (int32_t)(offset + p);
      float r[DIM];
      if (p < E) {
#pragma unroll
        for (int k = 0; k < DIM; ++k) r[k] = refs[p * DIM + k];
      } else {
#pragma unroll
        for (int k = 0; k < DIM; ++k) r[k] = kPadCoord;
      }
#pragma unroll
      for (int j = 0; j < kQB; ++j) {
        float d = 0.0f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const float diff = __fsub_rn(q[j][k], r[k]);
          d = __fadd_rn(d, __fmul_rn(diff, diff));
        }
        if (d < v[j]) {
          v[j] = d;
          ix[j] = id;
        }
      }
    }
  }

  const long long n_bins = (long long)G * kLanes;
  const long long bin = (long long)g * kLanes + lane;
#pragma unroll
  for (int j = 0; j < kQB; ++j) {
    const int qi = q0 + j;
    if (qi < S) {
      const long long o = (long long)qi * n_bins + bin;
      float vo = v[j];
      int32_t io = ix[j];
      if (carry_vals != nullptr) {
        const float cv = carry_vals[o];
        const int32_t ci = carry_idx[o];
        if (!(vo < cv)) {
          vo = cv;
          io = ci;
        }
      }
      out_vals[o] = vo;
      out_idx[o] = io;
    }
  }
}

template <int DIM>
void launch(const float* q, const float* refs, const float* cv,
            const int32_t* ci, float* ov, int32_t* oi, int S, long long E,
            int T, int G, int n_super, long long offset, cudaStream_t stream) {
  const dim3 grid(G, (S + kQB - 1) / kQB);
  ring_fold_kernel<DIM><<<grid, kLanes, 0, stream>>>(
      q, refs, cv, ci, ov, oi, S, E, T, G, n_super, offset);
}

}  // namespace

// Launches one ring hop on `stream` and returns cudaGetLastError() (0 on
// success). q_shard (S, dim) and refs (E, dim) are contiguous fp32; the
// carry (S, G * 128) fp32 values and int32 ids may be NULL (hop 0); the
// output (S, G * 128) may alias the carry. T must be a multiple of 128, dim
// in 1..8 and offset + n_super * G * T below 2^31; the wrapper checks them.
extern "C" int graphem_ring_fold_launch(const float* q_shard, const float* refs,
                                        const float* carry_vals,
                                        const int32_t* carry_idx,
                                        float* out_vals, int32_t* out_idx,
                                        int S, long long E, int dim, int T,
                                        int G, int n_super, long long offset,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RING_FOLD_CASE(D)                                                   \
  case D:                                                                   \
    launch<D>(q_shard, refs, carry_vals, carry_idx, out_vals, out_idx, S,   \
              E, T, G, n_super, offset, st);                                \
    break;
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
  return static_cast<int>(cudaGetLastError());
}
