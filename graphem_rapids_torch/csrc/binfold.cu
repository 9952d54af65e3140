// Bin-fold kNN kernel (fused squared distances + per-bin running arg-min).
//
// Replaces the TPU Pallas kernel graphem_rapids_tpu/ops/knn_binfold.py
// `_kernel` (launched by `_binfold_padded`). Semantics are the TPU kernel's,
// bit for bit:
//   - the reference at flat position p (tile p / T, lane p % 128) folds into
//     bin ((p / T) % G) * 128 + p % 128;
//   - its squared distance to a query is accumulated coordinate by coordinate
//     in order, d = 0; d = d + diff * diff, in fp32 with round-to-nearest and
//     no fused multiply-add (the intrinsics below, and --fmad=false);
//   - a bin keeps (value, index) of the first strict minimum in visit order
//     (super-tile s, then 128-lane chunk c), starting from (3.0e38, 0), so the
//     lowest p wins ties and a bin that only sees +inf keeps (3.0e38, 0);
//   - positions p >= E read the pad coordinate 1.0e15 (finite squared
//     distance ~1e30) exactly as the TPU wrapper pads its transposed refs.
// Phase 2 (top-k over the G*128 bins) stays outside, in the Python wrapper.
//
// Design: grid (G, ceil(S / QB)), 128 threads, one thread per bin lane. A
// thread keeps QB running (value, index) pairs and the QB queries in
// registers, and sweeps s = 0..n_super-1, c = 0..T/128-1, reading
// refs[p * DIM + coord] for p = (s * G + g) * T + c * 128 + lane. The refs
// are read in the engine's own (E, DIM) row-major layout, so no padded
// transposed copy is made per call; lanes read neighbouring rows.
//
// Bound on an H100: (3 * DIM + 3) fp32 instructions per (query, ref) pair
// (DIM subtractions, multiplies and adds, one compare, two selects), that is
// 512 x 835,584 x 12 ~ 5.1e9 at the 100K-vertex layout shape. The refs are
// ~10 MB and stay resident in L2, so the kernel is bound by instruction
// throughput, not by memory: queries and carries live in registers so that
// the inner loop issues only the pair arithmetic and one load per
// coordinate per 16 pairs. This is the simple, correct first form; making
// it fast (wider query blocks, fewer selects per pair) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kQB = 16;
constexpr float kBig = 3.0e38f;
constexpr float kPadCoord = 1.0e15f;

template <int DIM>
__global__ void __launch_bounds__(kLanes)
binfold_kernel(const float* __restrict__ queries, const float* __restrict__ refs,
               float* __restrict__ out_vals, int32_t* __restrict__ out_idx,
               int S, long long E, int T, int G, int n_super) {
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
          ix[j] = (int32_t)p;
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
      out_vals[qi * n_bins + bin] = v[j];
      out_idx[qi * n_bins + bin] = ix[j];
    }
  }
}

template <int DIM>
void launch(const float* q, const float* refs, float* out_vals, int32_t* out_idx,
            int S, long long E, int T, int G, int n_super, cudaStream_t stream) {
  const dim3 grid(G, (S + kQB - 1) / kQB);
  binfold_kernel<DIM><<<grid, kLanes, 0, stream>>>(q, refs, out_vals, out_idx,
                                                   S, E, T, G, n_super);
}

}  // namespace

// Launches the bin fold on `stream` and returns cudaGetLastError() (0 on
// success). queries (S, dim) and refs (E, dim) are contiguous fp32;
// out_vals / out_idx are (S, G * 128). T must be a multiple of 128 and dim
// in 1..8; the wrapper checks both before calling.
extern "C" int graphem_binfold_launch(const float* queries, const float* refs,
                                      float* out_vals, int32_t* out_idx,
                                      int S, long long E, int dim, int T,
                                      int G, int n_super, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1: launch<1>(queries, refs, out_vals, out_idx, S, E, T, G, n_super, st); break;
    case 2: launch<2>(queries, refs, out_vals, out_idx, S, E, T, G, n_super, st); break;
    case 3: launch<3>(queries, refs, out_vals, out_idx, S, E, T, G, n_super, st); break;
    case 4: launch<4>(queries, refs, out_vals, out_idx, S, E, T, G, n_super, st); break;
    case 5: launch<5>(queries, refs, out_vals, out_idx, S, E, T, G, n_super, st); break;
    case 6: launch<6>(queries, refs, out_vals, out_idx, S, E, T, G, n_super, st); break;
    case 7: launch<7>(queries, refs, out_vals, out_idx, S, E, T, G, n_super, st); break;
    case 8: launch<8>(queries, refs, out_vals, out_idx, S, E, T, G, n_super, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
