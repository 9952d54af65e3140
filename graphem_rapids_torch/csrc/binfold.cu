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
// less, so issue slots are the limit. The loop below issues those 11 per
// pair plus a load and the loop step per chunk.
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
// Design. The work is U = G * ceil(S / QB) * n_super units: (bin group g,
// query block, super-tile s), each QB queries against the T refs of one
// tile. The grid is exactly the resident block count nb (the wrapper's
// `fold_plan`, from the occupancy the card reports), and block b walks the
// units [b * U / nb, (b + 1) * U / nb) in order (g, query block, s), so
// every block gets the same work to within one unit and the card runs one
// wave. A block's range cuts the run of a (g, query block) over its
// super-tiles into at most three kinds of run: whole (written straight to
// the outputs), or a piece at the start or end of its range. A piece
// writes its (value, index) pairs to the block's slot in a scratch buffer;
// the block that completes a segment's super-tiles (an atomicAdd on the
// segment's count) folds the pieces. Within a bin the visit order is
// ascending p, so the first strict minimum is the lexicographic minimum
// of (value, p), and the pieces are folded as 64-bit keys
// (bits(value) << 32) | p, which order as (value, p) because the values
// are >= +0 and their IEEE bits order as unsigned integers; a piece that
// took nothing holds (3.0e38, 0), whose key is below every (3.0e38, p > 0)
// and above every real value. In the sweep a thread keeps QB queries and
// their QB (value, index) pairs in registers (QB = 16 at d <= 3, else 8;
// up to 128 registers, 4 blocks of 128 threads per SM), and loads the next
// chunk's ref while it folds the current one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr float kBig = 3.0e38f;
constexpr float kPadCoord = 1.0e15f;

template <int DIM>
struct Fold {
  static constexpr int QB = DIM <= 3 ? 16 : 8;  // queries per thread
  static constexpr int kMinBlocks = 4;  // 128 registers a thread
};

// First unit of block b's range.
__device__ __forceinline__ long long range_start(long long b, long long U,
                                                 long long nb) {
  return b * U / nb;
}

// The block whose range holds unit u.
__device__ __forceinline__ long long block_of(long long u, long long U,
                                              long long nb) {
  return ((u + 1) * nb - 1) / U;
}

__device__ __forceinline__ unsigned long long pack_key(float v, int32_t p) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         static_cast<unsigned int>(p);
}

template <int DIM>
__device__ __forceinline__ void load_ref(const float* __restrict__ refs, int p,
                                         int E, float (&r)[DIM]) {
  if ((unsigned)p < (unsigned)E) {  // a p past 2^31 - 1 wraps above E
#pragma unroll
    for (int c = 0; c < DIM; ++c) r[c] = __ldg(refs + (long long)p * DIM + c);
  } else {
#pragma unroll
    for (int c = 0; c < DIM; ++c) r[c] = kPadCoord;
  }
}

template <int DIM>
__global__ void __launch_bounds__(kLanes, Fold<DIM>::kMinBlocks)
binfold_kernel(const float* __restrict__ queries, const float* __restrict__ refs,
               float* __restrict__ out_vals, int32_t* __restrict__ out_idx,
               float* __restrict__ part_v, int32_t* __restrict__ part_i,
               int* __restrict__ seg_done, int S, int E, int T, int G,
               int n_super, int n_qblk, int nb) {
  constexpr int QB = Fold<DIM>::QB;
  __shared__ int last_piece;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const long long U = (long long)G * n_qblk * n_super;
  const long long u0 = range_start(b, U, nb);
  const long long u1 = range_start(b + 1, U, nb);
  const int chunks = T / kLanes;
  const long long n_bins = (long long)G * kLanes;

  long long u = u0;
  while (u < u1) {
    const long long seg = u / n_super;
    const int s0 = (int)(u - seg * n_super);
    const int s1 = (int)min((long long)n_super, s0 + (u1 - u));
    const int g = (int)(seg / n_qblk);
    const int q0 = (int)(seg % n_qblk) * QB;
    const long long bin = (long long)g * kLanes + lane;

    float q[QB][DIM];
#pragma unroll
    for (int j = 0; j < QB; ++j) {
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        q[j][c] = q0 + j < S ? queries[(long long)(q0 + j) * DIM + c] : 0.0f;
      }
    }
    float v[QB];
    int32_t ix[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      v[j] = kBig;
      ix[j] = 0;
    }

    // p walks the tiles (s * G + g) * T of the run, 128 lanes per chunk
    const int skip = (G - 1) * T;  // from a tile's end to the next tile
    int p = (s0 * G + g) * T + lane;
    float r[DIM];
    load_ref<DIM>(refs, p, E, r);
    const int steps = (s1 - s0) * chunks;
    for (int t = 0, c = 0; t < steps; ++t) {
      int pn = p + kLanes;
      if (++c == chunks) {
        c = 0;
        pn += skip;
      }
      float rn[DIM];
      load_ref<DIM>(refs, pn, E, rn);  // past the run: read, never used
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        float diff = __fsub_rn(q[j][0], r[0]);
        float d = __fmul_rn(diff, diff);
#pragma unroll
        for (int k = 1; k < DIM; ++k) {
          diff = __fsub_rn(q[j][k], r[k]);
          d = __fadd_rn(d, __fmul_rn(diff, diff));
        }
        if (d < v[j]) {
          v[j] = d;
          ix[j] = p;
        }
      }
#pragma unroll
      for (int k = 0; k < DIM; ++k) r[k] = rn[k];
      p = pn;
    }

    if (s0 == 0 && s1 == n_super) {  // the whole segment: the bins' answer
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        if (q0 + j < S) {
          out_vals[(q0 + j) * n_bins + bin] = v[j];
          out_idx[(q0 + j) * n_bins + bin] = ix[j];
        }
      }
    } else {
      // a piece: slot 0 for the run at the start of the range, 1 at its end
      const long long slot = ((long long)b * 2 + (u == u0 ? 0 : 1)) * QB;
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        part_v[(slot + j) * kLanes + lane] = v[j];
        part_i[(slot + j) * kLanes + lane] = ix[j];
      }
      __threadfence();
      __syncthreads();
      if (lane == 0) {
        const int add = s1 - s0;
        last_piece = atomicAdd(seg_done + seg, add) + add == n_super;
      }
      __syncthreads();
      if (last_piece) {  // every piece of the segment is written: fold them
        __threadfence();
        const long long lo = seg * n_super;
        const long long pb0 = block_of(lo, U, nb);
        const long long pb1 = block_of(lo + n_super - 1, U, nb);
        unsigned long long key[QB];
#pragma unroll
        for (int j = 0; j < QB; ++j) key[j] = pack_key(kBig, 0);
        for (long long pb = pb0; pb <= pb1; ++pb) {
          // the segment is pb's first run unless pb's range began before it
          const long long ps =
              (pb * 2 + (pb == pb0 && range_start(pb, U, nb) != lo ? 1 : 0)) *
              QB;
#pragma unroll
          for (int j = 0; j < QB; ++j) {
            const unsigned long long kk =
                pack_key(__ldcg(part_v + (ps + j) * kLanes + lane),
                         __ldcg(part_i + (ps + j) * kLanes + lane));
            key[j] = kk < key[j] ? kk : key[j];
          }
        }
#pragma unroll
        for (int j = 0; j < QB; ++j) {
          if (q0 + j < S) {
            out_vals[(q0 + j) * n_bins + bin] =
                __uint_as_float((unsigned int)(key[j] >> 32));
            out_idx[(q0 + j) * n_bins + bin] = (int32_t)(key[j] & 0xffffffffu);
          }
        }
      }
    }
    u += s1 - s0;
  }
}

template <int DIM>
int launch(const float* q, const float* refs, float* out_vals, int32_t* out_idx,
           float* part_v, int32_t* part_i, int* seg_done, int S, int E, int T,
           int G, int n_super, int nb, cudaStream_t stream) {
  const int n_qblk = (S + Fold<DIM>::QB - 1) / Fold<DIM>::QB;
  const cudaError_t err = cudaMemsetAsync(
      seg_done, 0, sizeof(int) * (size_t)G * n_qblk, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  binfold_kernel<DIM><<<nb, kLanes, 0, stream>>>(
      q, refs, out_vals, out_idx, part_v, part_i, seg_done, S, E, T, G,
      n_super, n_qblk, nb);
  return static_cast<int>(cudaGetLastError());
}

template <int DIM>
int occupancy() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, binfold_kernel<DIM>, kLanes, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
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
