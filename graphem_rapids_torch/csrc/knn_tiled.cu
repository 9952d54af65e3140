// Exact tiled kNN kernel (squared distances + per-query running top-k).
//
// Replaces the TPU Pallas kernel graphem_rapids_tpu/ops/knn_pallas.py
// `_knn_kernel` :37 (launched by `_knn_pallas_padded`, entered through
// `knn_pallas`). Semantics are the TPU kernel's:
//   - the squared distance of query q to ref r is accumulated coordinate by
//     coordinate in order, d = 0; d = d + diff * diff, in fp32 with
//     round-to-nearest and no fused multiply-add (the intrinsics below, and
//     --fmad=false);
//   - the output row of a query is the first k of all refs in ascending
//     (value, index) order: equal distances keep the smaller index;
//   - a ref whose distance is not below 3.0e38 (the 1e30 pad slots give
//     +inf) is never taken; slots beyond the refs taken hold (3.0e38, 0),
//     which is what the TPU carry's initial (3e38, 0) lanes give.
//
// Design. The TPU walks the ref tiles in order on one core and carries the
// (S, 128) top-k from one grid step to the next. Hopper blocks run in
// parallel and in no order, so the ordered carry becomes two passes:
//   pass 1, grid (query blocks, ref slices): one warp per query scans one
//     contiguous slice of refs, 32 refs per step (one per lane), in
//     ascending index order. The warp keeps the query's sorted top-k as
//     (value, index) pairs in registers, entry j on lane j % 32, slot j / 32
//     (k <= 128: up to four slots). A lane whose distance is below the k-th
//     value votes; the voters are inserted one by one in lane order, each
//     insert a warp-wide shift by shuffles. Because refs arrive in ascending
//     index order, a strict `<` against the k-th value keeps the smaller
//     index on ties. Each slice writes its own sorted list.
//   pass 2, one warp per query: folds the slices' lists in slice order into
//     one list with the same insert, comparing (value, index) pairs.
// With one slice, pass 1 writes the output and pass 2 is not launched.
//
// Bound on an H100: 3 * DIM + 1 fp32 instructions per (query, ref) pair
// (DIM subtractions, multiplies and adds, one compare), that is 10 at d=3,
// plus the insert on the rare pair that beats the k-th value. The refs are
// read once per query from L1/L2 (a block's four warps share each load),
// and the bytes that must cross device memory (queries, refs, outputs) are
// a few MB, so instruction throughput, not memory, is the limit. This is
// the simple, correct first form; TMA staging of the ref stream, more
// refs per lane per step and a tuned slice count are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ bool lex_less(float av, int32_t ai, float bv,
                                         int32_t bi) {
  return av < bv || (av == bv && ai < bi);
}

// Insert (cv, ci) into the warp's sorted list, dropping its last entry.
// Called by all 32 lanes with the same (cv, ci). The caller has checked
// that (cv, ci) sorts before entry k - 1, so entries at j >= k (the tail
// of the last slot, which only ever holds larger entries) never count.
template <int KS>
__device__ __forceinline__ void warp_insert(float (&lv)[KS], int32_t (&li)[KS],
                                            float cv, int32_t ci, int lane) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    pos += __popc(__ballot_sync(kFull, lex_less(lv[s], li[s], cv, ci)));
  }
  // High slots first, so that slot s - 1 is still unshifted when slot s
  // takes its lane-31 entry.
#pragma unroll
  for (int s = KS - 1; s >= 0; --s) {
    float prev_v = __shfl_up_sync(kFull, lv[s], 1);
    int32_t prev_i = __shfl_up_sync(kFull, li[s], 1);
    if (s > 0) {
      const float carry_v = __shfl_sync(kFull, lv[s > 0 ? s - 1 : 0], kWarp - 1);
      const int32_t carry_i = __shfl_sync(kFull, li[s > 0 ? s - 1 : 0], kWarp - 1);
      if (lane == 0) {
        prev_v = carry_v;
        prev_i = carry_i;
      }
    }
    const int j = s * kWarp + lane;
    if (j > pos) {
      lv[s] = prev_v;
      li[s] = prev_i;
    } else if (j == pos) {
      lv[s] = cv;
      li[s] = ci;
    }
  }
}

// Entry k - 1 of the list, broadcast to every lane.
template <int KS>
__device__ __forceinline__ void kth_entry(const float (&lv)[KS],
                                          const int32_t (&li)[KS], int k,
                                          float& tv, int32_t& ti) {
  const int ts = (k - 1) / kWarp;
  float v = lv[0];
  int32_t i = li[0];
#pragma unroll
  for (int s = 1; s < KS; ++s) {
    if (s == ts) {
      v = lv[s];
      i = li[s];
    }
  }
  tv = __shfl_sync(kFull, v, (k - 1) % kWarp);
  ti = __shfl_sync(kFull, i, (k - 1) % kWarp);
}

template <int KS>
__device__ __forceinline__ void store_list(const float (&lv)[KS],
                                           const int32_t (&li)[KS],
                                           float* out_v, int32_t* out_i,
                                           int k, int lane) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int j = s * kWarp + lane;
    if (j < k) {
      out_v[j] = lv[s];
      out_i[j] = li[s];
    }
  }
}

// Pass 1. DIM > 0: the query is held in registers and the coordinate loop
// unrolled; DIM == 0: any `dim`, read in a runtime loop.
template <int DIM, int KS>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
knn_slices_kernel(const float* __restrict__ queries,
                  const float* __restrict__ refs, float* __restrict__ part_v,
                  int32_t* __restrict__ part_i, int S, int E, int dim, int k,
                  int slice_len) {
  const int lane = threadIdx.x % kWarp;
  const int qi = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (qi >= S) return;  // whole warps: no shuffle loses a lane
  const int slice = blockIdx.y;
  const int lo = slice * slice_len;
  const int hi = (int)min((long long)E, (long long)lo + slice_len);

  const float* qg = queries + (long long)qi * dim;
  float q[DIM > 0 ? DIM : 1];
  if constexpr (DIM > 0) {
#pragma unroll
    for (int c = 0; c < DIM; ++c) q[c] = qg[c];
  }

  float lv[KS];
  int32_t li[KS];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    lv[s] = kBig;
    li[s] = 0;
  }
  float tv = kBig;
  int32_t ti = 0;

  for (int base = lo; base < hi; base += kWarp) {
    const int r = base + lane;
    float d = kBig;
    bool take = false;
    if (r < hi) {
      const float* rr = refs + (long long)r * dim;
      d = 0.0f;
      if constexpr (DIM > 0) {
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          const float diff = __fsub_rn(q[c], __ldg(rr + c));
          d = __fadd_rn(d, __fmul_rn(diff, diff));
        }
      } else {
        for (int c = 0; c < dim; ++c) {
          const float diff = __fsub_rn(__ldg(qg + c), __ldg(rr + c));
          d = __fadd_rn(d, __fmul_rn(diff, diff));
        }
      }
      take = d < tv;
    }
    unsigned votes = __ballot_sync(kFull, take);
    while (votes) {
      const int src = __ffs(votes) - 1;
      votes &= votes - 1;
      const float cv = __shfl_sync(kFull, d, src);
      // the k-th value may have dropped since the vote
      if (cv < tv) {
        warp_insert<KS>(lv, li, cv, base + src, lane);
        kth_entry<KS>(lv, li, k, tv, ti);
      }
    }
  }
  const long long row = ((long long)slice * S + qi) * k;
  store_list<KS>(lv, li, part_v + row, part_i + row, k, lane);
}

// Pass 2: fold the n_slices sorted lists of each query, in slice order.
template <int KS>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
knn_merge_kernel(const float* __restrict__ part_v,
                 const int32_t* __restrict__ part_i, float* __restrict__ out_v,
                 int32_t* __restrict__ out_i, int S, int k, int n_slices) {
  const int lane = threadIdx.x % kWarp;
  const int qi = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (qi >= S) return;

  float lv[KS];
  int32_t li[KS];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    lv[s] = kBig;
    li[s] = 0;
  }
  float tv = kBig;
  int32_t ti = 0;

  for (int p = 0; p < n_slices; ++p) {
    const long long row = ((long long)p * S + qi) * k;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int j = s * kWarp + lane;
      float cv = kBig;
      int32_t ci = 0;
      if (j < k) {
        cv = part_v[row + j];
        ci = part_i[row + j];
      }
      unsigned votes = __ballot_sync(kFull, lex_less(cv, ci, tv, ti));
      while (votes) {
        const int src = __ffs(votes) - 1;
        votes &= votes - 1;
        const float v = __shfl_sync(kFull, cv, src);
        const int32_t i = __shfl_sync(kFull, ci, src);
        if (lex_less(v, i, tv, ti)) {
          warp_insert<KS>(lv, li, v, i, lane);
          kth_entry<KS>(lv, li, k, tv, ti);
        }
      }
    }
  }
  store_list<KS>(lv, li, out_v + (long long)qi * k, out_i + (long long)qi * k,
                 k, lane);
}

template <int DIM, int KS>
void launch_slices(const float* q, const float* refs, float* pv, int32_t* pi,
                   int S, int E, int dim, int k, int n_slices, int slice_len,
                   cudaStream_t st) {
  const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock, n_slices);
  knn_slices_kernel<DIM, KS><<<grid, kWarp * kWarpsPerBlock, 0, st>>>(
      q, refs, pv, pi, S, E, dim, k, slice_len);
}

template <int KS>
void launch_dim(const float* q, const float* refs, float* pv, int32_t* pi,
                int S, int E, int dim, int k, int n_slices, int slice_len,
                cudaStream_t st) {
#define GRAPHEM_DIM_CASE(D)                                                 \
  case D:                                                                   \
    launch_slices<D, KS>(q, refs, pv, pi, S, E, dim, k, n_slices, slice_len, \
                         st);                                               \
    break;
  switch (dim) {
    GRAPHEM_DIM_CASE(1)
    GRAPHEM_DIM_CASE(2)
    GRAPHEM_DIM_CASE(3)
    GRAPHEM_DIM_CASE(4)
    GRAPHEM_DIM_CASE(5)
    GRAPHEM_DIM_CASE(6)
    GRAPHEM_DIM_CASE(7)
    GRAPHEM_DIM_CASE(8)
    default:
      launch_slices<0, KS>(q, refs, pv, pi, S, E, dim, k, n_slices, slice_len,
                           st);
  }
#undef GRAPHEM_DIM_CASE
}

template <int KS>
void launch_all(const float* q, const float* refs, float* pv, int32_t* pi,
                float* out_v, int32_t* out_i, int S, int E, int dim, int k,
                int n_slices, int slice_len, cudaStream_t st) {
  if (n_slices == 1) {
    // one slice: its list is the answer
    launch_dim<KS>(q, refs, out_v, out_i, S, E, dim, k, 1, slice_len, st);
    return;
  }
  launch_dim<KS>(q, refs, pv, pi, S, E, dim, k, n_slices, slice_len, st);
  const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  knn_merge_kernel<KS><<<blocks, kWarp * kWarpsPerBlock, 0, st>>>(
      pv, pi, out_v, out_i, S, k, n_slices);
}

}  // namespace

// Launches the exact kNN on `stream` and returns cudaGetLastError() (0 on
// success). queries (S, dim) and refs (E, dim) are contiguous fp32; out_v /
// out_i are (S, k); part_v / part_i are (n_slices, S, k) scratch, unused
// when n_slices == 1. Slice p covers refs [p * slice_len, (p+1) * slice_len).
// The wrapper checks 1 <= k <= 128, S >= 1, dim >= 1 and E < 2^31.
extern "C" int graphem_knn_tiled_launch(const float* queries, const float* refs,
                                        float* part_v, int32_t* part_i,
                                        float* out_v, int32_t* out_i, int S,
                                        int E, int dim, int k, int n_slices,
                                        int slice_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || dim < 1 || k < 1 || k > 4 * kWarp || n_slices < 1 ||
      n_slices > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch ((k + kWarp - 1) / kWarp) {
    case 1: launch_all<1>(queries, refs, part_v, part_i, out_v, out_i, S, E, dim, k, n_slices, slice_len, st); break;
    case 2: launch_all<2>(queries, refs, part_v, part_i, out_v, out_i, S, E, dim, k, n_slices, slice_len, st); break;
    case 3: launch_all<3>(queries, refs, part_v, part_i, out_v, out_i, S, E, dim, k, n_slices, slice_len, st); break;
    default: launch_all<4>(queries, refs, part_v, part_i, out_v, out_i, S, E, dim, k, n_slices, slice_len, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
