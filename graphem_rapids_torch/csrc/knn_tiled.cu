// Exact tiled kNN kernel (squared distances + per-query running top-k).
//
// Replaces the TPU Pallas kernel graphem_rapids_tpu/ops/knn_pallas.py
// `_knn_kernel` :37 (launched by `_knn_pallas_padded`, entered through
// `knn_pallas`). Semantics are the TPU kernel's:
//   - the squared distance of query q to ref r is accumulated coordinate by
//     coordinate in order, d = 0; d = d + diff * diff, in fp32 with
//     round-to-nearest and no fused multiply-add (the intrinsics below, and
//     --fmad=false). The first add, 0 + diff * diff, is exact (a square is
//     +0, positive or NaN), so it is not issued: the bits are the same;
//   - the output row of a query is the first k of all refs in ascending
//     (value, index) order: equal distances keep the smaller index;
//   - a ref whose distance is not below 3.0e38 (the 1e30 pad slots give
//     +inf) is never taken; slots beyond the refs taken hold (3.0e38, 0),
//     which is what the TPU carry's initial (3e38, 0) lanes give.
//
// What bounds it on an H100: 3 * DIM fp32 instructions per (query, ref)
// pair (DIM subtractions, DIM multiplies, DIM - 1 adds and the compare),
// 9 at d=3: 1.84e9 at S=512 against E=399,984 refs, 0.055 ms, and 1.84e10
// at E=3,999,991, 0.551 ms, at 132 SMs x 128 lanes x 1980 MHz. The bytes
// that must cross device memory are a few MB, so issue slots, not memory,
// are the limit.
//
// What held the first design back (one warp per query, one ref per lane
// per step, read from global memory): per pair it issued three loads of the
// ref's row, a bounds check, a ballot and the loop step besides the
// arithmetic, and every warp read every ref of its slice for one query:
// 0.43-0.45 ms a call at E=399,984 and 5.8-5.9 ms at E=3,999,991 (S=512,
// d=3, k=16; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// Design. Two passes; the TPU's ordered carry over ref tiles becomes ref
// slices merged in slice order.
//   pass 1, grid (query blocks, ref slices), 8 warps of 4 queries. The
//     block streams its slice in tiles (1024 refs at d <= 3) through a
//     three-stage ring in shared memory filled by cp.async: 16-byte copies
//     of whole tiles at odd d (a tile is laid out as in global memory),
//     4-byte copies into rows of odd stride otherwise, so the 32 lanes'
//     reads of 32 neighbouring refs hit 32 banks. Each warp holds its 4
//     queries in registers and reuses every staged ref for all of them:
//     per step each lane takes 2 refs, computes 8 distances, and the warp
//     votes once on the OR of the 8 `take` predicates; only a step with a
//     vote goes on to the merge. A query's sorted list lives across the
//     warp as (value, index) pairs, entry j on lane j % 32, slot j / 32
//     (k <= 128). A batch of candidates merges by ranks (each entry's
//     place in the merged order is a count of what sorts before it; the
//     kept entries go through shared memory), or at k <= 32 and 8 or more
//     candidates by sorting networks (a bitonic sort of the batch and a
//     bitonic merge with the list). Both keep the first k of the union in
//     (value, index) order, so the smaller index wins every tie whatever
//     the order of the merges.
//     Slices share a bound of each query's final k-th value in global
//     memory, and a ref above it is not in the answer while one equal to
//     it may be (ties): the test is d <= bound, folded into the one
//     compare `d < min(own k-th, nextafter(bound))`. With n_slices <= 32
//     each slice shows the value at rank r = ceil(k / n_slices) of its
//     list (its smallest at 24 slices and k = 16); the m = ceil(k / r)-th
//     smallest shown value stands for m * r >= k refs of distinct slices,
//     a much closer bound than any one slice's k-th value. It is read at
//     tiles 1, 2, 3, 4, 8, 16, ... and at steps 1, 2, 4 and 8 of tile 0,
//     as the candidates thin out. With more slices (few queries) a warp
//     whose list is full publishes its k-th value instead, by atomicMin on
//     the value's bits (nonnegative floats order as their bits), read once
//     per tile; beside the shown bound it did not move the time (PERF.md).
//     The pruning depends on timing; the answer does not.
//   pass 2, one warp per query: merges the slices' lists in slice order,
//     each list loaded while the one before it merges.
// With one slice, pass 1 writes the output and pass 2 is not launched. The
// wrapper cuts the slices so that the pass-1 grid is one wave of the
// resident blocks the card reports (ops/knn_pallas.py `slice_plan`). For
// dim > 8 a generic path reads refs and queries from global memory, with
// the same steps, votes and merges.
//
// What holds it back now: each slice starts with no bound and builds its
// list from its first refs (their candidates are nearly all there are at
// the 100K shape), and the shared bound needs the other slices to have
// shown a value first (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kWarps = 8;  // pass 1: warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kStages = 3;
constexpr int kMergeWarps = 4;  // pass 2: warps per block
constexpr float kBig = 3.0e38f;
constexpr int QW = 4;  // queries per warp
constexpr int kRefsPerLane = 2;  // refs per lane per step
constexpr int kStep = kWarp * kRefsPerLane;
// k <= 32: a batch of at least this many candidates merges by sorting
// networks (warp_merge_sorted), a smaller one by ranks (warp_merge)
constexpr int kSortedFrom = 8;

// Row stride of a staged ref: odd, so that lane l's row starts in bank
// (stride * l) % 32, 32 distinct banks.
template <int DIM>
struct RowStride {
  static constexpr int value = (DIM % 2) ? DIM : DIM + 1;
};

// Refs per staged tile: three stages stay within 48 KB of shared memory.
template <int DIM>
struct TileRefs {
  static constexpr int value =
      RowStride<DIM>::value <= 3 ? 1024 : (RowStride<DIM>::value <= 5 ? 512 : 256);
};

__device__ __forceinline__ bool lex_less(float av, int32_t ai, float bv,
                                         int32_t bi) {
  return av < bv || (av == bv && ai < bi);
}

// Staged in the rows past the slice: NaN, so d is NaN and never taken,
// whatever the query.
__device__ __forceinline__ float pad_coord() { return __int_as_float(0x7fc00000); }

// Smallest float above x, for 0 <= x < inf: d <= x  <=>  d < next_up(x).
__device__ __forceinline__ float next_up(float x) {
  return __int_as_float(__float_as_int(x) + 1);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Merge the candidates of the lanes in `voters` ((cv, ci), one on each
// voter lane) into the warp's sorted list (entry j on lane j % 32, slot
// j / 32) and keep its first k entries in (value, index) order. Each
// entry's place in the merged order is a count: a list entry moves down by
// the candidates before it, a candidate lands after the list entries and
// the candidates before it. The kept entries are written to `scratch`
// (the warp's KS * 32 pairs in shared memory) at their places and read
// back. Candidates are lex-distinct from each other and from the entries.
template <int KS>
__device__ __forceinline__ void warp_merge(float (&lv)[KS], int32_t (&li)[KS],
                                           float cv, int32_t ci,
                                           unsigned voters, int k, int lane,
                                           float2* scratch) {
  const bool mine = (voters >> lane) & 1u;
  int below[KS];
#pragma unroll
  for (int s = 0; s < KS; ++s) below[s] = 0;
  int place = 0;
  while (voters) {
    const int src = __ffs(voters) - 1;
    voters &= voters - 1;
    const float v = __shfl_sync(kFull, cv, src);
    const int32_t i = __shfl_sync(kFull, ci, src);
    int entries = 0;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const bool real = s * kWarp + lane < k;
      entries += __popc(
          __ballot_sync(kFull, real && lex_less(lv[s], li[s], v, i)));
      below[s] += lex_less(v, i, lv[s], li[s]);
    }
    if (mine && lex_less(v, i, cv, ci)) ++place;
    if (lane == src) place += entries;
  }
  __syncwarp();  // the last merge's reads of scratch are done
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int j = s * kWarp + lane;
    if (j < k && j + below[s] < k) {
      scratch[j + below[s]] = make_float2(lv[s], __int_as_float(li[s]));
    }
  }
  if (mine && place < k) scratch[place] = make_float2(cv, __int_as_float(ci));
  __syncwarp();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int j = s * kWarp + lane;
    if (j < k) {
      const float2 e = scratch[j];
      lv[s] = e.x;
      li[s] = __float_as_int(e.y);
    }
  }
}

// Lex-min (take_min) or lex-max of (v, i) and its partner across `mask`.
__device__ __forceinline__ void exchange(float& v, int32_t& i, int mask,
                                         bool take_min) {
  const float pv = __shfl_xor_sync(kFull, v, mask);
  const int32_t pi = __shfl_xor_sync(kFull, i, mask);
  const bool partner_less = lex_less(pv, pi, v, i);
  if (partner_less == take_min) {
    v = pv;
    i = pi;
  }
}

// warp_merge for k <= 32 by sorting networks, for large batches: the
// candidates (non-voters as (+inf, INT_MAX)) are sorted by a bitonic sort
// across the warp, reversed against the list so that the lane-wise minimum
// holds the 32 smallest of both as a bitonic sequence, which a bitonic merge
// sorts. Lanes at or past k of the list count as (+inf, INT_MAX).
__device__ __forceinline__ void warp_merge_sorted(float (&lv)[1],
                                                  int32_t (&li)[1], float cv,
                                                  int32_t ci, unsigned voters,
                                                  int k, int lane) {
  const float kInf = __int_as_float(0x7f800000);
  float v = (voters >> lane) & 1u ? cv : kInf;
  int32_t i = (voters >> lane) & 1u ? ci : 0x7fffffff;
#pragma unroll
  for (int size = 2; size <= kWarp; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool ascending = (lane & size) == 0 || size == kWarp;
      exchange(v, i, stride, ((lane & stride) == 0) == ascending);
    }
  }
  const float rv = __shfl_sync(kFull, v, kWarp - 1 - lane);
  const int32_t ri = __shfl_sync(kFull, i, kWarp - 1 - lane);
  v = lane < k ? lv[0] : kInf;
  i = lane < k ? li[0] : 0x7fffffff;
  if (lex_less(rv, ri, v, i)) {
    v = rv;
    i = ri;
  }
#pragma unroll
  for (int stride = kWarp >> 1; stride > 0; stride >>= 1) {
    exchange(v, i, stride, (lane & stride) == 0);
  }
  if (lane < k) {
    lv[0] = v;
    li[0] = i;
  }
}

// Merge a batch of candidates by the cheaper of the two ways.
template <int KS>
__device__ __forceinline__ void merge_batch(float (&lv)[KS], int32_t (&li)[KS],
                                            float cv, int32_t ci,
                                            unsigned voters, int k, int lane,
                                            float2* scratch) {
  if constexpr (KS == 1) {
    if (__popc(voters) >= kSortedFrom) {
      warp_merge_sorted(lv, li, cv, ci, voters, k, lane);
      return;
    }
  }
  warp_merge<KS>(lv, li, cv, ci, voters, k, lane, scratch);
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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Copy refs [r0, r0 + tile) of the slice into a stage; rows at or past
// `hi` get the pad coordinate. A whole tile of an odd dim is laid out as
// in global memory, and goes in 16-byte copies when the refs are 16-byte
// aligned; otherwise each float is copied to its padded row.
template <int DIM>
__device__ __forceinline__ void stage_tile(float* stage,
                                           const float* __restrict__ refs,
                                           int r0, int hi, bool aligned16) {
  constexpr int DS = RowStride<DIM>::value;
  constexpr int kFloats = TileRefs<DIM>::value * DIM;
  if (DS == DIM && aligned16 && r0 + TileRefs<DIM>::value <= hi) {
    const float* src = refs + (long long)r0 * DIM;
#pragma unroll
    for (int f = threadIdx.x * 4; f < kFloats; f += kThreads * 4) {
      cp_async16(stage + f, src + f);
    }
    return;
  }
#pragma unroll 4
  for (int f = threadIdx.x; f < kFloats; f += kThreads) {
    const int row = f / DIM;
    const int c = f - row * DIM;
    float* dst = stage + row * DS + c;
    if (r0 + row < hi) {
      cp_async4(dst, refs + (long long)(r0 + row) * DIM + c);
    } else {
      *dst = pad_coord();
    }
  }
}

// The squared distance of one ref to one query, in coordinate order.
template <int DIM>
__device__ __forceinline__ float sq_dist(const float (&q)[DIM], const float* r) {
  float diff = __fsub_rn(q[0], r[0]);
  float d = __fmul_rn(diff, diff);
#pragma unroll
  for (int c = 1; c < DIM; ++c) {
    diff = __fsub_rn(q[c], r[c]);
    d = __fadd_rn(d, __fmul_rn(diff, diff));
  }
  return d;
}

// The generic-dim distance: query and ref read from global memory.
__device__ __forceinline__ float sq_dist_any(const float* __restrict__ q,
                                             const float* __restrict__ r,
                                             int dim) {
  float diff = __fsub_rn(__ldg(q), __ldg(r));
  float d = __fmul_rn(diff, diff);
  for (int c = 1; c < dim; ++c) {
    diff = __fsub_rn(__ldg(q + c), __ldg(r + c));
    d = __fadd_rn(d, __fmul_rn(diff, diff));
  }
  return d;
}

// Lower each query's threshold to the bound_rank-th smallest of the values
// the slices show for it (`shown`: S rows of n_slices, n_slices <= 32, one
// per lane; unshown values are 3.39e38 and bound nothing).
__device__ __forceinline__ void apply_shown(float (&te)[QW],
                                            const float* shown, int S, int q0,
                                            int n_slices, int bound_rank,
                                            int lane) {
  float seen[QW];
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    seen[j] = lane < n_slices && q0 + j < S
                  ? __ldcg(shown + (long long)(q0 + j) * n_slices + lane)
                  : __int_as_float(0x7f800000);
  }
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    int rank = 0;  // values before this lane's, ties by lane
    for (int o = 0; o < n_slices; ++o) {
      const float w = __shfl_sync(kFull, seen[j], o);
      rank += w < seen[j] || (w == seen[j] && o < lane);
    }
    const unsigned at =
        __ballot_sync(kFull, lane < n_slices && rank == bound_rank - 1);
    te[j] = fminf(te[j], next_up(__shfl_sync(kFull, seen[j], __ffs(at) - 1)));
  }
}

// Pass 1. DIM > 0: refs staged in shared memory, queries in registers;
// DIM == 0: any `dim`, both read from global memory.
template <int DIM, int KS>
__global__ void __launch_bounds__(kThreads, 3)
knn_slices_kernel(const float* __restrict__ queries,
                  const float* __restrict__ refs, float* __restrict__ part_v,
                  int32_t* __restrict__ part_i, float* __restrict__ thresh,
                  int S, int E, int dim, int k, int slice_len) {
  constexpr int D = DIM > 0 ? DIM : 1;
  constexpr int DS = RowStride<D>::value;
  // DIM == 0 reads global memory in tiles of the same length, unstaged
  constexpr int kTile = TileRefs<(DIM > 0 ? DIM : 8)>::value;
  constexpr int kStageFloats = DIM > 0 ? kTile * DS : 1;
  __shared__ float stages[kStages][kStageFloats];
  __shared__ float2 scratch[kWarps][KS * kWarp];

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int q0 = (blockIdx.x * kWarps + warp) * QW;
  const int slice = blockIdx.y;
  const int lo = slice * slice_len;
  const int hi = (int)min((long long)E, (long long)lo + slice_len);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const bool warp_live = q0 < S;  // warp-uniform
  const bool aligned16 = (reinterpret_cast<uintptr_t>(refs) & 15) == 0;

  float q[QW][D];
  float te[QW];  // effective threshold: a ref is taken iff d < te
  float shown[QW];  // the value this slice last published for each query
  float lv[QW][KS];
  int32_t li[QW][KS];
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    const bool live = q0 + j < S;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      q[j][c] = live && DIM > 0 ? queries[(long long)(q0 + j) * D + c] : 0.0f;
    }
    te[j] = live ? kBig : -1.0f;  // a padded query takes nothing
    shown[j] = kBig;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      lv[j][s] = kBig;
      li[j][s] = 0;
    }
  }
  // the published k-th values (only with more than 32 slices), read one
  // tile ahead: lane j < QW holds query j's
  float pending = kBig;
  // Every slice also shows the value at rank `shown_rank` of each query's
  // list (its smallest value at 24 slices and k=16): `bound_rank` such
  // values from distinct slices are bound_rank * shown_rank >= k refs, so
  // the bound_rank-th smallest shown value bounds the query's k-th value
  // from above, much closer than any one slice's own k-th value.
  const int n_slices = gridDim.y;
  const bool show = n_slices > 1 && n_slices <= kWarp;
  const int shown_rank = (k + n_slices - 1) / n_slices;
  const int bound_rank = (k + shown_rank - 1) / shown_rank;
  float* shown_at = thresh + S + slice;  // + query * n_slices

  if constexpr (DIM > 0) {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) {
        stage_tile<DIM>(stages[t], refs, lo + t * kTile, hi, aligned16);
      }
      cp_async_commit();
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = lo + t * kTile;
    if constexpr (DIM > 0) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
      __syncthreads();  // everyone's; and stage (t - 1) % kStages is free
      const int tn = t + kStages - 1;
      if (tn < n_tiles) {
        stage_tile<DIM>(stages[tn % kStages], refs, lo + tn * kTile, hi,
                        aligned16);
      }
      cp_async_commit();
    }
    if (!warp_live) continue;

#pragma unroll
    for (int j = 0; j < QW; ++j) {
      te[j] = fminf(te[j], next_up(__shfl_sync(kFull, pending, j)));
    }
    pending = (!show && lane < QW && q0 + lane < S)
                  ? __ldcg(thresh + q0 + lane)
                  : kBig;
    // the shown values, at tiles 1, 2, 3, 4, 8, 16, ... (and at steps 1,
    // 2, 4 and 8 of tile 0, below): the candidates thin out as ln(refs
    // seen), and so do these reads
    if (show && t > 0 && (t <= 4 || (t & (t - 1)) == 0)) {
      apply_shown(te, thresh + S, S, q0, n_slices, bound_rank, lane);
    }

    const int steps = (min(kTile, hi - r0) + kStep - 1) / kStep;
    for (int st = 0; st < steps; ++st) {
      const int base = r0 + st * kStep;
      float d[kRefsPerLane][QW];
      bool any = false;
#pragma unroll
      for (int h = 0; h < kRefsPerLane; ++h) {
        if constexpr (DIM > 0) {
          const float* row =
              stages[t % kStages] + (st * kStep + h * kWarp + lane) * DS;
          float r[D];
#pragma unroll
          for (int c = 0; c < D; ++c) r[c] = row[c];
#pragma unroll
          for (int j = 0; j < QW; ++j) {
            d[h][j] = sq_dist<D>(q[j], r);
            any |= d[h][j] < te[j];
          }
        } else {
          const int ri = base + h * kWarp + lane;
#pragma unroll
          for (int j = 0; j < QW; ++j) {
            d[h][j] = kBig;
            if (ri < hi && q0 + j < S) {
              d[h][j] = sq_dist_any(queries + (long long)(q0 + j) * dim,
                                    refs + (long long)ri * dim, dim);
            }
            any |= d[h][j] < te[j];
          }
        }
      }
      if (!__any_sync(kFull, any)) continue;
      if (show && t == 0 && st > 0 && st <= 8 && (st & (st - 1)) == 0) {
        apply_shown(te, thresh + S, S, q0, n_slices, bound_rank, lane);
      }
      // refs in ascending index: the merge is by (value, index), so the
      // order of the merges does not change the lists
#pragma unroll
      for (int h = 0; h < kRefsPerLane; ++h) {
#pragma unroll
        for (int j = 0; j < QW; ++j) {
          const unsigned votes = __ballot_sync(kFull, d[h][j] < te[j]);
          if (votes) {
            merge_batch<KS>(lv[j], li[j], d[h][j], base + h * kWarp + lane,
                            votes, k, lane, scratch[warp]);
            float own;
            int32_t ti;
            kth_entry<KS>(lv[j], li[j], k, own, ti);
            te[j] = fminf(te[j], own);
            if (show) {
              float v;
              kth_entry<KS>(lv[j], li[j], shown_rank, v, ti);
              if (v < shown[j]) {
                shown[j] = v;
                if (lane == 0) shown_at[(long long)(q0 + j) * n_slices] = v;
              }
            } else if (own < kBig && lane == 0) {
              atomicMin(reinterpret_cast<int*>(thresh) + q0 + j,
                        __float_as_int(own));
            }
          }
        }
      }
    }
  }
  if constexpr (DIM > 0) cp_async_wait<0>();
  if (!warp_live) return;
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    if (q0 + j < S) {
      const long long row = ((long long)slice * S + q0 + j) * k;
      store_list<KS>(lv[j], li[j], part_v + row, part_i + row, k, lane);
    }
  }
}

template <int KS>
__device__ __forceinline__ void load_list(const float* __restrict__ part_v,
                                          const int32_t* __restrict__ part_i,
                                          long long row, int k, int lane,
                                          float (&cv)[KS], int32_t (&ci)[KS]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int j = s * kWarp + lane;
    cv[s] = j < k ? part_v[row + j] : kBig;
    ci[s] = j < k ? part_i[row + j] : 0;
  }
}

// Pass 2: merge the n_slices sorted lists of each query, in slice order;
// each list is loaded while the one before it merges.
template <int KS>
__global__ void __launch_bounds__(kWarp * kMergeWarps)
knn_merge_kernel(const float* __restrict__ part_v,
                 const int32_t* __restrict__ part_i, float* __restrict__ out_v,
                 int32_t* __restrict__ out_i, int S, int k, int n_slices) {
  __shared__ float2 scratch[kMergeWarps][KS * kWarp];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int qi = blockIdx.x * kMergeWarps + warp;
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
  float cv[KS];
  int32_t ci[KS];
  load_list<KS>(part_v, part_i, (long long)qi * k, k, lane, cv, ci);
  for (int p = 0; p < n_slices; ++p) {
    float nv[KS];
    int32_t ni[KS];
    if (p + 1 < n_slices) {
      load_list<KS>(part_v, part_i, ((long long)(p + 1) * S + qi) * k, k,
                    lane, nv, ni);
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const bool real = s * kWarp + lane < k;
      const unsigned votes =
          __ballot_sync(kFull, real && lex_less(cv[s], ci[s], tv, ti));
      if (votes) {
        merge_batch<KS>(lv, li, cv[s], ci[s], votes, k, lane, scratch[warp]);
        kth_entry<KS>(lv, li, k, tv, ti);
      }
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      cv[s] = nv[s];
      ci[s] = ni[s];
    }
  }
  store_list<KS>(lv, li, out_v + (long long)qi * k, out_i + (long long)qi * k,
                 k, lane);
}

template <int DIM, int KS>
void launch_slices(const float* q, const float* refs, float* pv, int32_t* pi,
                   float* thresh, int S, int E, int dim, int k, int n_slices,
                   int slice_len, cudaStream_t st) {
  constexpr int QB = kWarps * QW;
  const dim3 grid((S + QB - 1) / QB, n_slices);
  knn_slices_kernel<DIM, KS><<<grid, kThreads, 0, st>>>(
      q, refs, pv, pi, thresh, S, E, dim, k, slice_len);
}

template <int DIM, int KS>
int occupancy() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, knn_slices_kernel<DIM, KS>, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Calls CALL(DIM, KS) for the runtime (dim, KS).
#define GRAPHEM_DISPATCH(DIMV, KSV, CALL)               \
  switch (KSV) {                                        \
    case 1: GRAPHEM_DISPATCH_DIM(DIMV, 1, CALL) break;  \
    case 2: GRAPHEM_DISPATCH_DIM(DIMV, 2, CALL) break;  \
    case 3: GRAPHEM_DISPATCH_DIM(DIMV, 3, CALL) break;  \
    default: GRAPHEM_DISPATCH_DIM(DIMV, 4, CALL) break; \
  }
#define GRAPHEM_DISPATCH_DIM(DIMV, KS, CALL) \
  switch (DIMV) {                            \
    case 1: CALL(1, KS); break;              \
    case 2: CALL(2, KS); break;              \
    case 3: CALL(3, KS); break;              \
    case 4: CALL(4, KS); break;              \
    case 5: CALL(5, KS); break;              \
    case 6: CALL(6, KS); break;              \
    case 7: CALL(7, KS); break;              \
    case 8: CALL(8, KS); break;              \
    default: CALL(0, KS); break;             \
  }

template <int KS>
void launch_merge(const float* pv, const int32_t* pi, float* out_v,
                  int32_t* out_i, int S, int k, int n_slices,
                  cudaStream_t st) {
  const int blocks = (S + kMergeWarps - 1) / kMergeWarps;
  knn_merge_kernel<KS><<<blocks, kWarp * kMergeWarps, 0, st>>>(
      pv, pi, out_v, out_i, S, k, n_slices);
}

}  // namespace

// Resident pass-1 blocks per SM for this (dim, k), or minus a CUDA error.
extern "C" int graphem_knn_tiled_blocks_per_sm(int dim, int k) {
  if (dim < 1 || k < 1 || k > 4 * kWarp) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int n = 0;
#define GRAPHEM_OCC(D, KS) n = occupancy<D, KS>()
  GRAPHEM_DISPATCH(dim, (k + kWarp - 1) / kWarp, GRAPHEM_OCC)
#undef GRAPHEM_OCC
  return n;
}

// Launches the exact kNN on `stream` and returns cudaGetLastError() (0 on
// success). queries (S, dim) and refs (E, dim) are contiguous fp32; out_v /
// out_i are (S, k); part_v / part_i are (n_slices, S, k) scratch, unused
// when n_slices == 1; thresh is (S * (1 + n_slices),) fp32 scratch, set
// here: each query's published k-th value (used with more than 32
// slices), then each slice's shown value for each query. Slice p
// covers refs [p * slice_len, (p+1) * slice_len), slice_len a multiple of
// 512. The wrapper checks 1 <= k <= 128, S >= 1, dim >= 1 and
// E < 2^31 - 2^20.
extern "C" int graphem_knn_tiled_launch(const float* queries, const float* refs,
                                        float* part_v, int32_t* part_i,
                                        float* thresh, float* out_v,
                                        int32_t* out_i, int S, int E, int dim,
                                        int k, int n_slices, int slice_len,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // slices start on 512-ref boundaries: the 16-byte staging copies of a
  // whole tile rely on it
  if (S < 1 || dim < 1 || k < 1 || k > 4 * kWarp || n_slices < 1 ||
      n_slices > 65535 || slice_len < 1 || slice_len % 512 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // bytes 0x7f: 3.39e38, above every value a slice can publish
  cudaError_t err = cudaMemsetAsync(
      thresh, 0x7f, sizeof(float) * (size_t)S * (1 + n_slices), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pv = n_slices == 1 ? out_v : part_v;
  int32_t* pi = n_slices == 1 ? out_i : part_i;
  const int ks = (k + kWarp - 1) / kWarp;
#define GRAPHEM_SLICES(D, KS)                                                 \
  launch_slices<D, KS>(queries, refs, pv, pi, thresh, S, E, dim, k, n_slices, \
                       slice_len, st)
  GRAPHEM_DISPATCH(dim, ks, GRAPHEM_SLICES)
#undef GRAPHEM_SLICES
  if (n_slices > 1) {
    switch (ks) {
      case 1: launch_merge<1>(part_v, part_i, out_v, out_i, S, k, n_slices, st); break;
      case 2: launch_merge<2>(part_v, part_i, out_v, out_i, S, k, n_slices, st); break;
      case 3: launch_merge<3>(part_v, part_i, out_v, out_i, S, k, n_slices, st); break;
      default: launch_merge<4>(part_v, part_i, out_v, out_i, S, k, n_slices, st); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
