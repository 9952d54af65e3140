// The bin fold's work plan, shared by the bin-fold kernel (K1,
// binfold.cu) and the ring hop kernel (K3, ring_binfold.cu).
//
// The fold: the reference at flat position p (tile p / T, lane p % 128)
// folds into bin ((p / T) % G) * 128 + p % 128; its squared distance to a
// query is accumulated coordinate by coordinate in order, in fp32 with
// round-to-nearest and no fused multiply-add; a bin keeps (value, p) of the
// first strict minimum in visit order, starting from (3.0e38, 0); positions
// p >= E read the pad coordinate 1.0e15. binfold.cu's header states the
// semantics in full; ring_binfold.cu's states what the ring adds.
//
// The plan. The work is U = G * ceil(S / QB) * n_super units: (bin group g,
// query block, super-tile s), each QB queries against the T refs of one
// tile. The grid is exactly the resident block count nb (the wrapper's
// `fold_plan`, from the occupancy the card reports), and block b walks the
// units [b * U / nb, (b + 1) * U / nb) in order (g, query block, s), so
// every block gets the same work to within one unit and the card runs one
// wave. A block's range cuts the run of a (g, query block) over its
// super-tiles into at most three kinds of run: whole (written straight to
// the outputs), or a piece at the start or end of its range. A piece
// writes its (value, p) pairs to the block's slot in a scratch buffer; the
// block that completes a segment's super-tiles (an atomicAdd on the
// segment's count) folds the pieces. Within a bin the visit order is
// ascending p, so the first strict minimum is the lexicographic minimum of
// (value, p), and the pieces are folded as 64-bit keys
// (bits(value) << 32) | p, which order as (value, p) because the values
// are >= +0 and their IEEE bits order as unsigned integers; a piece that
// took nothing holds (3.0e38, 0), whose key is below every (3.0e38, p > 0)
// and above every real value. In the sweep a thread keeps QB queries and
// their QB (value, p) pairs in registers (QB = 16 at d <= 3, else 8; up to
// 128 registers, 4 blocks of 128 threads per SM), and loads the next
// chunk's ref while it folds the current one.
//
// The epilogue. A bin's answer (value, p) is written by exactly one
// thread: the thread of its lane in the block that folds the whole run, or
// in the block that completes the segment. K1 writes it as it is. K3
// (merge_bins) makes the id offset + p where the value is below 3.0e38 (0
// elsewhere), and first reads the carry at the same place, keeping it
// unless the new value is strictly below it; since no other thread reads
// or writes that place, the output may be the carry. The sweep is the
// same for both; the ring flag changes only the epilogue. The carry is
// read through L2 (__ldcg): in the whole-ring launch (ring_binfold.cu) it is
// a slot that the left neighbour's card stores into between hops, and a
// line of it left in this SM's L1 by an earlier hop would be stale.
//
// The hop hook. fold_units takes a Hook that owns the segment counts'
// target, runs before each epilogue, and hands out the pointers of the
// epilogue and the pieces. PlainHop, the default,
// is K1's and K3's per-hop launch: counts zeroed by the launch, a segment
// complete at n_super, nothing to wait for (it is empty and inlines to
// nothing, so K1's code is what it was). The whole-ring launch passes a
// hook whose counts run on across hops and launches and which waits for
// the carry and the neighbour's slot there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace graphem_fold {

constexpr int kLanes = 128;
constexpr float kBig = 3.0e38f;
constexpr float kPadCoord = 1.0e15f;

struct PlainHop {
  using Count = int;
  __device__ __forceinline__ Count target(int n_super) const {
    return n_super;
  }
  __device__ __forceinline__ void before_epilogue() {}
  // The launch's arguments as they are. A hook may hand out its own
  // instead, from memory rather than registers kept through the sweep.
  __device__ __forceinline__ const float* queries(const float* p) const {
    return p;
  }
  __device__ __forceinline__ const float* carry_vals(const float* p) const {
    return p;
  }
  __device__ __forceinline__ const int32_t* carry_idx(const int32_t* p) const {
    return p;
  }
  __device__ __forceinline__ float* out_vals(float* p) const { return p; }
  __device__ __forceinline__ int32_t* out_idx(int32_t* p) const { return p; }
  __device__ __forceinline__ float* part_v(float* p) const { return p; }
  __device__ __forceinline__ int32_t* part_i(int32_t* p) const { return p; }
  __device__ __forceinline__ Count* seg_done(Count* p) const { return p; }
  __device__ __forceinline__ int offset(int o) const { return o; }
};

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

// The ring's epilogue for one thread's bins (queries q0.., this lane's
// bin): ids offset + p, then the merge with the carry, which may be NULL.
// Every carry value and id is loaded before any bin is stored: the output
// may alias the carry, so a load could not pass an earlier store, and the
// loads would otherwise wait for each other. out and carry are not
// __restrict__ for the same reason.
template <int QB>
__device__ __forceinline__ void merge_bins(float* out_vals, int32_t* out_idx,
                                           const float* carry_vals,
                                           const int32_t* carry_idx, int q0,
                                           int S, long long n_bins,
                                           long long bin, float (&v)[QB],
                                           const int32_t (&p)[QB],
                                           int offset) {
  int32_t id[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) id[j] = v[j] < kBig ? offset + p[j] : 0;
  if (carry_vals != nullptr) {
    float cv[QB];
    int32_t ci[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      cv[j] = kBig;
      ci[j] = 0;
      if (q0 + j < S) {
        cv[j] = __ldcg(carry_vals + (q0 + j) * n_bins + bin);
        ci[j] = __ldcg(carry_idx + (q0 + j) * n_bins + bin);
      }
    }
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      if (!(v[j] < cv[j])) {  // the carry, the ranks folded before, wins a tie
        v[j] = cv[j];
        id[j] = ci[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    if (q0 + j < S) {
      out_vals[(q0 + j) * n_bins + bin] = v[j];
      out_idx[(q0 + j) * n_bins + bin] = id[j];
    }
  }
}

// Block blockIdx.x's units of the plan; n_qblk = ceil(S / QB), nb the
// grid. The carry (RING only) may be NULL and may alias the output.
// hook.before_epilogue() runs before each epilogue, uniformly in the block;
// a segment is complete when its count reaches hook.target(n_super).
template <int DIM, bool RING, class Hook = PlainHop>
__device__ __forceinline__ void fold_units(
    const float* __restrict__ queries, const float* __restrict__ refs,
    const float* carry_vals, const int32_t* carry_idx, float* out_vals,
    int32_t* out_idx, float* __restrict__ part_v,
    int32_t* __restrict__ part_i, typename Hook::Count* __restrict__ seg_done,
    int S, int E, int T, int G, int n_super, int n_qblk, int nb, int offset,
    Hook hook = Hook()) {
  using Count = typename Hook::Count;
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
        q[j][c] = q0 + j < S
                      ? hook.queries(queries)[(long long)(q0 + j) * DIM + c]
                      : 0.0f;
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
      if constexpr (RING) {
        hook.before_epilogue();
        merge_bins<QB>(hook.out_vals(out_vals), hook.out_idx(out_idx),
                       hook.carry_vals(carry_vals), hook.carry_idx(carry_idx),
                       q0, S, n_bins, bin, v, ix, hook.offset(offset));
      } else {
#pragma unroll
        for (int j = 0; j < QB; ++j) {
          if (q0 + j < S) {
            out_vals[(q0 + j) * n_bins + bin] = v[j];
            out_idx[(q0 + j) * n_bins + bin] = ix[j];
          }
        }
      }
    } else {
      // a piece: slot 0 for the run at the start of the range, 1 at its end
      const long long slot = ((long long)b * 2 + (u == u0 ? 0 : 1)) * QB;
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        hook.part_v(part_v)[(slot + j) * kLanes + lane] = v[j];
        hook.part_i(part_i)[(slot + j) * kLanes + lane] = ix[j];
      }
      __threadfence();
      __syncthreads();
      if (lane == 0) {
        const Count add = static_cast<Count>(s1 - s0);
        last_piece =
            atomicAdd(hook.seg_done(seg_done) + seg, add) + add ==
            hook.target(n_super);
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
                pack_key(
                    __ldcg(hook.part_v(part_v) + (ps + j) * kLanes + lane),
                    __ldcg(hook.part_i(part_i) + (ps + j) * kLanes + lane));
            key[j] = kk < key[j] ? kk : key[j];
          }
        }
        if constexpr (RING) {
          hook.before_epilogue();
          float kv[QB];
          int32_t kp[QB];
#pragma unroll
          for (int j = 0; j < QB; ++j) {
            kv[j] = __uint_as_float((unsigned int)(key[j] >> 32));
            kp[j] = (int32_t)(key[j] & 0xffffffffu);
          }
          merge_bins<QB>(hook.out_vals(out_vals), hook.out_idx(out_idx),
                         hook.carry_vals(carry_vals),
                         hook.carry_idx(carry_idx), q0, S, n_bins, bin, kv,
                         kp, hook.offset(offset));
        } else {
#pragma unroll
          for (int j = 0; j < QB; ++j) {
            if (q0 + j < S) {
              out_vals[(q0 + j) * n_bins + bin] =
                  __uint_as_float((unsigned int)(key[j] >> 32));
              out_idx[(q0 + j) * n_bins + bin] =
                  (int32_t)(key[j] & 0xffffffffu);
            }
          }
        }
      }
    }
    u += s1 - s0;
  }
}

// Zeroes the G * n_qblk segment counts on `stream`; a CUDA error code.
inline int zero_segments(int* seg_done, int G, int n_qblk,
                         cudaStream_t stream) {
  return static_cast<int>(cudaMemsetAsync(
      seg_done, 0, sizeof(int) * (size_t)G * n_qblk, stream));
}

// Resident blocks per SM of `kernel`, or minus a CUDA error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kLanes, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace graphem_fold
