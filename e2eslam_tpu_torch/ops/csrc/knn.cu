// Exact top-1 nearest-neighbour search for Hopper (sm_90a): the three
// kernels behind the port's 3D point loss.
//
// Each replaces one Pallas kernel of e2eslam_tpu/ops/knn.py:
//   knn_dense_kernel    <- _dense_pallas_call / _make_knn_kernel(cand=False)
//                          (_knn_kernel_body): every ref tile, newest first
//   knn_cand_kernel     <- _cand_pallas_call / _make_knn_kernel(cand=True):
//                          only the ref tiles a per-query-tile table lists,
//                          best first
//   knn_resident_kernel <- _resident_pallas_call / _make_resident_kernel:
//                          refs of at most 131,072 rows in sub-tiles, the
//                          best sub-tile first, then a pruned sweep
//
// What they compute (all three): for each query q of the block's tile, the
// running maximum over visited refs r of the score
//     s = q.r - 0.5 |r|^2     (queries [q, 1], refs [r, -0.5|r|^2] as float4)
// with its index; refs past the valid count carry the bias -1e30 and never
// win. The caller turns the best score into |q|^2 - 2 s. Warm seeds (s0,
// i0) start the running maximum. Within a tile the lowest index of equal
// scores wins; across tiles a later tile must be strictly better -- both
// follow from the strict '>' over rows in ascending order, the semantics of
// the Pallas kernels' argmax-then-'>' (knn.py:264-270).
//
// Pruning (identical test in all three): a ref tile is skipped when the
// squared gap between its bounding box and the query tile's bounding box is
// not below the tile's worst best distance (the largest |q|^2 - 2 s over the
// tile's valid queries). A skipped tile holds no ref strictly better than
// any query's current best, so the result does not depend on pruning.
//
// What bounds them on the H100 and what the design does about it: the work
// is one 3-FMA score, a compare and two selects per visited (query, ref)
// pair, on fp32 CUDA cores (K = 4 is no shape for tensor cores, and TF32
// would corrupt the argmax). Refs move once per visited tile per block, so
// at the main path's pruned shapes the kernels are bound by instruction
// issue, not by memory. The design keeps what the instructions touch close:
//   * one block per query tile, one query per thread, the query and its
//     running (score, index) in registers;
//   * ref rows staged 2048 at a time (32 KB) in shared memory and read by
//     all threads of the block as broadcasts;
//   * the query tile's bounding box and worst best distance reduced in
//     shared memory with warp shuffles, so every pruning branch is uniform
//     across the block;
//   * no carry between blocks (the Pallas grid's sequential ref axis
//     becomes a loop inside the block), and no replicated output rows: the
//     results go straight to [Nq].
// The resident variant's 2 MB of refs exceeds the 227 KB a block may hold;
// it streams its sub-tiles through the same 32 KB stage, from L2 where the
// refs stay resident across blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define STAGE_ROWS 2048
#define MAX_WARPS 32
#define MAX_SUBTILES 1024
#define NEG_BIAS (-1e30f)

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max / min; every thread receives the same value.
static __device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  return warp_max(lane < nw ? red[lane] : -INFINITY);
}

static __device__ float block_min(float v, float* red) {
  v = warp_min(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  return warp_min(lane < nw ? red[lane] : INFINITY);
}

// Per-block query state.
struct Query {
  float4 q;     // [qx, qy, qz, 1]
  float q2;     // |q|^2, as the Pallas kernel recovers it: sum(q4*q4) - 1
  bool valid;   // row < nq
  float best;   // running best score
  int idx;      // its ref index
  float lo[3], hi[3];  // the query tile's bounding box (uniform)
};

static __device__ void init_query(Query& Q, const float4* __restrict__ q4,
                           const float* __restrict__ s0, const int* __restrict__ i0,
                           int nq, float* red) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  Q.q = q4[row];
  Q.q2 = Q.q.x * Q.q.x + Q.q.y * Q.q.y + Q.q.z * Q.q.z + Q.q.w * Q.q.w - 1.0f;
  Q.valid = row < nq;
  Q.best = s0 ? s0[row] : NEG_BIAS;
  Q.idx = i0 ? i0[row] : 0;
  // Every row of the tile (padding included) widens the box, as in Pallas.
  const float c[3] = {Q.q.x, Q.q.y, Q.q.z};
  for (int a = 0; a < 3; ++a) {
    Q.lo[a] = block_min(c[a], red);
    Q.hi[a] = block_max(c[a], red);
  }
}

// The tile's worst best squared distance over its valid queries.
__device__ __forceinline__ float worst_best(const Query& Q, float* red) {
  return block_max(Q.valid ? Q.q2 - 2.0f * Q.best : -INFINITY, red);
}

// Squared gap between the query tile's box and a ref box [lo3, hi3, _, _].
__device__ __forceinline__ float box_gap2(const Query& Q, const float* __restrict__ bb) {
  float lb2 = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float gap = fmaxf(fmaxf(Q.lo[a] - bb[3 + a], bb[a] - Q.hi[a]), 0.0f);
    lb2 += gap * gap;
  }
  return lb2;
}

// Score rows [first, first + n) of r4 against the block's queries.
static __device__ void visit_rows(Query& Q, const float4* __restrict__ r4, int first, int n,
                           float4* stage) {
  for (int c = 0; c < n; c += STAGE_ROWS) {
    const int m = min(STAGE_ROWS, n - c);
    __syncthreads();  // the previous stage is no longer read
    for (int k = threadIdx.x; k < m; k += blockDim.x) stage[k] = r4[first + c + k];
    __syncthreads();
    float best = Q.best;
    int idx = Q.idx;
    const int base = first + c;
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const float4 r = stage[k];
      const float s = fmaf(Q.q.x, r.x, fmaf(Q.q.y, r.y, fmaf(Q.q.z, r.z, r.w)));
      if (s > best) {
        best = s;
        idx = base + k;
      }
    }
    Q.best = best;
    Q.idx = idx;
  }
}

__device__ __forceinline__ void write_out(const Query& Q, float* out_s, int* out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  out_s[row] = Q.best;
  out_i[row] = Q.idx;
}

// Dense: every ref tile, newest first (a sequential map's best matches live
// in its latest appends, which then set a tight bound early).
__global__ void knn_dense_kernel(const float4* __restrict__ q4, const float4* __restrict__ r4,
                                 const float* __restrict__ rbb, const float* __restrict__ s0,
                                 const int* __restrict__ i0, int nq, int nr, int nrt, int rt,
                                 float* __restrict__ out_s, int* __restrict__ out_i,
                                 int* __restrict__ visits) {
  extern __shared__ float4 stage[];
  __shared__ float red[MAX_WARPS];
  Query Q;
  init_query(Q, q4, s0, i0, nq, red);
  float wb = s0 ? worst_best(Q, red) : INFINITY;
  int visited = 0;
  if (blockIdx.x * blockDim.x < nq) {
    for (int j = 0; j < nrt; ++j) {
      const int jr = nrt - 1 - j;
      if (jr * rt >= nr) continue;
      if (!(box_gap2(Q, rbb + 8 * jr) < wb)) continue;
      visit_rows(Q, r4, jr * rt, rt, stage);
      visited += rt;
      wb = worst_best(Q, red);
    }
  }
  write_out(Q, out_s, out_i);
  if (visits && threadIdx.x == 0) visits[blockIdx.x] = visited;
}

// Candidate table: only the ref tiles listed for this query tile, best
// first; entries past cnt are not visited.
__global__ void knn_cand_kernel(const float4* __restrict__ q4, const float4* __restrict__ r4,
                                const float* __restrict__ rbb, const float* __restrict__ s0,
                                const int* __restrict__ i0, const int* __restrict__ cand,
                                const int* __restrict__ cnt, int mc, int nq, int nr, int rt,
                                float* __restrict__ out_s, int* __restrict__ out_i,
                                int* __restrict__ visits) {
  extern __shared__ float4 stage[];
  __shared__ float red[MAX_WARPS];
  Query Q;
  init_query(Q, q4, s0, i0, nq, red);
  float wb = worst_best(Q, red);
  int visited = 0;
  if (blockIdx.x * blockDim.x < nq) {
    const int n = min(cnt[blockIdx.x], mc);
    const int* row = cand + (size_t)blockIdx.x * mc;
    for (int j = 0; j < n; ++j) {
      const int jr = row[j];
      if (jr * rt >= nr) continue;
      if (!(box_gap2(Q, rbb + 8 * jr) < wb)) continue;
      visit_rows(Q, r4, jr * rt, rt, stage);
      visited += rt;
      wb = worst_best(Q, red);
    }
  }
  write_out(Q, out_s, out_i);
  if (visits && threadIdx.x == 0) visits[blockIdx.x] = visited;
}

// Resident: S sub-tiles of st rows; pass 0 bounds every sub-tile, the
// best one is visited first, then the pruned sweep covers the rest.
__global__ void knn_resident_kernel(const float4* __restrict__ q4, const float4* __restrict__ r4,
                                    const float* __restrict__ rbb, const float* __restrict__ s0,
                                    const int* __restrict__ i0, int nq, int nr, int S, int st,
                                    float* __restrict__ out_s, int* __restrict__ out_i,
                                    int* __restrict__ visits) {
  extern __shared__ float4 stage[];
  __shared__ float red[MAX_WARPS];
  __shared__ float lbs[MAX_SUBTILES];
  __shared__ int first_s;
  Query Q;
  init_query(Q, q4, s0, i0, nq, red);
  float wb = s0 ? worst_best(Q, red) : INFINITY;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    lbs[s] = (s * st < nr) ? box_gap2(Q, rbb + 8 * s) : INFINITY;
  __syncthreads();
  if (threadIdx.x == 0) {
    float best_lb = INFINITY;
    int best_s = 0;
    for (int s = 0; s < S; ++s)
      if (lbs[s] < best_lb) {
        best_lb = lbs[s];
        best_s = s;
      }
    first_s = best_s;
  }
  __syncthreads();
  const int sf = first_s;
  int visited = 0;
  if (blockIdx.x * blockDim.x < nq) {
    if (lbs[sf] < wb) {
      visit_rows(Q, r4, sf * st, st, stage);
      visited += st;
      wb = worst_best(Q, red);
    }
    for (int s = 0; s < S; ++s) {
      if (s == sf || !(lbs[s] < wb)) continue;
      visit_rows(Q, r4, s * st, st, stage);
      visited += st;
      wb = worst_best(Q, red);
    }
  }
  write_out(Q, out_s, out_i);
  if (visits && threadIdx.x == 0) visits[blockIdx.x] = visited;
}

// Plain C entry points, loaded with ctypes. Each launches on the given
// stream, allocates nothing and returns cudaGetLastError() (0 = launched).
// n_qt blocks of qt threads; qt is a multiple of 32, at most 1024.

extern "C" int knn_dense_launch(const void* q4, const void* r4, const void* rbb,
                                const void* s0, const void* i0, int n_qt, int qt, int nq,
                                int nr, int nrt, int rt, void* out_s, void* out_i,
                                void* visits, void* stream) {
  knn_dense_kernel<<<n_qt, qt, STAGE_ROWS * sizeof(float4), (cudaStream_t)stream>>>(
      (const float4*)q4, (const float4*)r4, (const float*)rbb, (const float*)s0,
      (const int*)i0, nq, nr, nrt, rt, (float*)out_s, (int*)out_i, (int*)visits);
  return (int)cudaGetLastError();
}

extern "C" int knn_cand_launch(const void* q4, const void* r4, const void* rbb,
                               const void* s0, const void* i0, const void* cand,
                               const void* cnt, int mc, int n_qt, int qt, int nq, int nr,
                               int rt, void* out_s, void* out_i, void* visits,
                               void* stream) {
  knn_cand_kernel<<<n_qt, qt, STAGE_ROWS * sizeof(float4), (cudaStream_t)stream>>>(
      (const float4*)q4, (const float4*)r4, (const float*)rbb, (const float*)s0,
      (const int*)i0, (const int*)cand, (const int*)cnt, mc, nq, nr, rt, (float*)out_s,
      (int*)out_i, (int*)visits);
  return (int)cudaGetLastError();
}

extern "C" int knn_resident_launch(const void* q4, const void* r4, const void* rbb,
                                   const void* s0, const void* i0, int n_qt, int qt,
                                   int nq, int nr, int S, int st, void* out_s, void* out_i,
                                   void* visits, void* stream) {
  knn_resident_kernel<<<n_qt, qt, STAGE_ROWS * sizeof(float4), (cudaStream_t)stream>>>(
      (const float4*)q4, (const float4*)r4, (const float*)rbb, (const float*)s0,
      (const int*)i0, nq, nr, S, st, (float*)out_s, (int*)out_i, (int*)visits);
  return (int)cudaGetLastError();
}
