// Exact top-1 nearest-neighbour search for Hopper (sm_90a): the three
// kernels behind the port's 3D point loss.
//
// Each replaces one Pallas kernel of e2eslam_tpu/ops/knn.py:
//   knn_dense_kernel    <- _dense_pallas_call / _make_knn_kernel(cand=False)
//                          (_knn_kernel_body): every valid ref tile, newest
//                          first
//   knn_cand_kernel     <- _cand_pallas_call / _make_knn_kernel(cand=True):
//                          only the ref tiles a per-query-tile table lists,
//                          best first
//   knn_resident_kernel <- _resident_pallas_call / _make_resident_kernel:
//                          refs of at most 131,072 rows in sub-tiles, the
//                          best sub-tile first, then a pruned sweep
//
// What they compute (all three): for each query q of a query tile, the
// running maximum over visited refs r of the score
//     s = q.r - 0.5 |r|^2     (queries [q, 1], refs [r, -0.5|r|^2] as float4)
// with its index; refs past the valid count carry the bias -1e30 and never
// win. The caller turns the best score into |q|^2 - 2 s. Warm seeds (s0,
// i0) start the running maximum. Within a tile the lowest index of equal
// scores wins; across tiles a later tile must be strictly better -- both
// follow from the strict '>' over rows in ascending order, the semantics of
// the Pallas kernels' argmax-then-'>' (knn.py:264-270).
//
// Pruning: a ref tile cannot improve a set of queries when the squared gap
// between its bounding box and the queries' box is not below their worst
// best distance (the largest |q|^2 - 2 s over the valid ones). Skipping it
// never changes the result.
//
// ---- The walk kernels (dense and candidate) ------------------------------
// Both walk a list of ref tiles -- the table's row for the candidate kernel,
// the valid tiles newest first for the dense one -- with one scoring core.
// What bounds them is instruction issue on the fp32 CUDA cores: per scored
// (query, ref) pair three FMAs and a max. Refs are read once per visited
// chunk per work item, from L2, so bytes are far below the time. The design:
//   * Several queries per thread (QPT) in registers: each shared-memory read
//     of a ref row (a broadcast float4) feeds QPT scores.
//   * Max first, index later: the scan keeps only running maxima, two per
//     query over interleaved rows (independent chains), over groups of
//     GROUP rows; a group's maximum replaces the best only when strictly
//     better, and remembers its group. After the chunk, a query whose best
//     moved rescans that one group for the first row reaching it. That is
//     the strict-'>' rule: the lowest row of the maximum wins. Per pair the
//     scan costs three FMAs and a max, plus 3/GROUP for the group step.
//   * One warp per work item, pruned on its own: a work item is a query
//     group (32 * QPT queries of a query tile, one warp) with its own box
//     and worst-best distance, walking a share of its query tile's list. It
//     stages and scores only the chunks its bound admits, with no block
//     barrier, so a far outlier query keeps its own group sweeping, not the
//     whole tile.
//   * Asynchronous staging: chunks of CHUNK rows go to the warp's shared
//     memory with cp.async into two buffers, so the next chunk (the same
//     tile's next one, or the first of the next admitted tile) loads while
//     this one is scored.
//   * Balance across the card: a query group's list is split into shares
//     of at least SPLIT_MIN entries (ops/knn.py), at most MAX_SPLITS, list
//     positions interleaved (share s walks positions s, s + splits, ...), so
//     each share starts at its best tiles. The shares are counted in the
//     kernel, so nothing is sized on the host: persistent one-warp blocks,
//     as many as fit on the SMs, take work items from one atomic counter,
//     query tiles in the order the wrapper gives (longest list first), a
//     group's shares side by side. A long list therefore neither sets the
//     kernel's time alone nor starts last.
//   * Exact merge: every share folds its (score, rank) into one 64-bit
//     atomic maximum per query -- the score, then the lower rank, where the
//     seed is rank 0 and row r of list position p is (p + 1) * rt + r --
//     and the group's last share to finish unpacks it. Within a share the
//     winner is the lowest (position, row) of its maximum, so the merge
//     reproduces the sequential walk exactly: cand_plain stays the oracle.
// Tensor cores: a single TF32 pass would corrupt the argmax
// (e2eslam_tpu/ops/knn.py:251-258). The choice is CUDA cores. The scan
// issues about 4.7 instructions per pair (three FFMA, one FMNMX, half an
// LDS.128, the group step) and scored 4.5e12 pairs/s on an H100 80GB HBM3
// at 700 W (chip_smoke.py's cold 81,920 x 300,000 dense call: 2.47e10 pairs
// in 5.48 ms, 47% of the bound of 7 fp32 operations a pair at 67 TFLOP/s).
// A split-precision mma (3xTF32, or fp64 m8n8k4 whose K is the 4 of
// [q, 1].[r, -|r|^2/2]) could take over the three FMAs only: the max stays
// one CUDA-core instruction per pair, now read from accumulator fragments,
// so at most ~2x on the scan, against three mma passes per product and
// scores that no longer match the plain version's rounding row by row.
// QPT = 4 measured slower (coarser per-warp pruning, 64-register cap).
//
// ---- The resident kernel (not redesigned) --------------------------------
// One block per 256-query tile, one query per thread; sub-tiles are staged
// 2048 rows at a time (32 KB) synchronously and read as broadcasts; the
// tile's box and worst-best distance come from block reductions, so its
// pruning is block-uniform. Its 2 MB of refs exceed the 227 KB a block may
// hold; it streams its sub-tiles from L2, where they stay across blocks.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define STAGE_ROWS 2048
#define MAX_WARPS 32
#define MAX_SUBTILES 1024
#define NEG_BIAS (-1e30f)

#define QPT 2            // queries per thread in the walk kernels
#define CHUNK 256        // ref rows per staged chunk (4 KB)
#define GROUP 16         // rows per running maximum before it meets the best
#define FULL 0xffffffffu

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float score(float x, float y, float z, float4 r) {
  return fmaf(x, r.x, fmaf(y, r.y, fmaf(z, r.z, r.w)));
}

// Squared gap between a query box (lo3, hi3) and a ref box [lo3, hi3, _, _].
__device__ __forceinline__ float gap2(const float* lo, const float* hi,
                                      const float* __restrict__ bb) {
  float lb2 = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float gap = fmaxf(fmaxf(lo[a] - bb[3 + a], bb[a] - hi[a]), 0.0f);
    lb2 += gap * gap;
  }
  return lb2;
}

// ---------------------------------------------------------------------------
// the walk kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct WalkArgs {
  const float4* q4;
  const float4* r4;
  const float* rbb;
  const float* s0;
  const int* i0;
  const int* cand;   // [n_qt, mc] (candidate kernel) or null (dense)
  const int* cnt;    // [n_qt] (candidate kernel) or null (dense)
  const int* order;  // query tiles, longest list first (null: in order)
  int mc, qt, nq, nr, nrt, rt, n_groups, split_min, max_splits;
  float* out_s;
  int* out_i;
  unsigned long long* merged;  // [nq_pad] zeros: packed (score, rank) maxima
  int* work;  // [n_groups + 1] zeros: per group the shares done, then the queue
  long long* visits;  // [n_groups * max_splits, 2]: per item rows staged, pairs scored
};

// The length of query tile qtile's list.
template <bool kCand>
__device__ __forceinline__ int list_len(const WalkArgs& A, int qtile) {
  return kCand ? min(A.cnt[qtile], A.mc) : min((A.nr + A.rt - 1) / A.rt, A.nrt);
}

// The ref tile at list position p of query tile qtile (-1: none).
template <bool kCand>
__device__ __forceinline__ int tile_at(const WalkArgs& A, int qtile, int n_list, int p) {
  const int t = kCand ? A.cand[(size_t)qtile * A.mc + p] : n_list - 1 - p;
  return (t >= 0 && t < A.nrt && t * A.rt < A.nr) ? t : -1;
}

// The first entry k >= k0 (list position split + k * splits) whose tile the
// warp's bound admits (nk: none), tested 32 entries at a time.
template <bool kCand>
__device__ int next_needed(const WalkArgs& A, int qtile, int n_list, int split, int splits,
                           int nk, int k0, const float* lo, const float* hi, float wb) {
  for (int base = k0; base < nk; base += 32) {
    const int k = base + threadIdx.x;
    bool need = false;
    if (k < nk) {
      const int t = tile_at<kCand>(A, qtile, n_list, split + k * splits);
      need = t >= 0 && gap2(lo, hi, A.rbb + 8 * t) < wb;
    }
    const unsigned bal = __ballot_sync(FULL, need);
    if (bal) return base + __ffs(bal) - 1;
  }
  return nk;
}

__device__ __forceinline__ void stage_chunk(const WalkArgs& A, float4* dst, int t, int c,
                                            int ch) {
  const float4* src = A.r4 + (size_t)t * A.rt + (size_t)c * ch;
  for (int k = threadIdx.x; k < ch; k += 32) cp_async16(dst + k, src + k);
  cp_async_commit();
}

// A score and its place in the walk packed so that the larger value is the
// better: the score (ordered as an unsigned, +0 for either zero), then the
// lower rank. Rank 0 is the seed, (p + 1) * rt + r row r of list position p.
__device__ __forceinline__ unsigned long long pack(float s, unsigned rank) {
  unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xffffffffu - rank);
}

// One work item: the query group `group` (32 * QPT queries of a query
// tile, one warp) walks list positions split, split + splits, ...
template <bool kCand>
__device__ void walk_item(const WalkArgs& A, float4 (*stage)[CHUNK], int item, int qtile,
                          int group, int split, int splits) {
  const int lane = threadIdx.x;
  const int row0 = group * 32 * QPT + lane;
  const int n_list = list_len<kCand>(A, qtile);

  // The thread's queries (rows row0 + 32 i), their seeds and the warp's box.
  float qx[QPT], qy[QPT], qz[QPT], q2[QPT], best[QPT];
  int idx[QPT], pos[QPT];
  bool valid[QPT];
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int row = row0 + 32 * i;
    const float4 q = A.q4[row];
    qx[i] = q.x, qy[i] = q.y, qz[i] = q.z;
    q2[i] = q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w - 1.0f;  // as Pallas
    valid[i] = row < A.nq;
    best[i] = A.s0 ? A.s0[row] : NEG_BIAS;
    idx[i] = A.i0 ? A.i0[row] : 0;
    pos[i] = -1;  // the seed comes before every list position
    if (valid[i]) {
      lo[0] = fminf(lo[0], q.x), lo[1] = fminf(lo[1], q.y), lo[2] = fminf(lo[2], q.z);
      hi[0] = fmaxf(hi[0], q.x), hi[1] = fmaxf(hi[1], q.y), hi[2] = fmaxf(hi[2], q.z);
    }
  }
  for (int a = 0; a < 3; ++a) lo[a] = warp_min(lo[a]), hi[a] = warp_max(hi[a]);
  auto worst_best = [&]() {
    float v = -INFINITY;
#pragma unroll
    for (int i = 0; i < QPT; ++i) v = fmaxf(v, valid[i] ? q2[i] - 2.0f * best[i] : -INFINITY);
    return warp_max(v);
  };
  float wb = worst_best();

  const int nk = n_list > split ? (n_list - split + splits - 1) / splits : 0;
  const int ch = min(CHUNK, A.rt), n_ch = A.rt / ch;
  long long staged = 0, pairs = 0;
  int k = next_needed<kCand>(A, qtile, n_list, split, splits, nk, 0, lo, hi, wb);
  int t = k < nk ? tile_at<kCand>(A, qtile, n_list, split + k * splits) : -1, c = 0, buf = 0;
  if (k < nk) stage_chunk(A, stage[buf], t, c, ch), staged += ch;
  while (k < nk) {
    // Choose and start the next chunk: this tile's next one while the bound
    // still admits the tile, else the first chunk of the next admitted tile.
    int k2 = k, c2 = c + 1, t2 = t;
    if (c2 == n_ch || !(gap2(lo, hi, A.rbb + 8 * t) < wb)) {
      k2 = next_needed<kCand>(A, qtile, n_list, split, splits, nk, k + 1, lo, hi, wb);
      c2 = 0;
      t2 = k2 < nk ? tile_at<kCand>(A, qtile, n_list, split + k2 * splits) : -1;
    }
    const bool more = k2 < nk;
    if (more) {
      stage_chunk(A, stage[buf ^ 1], t2, c2, ch), staged += ch;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    // Score the chunk if the bound still admits its tile.
    if (gap2(lo, hi, A.rbb + 8 * t) < wb) {
      const float4* st = stage[buf];
      int grp[QPT];  // the group of a query's new best in this chunk (-1: none)
#pragma unroll
      for (int i = 0; i < QPT; ++i) grp[i] = -1;
      for (int g = 0; g < ch; g += GROUP) {
        float m0[QPT], m1[QPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) m0[i] = m1[i] = -INFINITY;
#pragma unroll
        for (int r = 0; r < GROUP; r += 2) {
          const float4 a = st[g + r], b = st[g + r + 1];
#pragma unroll
          for (int i = 0; i < QPT; ++i) {
            m0[i] = fmaxf(m0[i], score(qx[i], qy[i], qz[i], a));
            m1[i] = fmaxf(m1[i], score(qx[i], qy[i], qz[i], b));
          }
        }
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          const float gm = fmaxf(m0[i], m1[i]);
          if (gm > best[i]) best[i] = gm, grp[i] = g;
        }
      }
      bool any = false;
#pragma unroll
      for (int i = 0; i < QPT; ++i) any |= grp[i] >= 0;
      if (__any_sync(FULL, any)) {
        // The first row of the group reaching the new best (same FMAs, same
        // bits): the lowest row of the chunk's maximum.
        const int base = t * A.rt + c * ch;
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          if (grp[i] < 0) continue;
#pragma unroll 1
          for (int r = grp[i]; r < grp[i] + GROUP; ++r)
            if (score(qx[i], qy[i], qz[i], st[r]) == best[i]) {
              idx[i] = base + r, pos[i] = split + k * splits;
              break;
            }
        }
        wb = worst_best();
      }
      pairs += (long long)ch * 32 * QPT;
    }
    __syncwarp();  // the buffer is read before it is staged again
    k = k2, c = c2, t = t2, buf ^= 1;
  }

  if (A.visits && lane == 0) A.visits[2 * item] = staged, A.visits[2 * item + 1] = pairs;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < QPT; ++i) A.out_s[row0 + 32 * i] = best[i], A.out_i[row0 + 32 * i] = idx[i];
    return;
  }
  // Splits: fold this one into the group's packed maxima; the group's last
  // split to finish unpacks them.
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const unsigned rank = pos[i] < 0 ? 0u : (unsigned)(pos[i] + 1) * A.rt + idx[i] % A.rt;
    atomicMax(A.merged + row0 + 32 * i, pack(best[i], rank));
  }
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(A.work + group, 1) == splits - 1;
  if (!__shfl_sync(FULL, last, 0)) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int row = row0 + 32 * i;
    const unsigned long long m = __ldcg(A.merged + row);
    const unsigned u = (unsigned)(m >> 32), rank = 0xffffffffu - (unsigned)m;
    A.out_s[row] = __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
    if (rank == 0) {
      A.out_i[row] = A.i0 ? A.i0[row] : 0;
    } else {
      const int p = rank / A.rt - 1;
      A.out_i[row] = tile_at<kCand>(A, qtile, n_list, p) * A.rt + rank % A.rt;
    }
  }
}

// Persistent blocks of one warp take work items from a queue (an atomic
// counter): item j is share j % max_splits of the (j / max_splits)-th query
// group in order (query tiles by `order`, longest list first, a tile's
// groups side by side). A share past its group's count is skipped. So the
// heaviest work starts first, the rest fills in, and nothing is sized on
// the host.
template <bool kCand>
__device__ void walk(const WalkArgs& A) {
  __shared__ float4 stage[2][CHUNK];
  const int gpt = A.qt / (32 * QPT), items = A.n_groups * A.max_splits;
  for (;;) {
    int item = 0;
    if (threadIdx.x == 0) item = atomicAdd(A.work + A.n_groups, 1);
    item = __shfl_sync(FULL, item, 0);
    if (item >= items) return;
    const int g = item / A.max_splits, share = item % A.max_splits;
    const int qtile = A.order ? A.order[g / gpt] : g / gpt;
    const int splits = min(A.max_splits, max(1, (list_len<kCand>(A, qtile) + A.split_min - 1) /
                                                    A.split_min));
    if (share < splits)
      walk_item<kCand>(A, stage, item, qtile, qtile * gpt + g % gpt, share, splits);
  }
}

// Dense: every valid ref tile, newest first (a sequential map's best
// matches live in its latest appends, which then set a tight bound early).
__global__ void __launch_bounds__(32, 32) knn_dense_kernel(WalkArgs A) { walk<false>(A); }

// Candidate table: only the ref tiles listed for this query tile, in table
// order (best first); entries past cnt are not visited.
__global__ void __launch_bounds__(32, 32) knn_cand_kernel(WalkArgs A) { walk<true>(A); }

// ---------------------------------------------------------------------------
// the resident kernel
// ---------------------------------------------------------------------------

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
    lbs[s] = (s * st < nr) ? gap2(Q.lo, Q.hi, rbb + 8 * s) : INFINITY;
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
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  out_s[row] = Q.best;
  out_i[row] = Q.idx;
  if (visits && threadIdx.x == 0) visits[blockIdx.x] = visited;
}

// ---------------------------------------------------------------------------
// plain C entry points, loaded with ctypes
// ---------------------------------------------------------------------------
// Each launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = launched). knn_walk_config gives the walk
// kernels' compile-time shape (QPT, CHUNK, GROUP), from which the caller
// sizes its buffers. A walk launch starts persistent one-warp blocks, as
// many as fit on the SMs, over n_groups * max_splits work items, where
// n_groups = n_qt * qt / (32 * QPT). It needs qt a multiple of 32 * QPT
// and rt a multiple of min(CHUNK, rt) and of GROUP (else
// cudaErrorInvalidValue, nothing launched); `merged` [n_qt * qt] and
// `work` [n_groups + 1] are zero-filled (int64 and int32 scratch: the
// packed maxima of split groups, then per group its finished shares and,
// last, the queue head); `visits` is null or int64 [n_groups * max_splits, 2].

extern "C" int knn_walk_config(int* out) {
  out[0] = QPT, out[1] = CHUNK, out[2] = GROUP;
  return 0;
}

// Enough persistent one-warp blocks to fill every SM (at most `items`).
template <bool kCand>
static int walk_launch(const WalkArgs& A, int items, void* stream) {
  if (A.qt % (32 * QPT) || A.rt % GROUP || A.rt % min(CHUNK, A.rt))
    return (int)cudaErrorInvalidValue;
  static int per_sm = -1, n_sm = 0;
  if (per_sm < 0) {
    auto kernel = kCand ? knn_cand_kernel : knn_dense_kernel;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = max(1, min(items, per_sm * n_sm));
  if (kCand)
    knn_cand_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(A);
  else
    knn_dense_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

extern "C" int knn_dense_launch(const void* q4, const void* r4, const void* rbb,
                                const void* s0, const void* i0, int n_qt, int qt, int nq,
                                int nr, int nrt, int rt, int split_min, int max_splits,
                                void* out_s, void* out_i, void* merged, void* work,
                                void* visits, void* stream) {
  const WalkArgs A{(const float4*)q4, (const float4*)r4, (const float*)rbb,
                   (const float*)s0, (const int*)i0, nullptr, nullptr, nullptr, 0, qt, nq,
                   nr, nrt, rt, n_qt * (qt / (32 * QPT)), split_min, max_splits,
                   (float*)out_s, (int*)out_i, (unsigned long long*)merged, (int*)work,
                   (long long*)visits};
  return walk_launch<false>(A, A.n_groups * max_splits, stream);
}

extern "C" int knn_cand_launch(const void* q4, const void* r4, const void* rbb,
                               const void* s0, const void* i0, const void* cand,
                               const void* cnt, const void* order, int mc, int n_qt, int qt,
                               int nq, int nr, int nrt, int rt, int split_min, int max_splits,
                               void* out_s, void* out_i, void* merged, void* work,
                               void* visits, void* stream) {
  const WalkArgs A{(const float4*)q4, (const float4*)r4, (const float*)rbb,
                   (const float*)s0, (const int*)i0, (const int*)cand, (const int*)cnt,
                   (const int*)order, mc, qt, nq, nr, nrt, rt, n_qt * (qt / (32 * QPT)),
                   split_min, max_splits, (float*)out_s, (int*)out_i,
                   (unsigned long long*)merged, (int*)work, (long long*)visits};
  return walk_launch<true>(A, A.n_groups * max_splits, stream);
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
