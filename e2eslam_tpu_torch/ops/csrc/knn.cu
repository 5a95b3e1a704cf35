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
//                          best sub-tile first, then the others in order
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
// ---- One core, three lists -----------------------------------------------
// All three kernels walk a list of ref tiles per query tile with one
// scoring core: the table's row for the candidate kernel, the valid tiles
// newest first for the dense one, and for the resident kernel the valid
// sub-tiles with the one of least box gap to the query tile first (the
// lowest index on ties; the box spans all 256 rows of the query tile,
// padding included, as in Pallas), then the others ascending. The resident
// list is derived in the kernel, one warp reduction per work item, so the
// host builds no table for it. What bounds the core is instruction issue on
// the fp32 CUDA cores: per scored (query, ref) pair three FMAs and a max.
// Refs are read once per visited chunk per work item, from L2 (the resident
// kernel's at most 2 MB of refs stay there across the call), so bytes are
// far below the time. The design:
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
//     whole tile. The resident kernel is given one box per chunk (a
//     sub-tile's box is their union, exactly): a chunk of the map's newest
//     appends is a few image rows, far tighter than a sub-tile's strip
//     across the frame.
//   * Asynchronous staging: chunks of CHUNK rows go to the warp's shared
//     memory with cp.async into two buffers, so the next admitted chunk
//     (this tile's, or the first of the next admitted tile) loads while this
//     one is scored.
//   * Balance across the card: a query group's list is split into shares
//     of at least split_min entries, at most max_splits (ops/knn.py sets
//     both per kernel), list positions interleaved (share s walks positions
//     s, s + splits, ...), so each share starts at its best tiles. A share
//     of the resident list walks position 0 first, then positions 1 + s,
//     1 + s + splits, ...: a cold call's bound is infinite until a real row
//     is scored, and the best sub-tile makes it tight in every share. The
//     shares are counted in the kernel, so nothing is sized on the host:
//     persistent one-warp blocks, as many as fit on the SMs, take work items
//     from one atomic counter, query tiles in the order the wrapper gives
//     (longest list first), a group's shares side by side. A long list
//     therefore neither sets the kernel's time alone nor starts last.
//   * Exact merge: every share folds its (score, rank) into one 64-bit
//     atomic maximum per query -- the score, then the lower rank, where the
//     seed is rank 0 and row r of list position p is (p + 1) * rt + r --
//     and the group's last share to finish unpacks it. Within a share the
//     winner is the lowest (position, row) of its maximum, so the merge
//     reproduces the sequential walk exactly (a position that several
//     shares walk gives each the same pair, and the maximum is idempotent):
//     cand_plain and resident_plain stay the oracles.
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
// ---- The resident kernel on this core -------------------------------------
// It replaced a block-per-query-tile kernel that reached about 21% of its
// bound (2.12 ms at the main path's 81,920 x 65,536 tail-seed call, H100
// 80GB HBM3, 700 W). Its four causes, and what the core does about each:
//   * one query a thread, the index tracked on every pair (three FMAs, a
//     compare, two selects and one shared-memory read a pair): two queries
//     a thread, maxima per group, a one-group rescan;
//   * pruning uniform over a 256-query block, so one far query kept eight
//     warps sweeping: per-warp boxes and bounds over 64 queries, tested
//     before each 256-row chunk against that chunk's own box (a few image
//     rows of the map's newest appends, not a strip across the frame);
//   * synchronous 2048-row staging between block barriers: cp.async into
//     two buffers, no block barrier;
//   * a ragged grid of 320 blocks on 132 SMs: persistent one-warp blocks on
//     the work queue, each query group's list split in up to RES_MAX_SPLITS
//     shares (ops/knn.py), every share walking the best sub-tile first so a
//     cold call's bound is tight in each.
// Pruning makes the work per query group uneven (the heaviest work item
// scores about twice the mean), and every extra share scores the best
// sub-tile again: work the kernel does beyond what the search needs, which
// the visit record counts apart (PERF.md has the measured pairs, times and
// bound).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_BIAS (-1e30f)

#define QPT 2            // queries per thread
#define CHUNK 256        // ref rows per staged chunk (4 KB)
#define GROUP 16         // rows per running maximum before it meets the best
#define FULL 0xffffffffu

enum ListKind { kDense, kCand, kResident };

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
  const float* rbb;  // ref boxes [nrt, 8]; resident: one per chunk [nrt * rt / ch, 8]
  const float* s0;
  const int* i0;
  const int* cand;   // [n_qt, mc] (candidate kernel) or null
  const int* cnt;    // [n_qt] (candidate kernel) or null
  const int* order;  // query tiles, longest list first (null: in order)
  int mc, qt, nq, nr, nrt, rt, n_groups, split_min, max_splits;
  float* out_s;
  int* out_i;
  unsigned long long* merged;  // [nq_pad] zeros: packed (score, rank) maxima
  int* work;  // [n_groups + 1] zeros: per group the shares done, then the queue
  long long* visits;  // [n_groups * max_splits, 3]: per item rows staged, pairs
                      // scored, and of those the pairs another share also scores
  const int* counts;  // null, or int32 [2] on the device: the valid nq and nr,
                      // which then replace the host's (the `_dc` kernels)
};

// A query tile's list: its length and, for the resident list, its first
// sub-tile.
struct List {
  int qtile, n, first;
};

template <int K>
__device__ __forceinline__ int list_len(const WalkArgs& A, int qtile) {
  return K == kCand ? min(A.cnt[qtile], A.mc) : min((A.nr + A.rt - 1) / A.rt, A.nrt);
}

// The ref tile at list position p (-1: none).
template <int K>
__device__ __forceinline__ int tile_at(const WalkArgs& A, const List& L, int p) {
  int t;
  if (K == kCand)
    t = A.cand[(size_t)L.qtile * A.mc + p];
  else if (K == kDense)
    t = L.n - 1 - p;
  else  // the first sub-tile, then the others ascending
    t = p == 0 ? L.first : p - 1 + (p - 1 >= L.first);
  return (t >= 0 && t < A.nrt && t * A.rt < A.nr) ? t : -1;
}

// The list position of a share's k-th entry, and the share's entry count.
template <int K>
__device__ __forceinline__ int position(int k, int split, int splits) {
  if (K == kResident) return k == 0 ? 0 : 1 + split + (k - 1) * splits;
  return split + k * splits;
}
template <int K>
__device__ __forceinline__ int n_entries(int n, int split, int splits) {
  if (K == kResident)
    return n == 0 ? 0 : 1 + (n - 1 > split ? (n - 1 - split + splits - 1) / splits : 0);
  return n > split ? (n - split + splits - 1) / splits : 0;
}

// Whether the bound admits ref tile t, and its chunk c (of n_ch): the
// resident kernel has one box per chunk, the others one per tile.
template <int K>
__device__ __forceinline__ bool chunk_admitted(const WalkArgs& A, int t, int c, int n_ch,
                                               const float* lo, const float* hi, float wb) {
  return gap2(lo, hi, A.rbb + 8 * (K == kResident ? t * n_ch + c : t)) < wb;
}
template <int K>
__device__ __forceinline__ bool tile_admitted(const WalkArgs& A, int t, int n_ch,
                                              const float* lo, const float* hi, float wb) {
  for (int c = 0; c < (K == kResident ? n_ch : 1); ++c)
    if (chunk_admitted<K>(A, t, c, n_ch, lo, hi, wb)) return true;
  return false;
}

// The first chunk c >= c0 of ref tile t the bound admits (n_ch: none).
template <int K>
__device__ int next_chunk(const WalkArgs& A, int t, int c0, int n_ch, const float* lo,
                          const float* hi, float wb) {
  if (K != kResident)
    return c0 < n_ch && chunk_admitted<K>(A, t, c0, n_ch, lo, hi, wb) ? c0 : n_ch;
  for (int c = c0; c < n_ch; ++c)
    if (chunk_admitted<K>(A, t, c, n_ch, lo, hi, wb)) return c;
  return n_ch;
}

// The first entry k >= k0 of the share whose tile the warp's bound admits
// (nk: none), tested 32 entries at a time.
template <int K>
__device__ int next_needed(const WalkArgs& A, const List& L, int split, int splits, int nk,
                           int k0, int n_ch, const float* lo, const float* hi, float wb) {
  for (int base = k0; base < nk; base += 32) {
    const int k = base + threadIdx.x;
    bool need = false;
    if (k < nk) {
      const int t = tile_at<K>(A, L, position<K>(k, split, splits));
      need = t >= 0 && tile_admitted<K>(A, t, n_ch, lo, hi, wb);
    }
    const unsigned bal = __ballot_sync(FULL, need);
    if (bal) return base + __ffs(bal) - 1;
  }
  return nk;
}

// The resident list's first sub-tile: the least squared gap between the
// query tile's box (all qt rows, padding included) and a valid sub-tile's
// box (the union of its chunks' boxes), the lowest index on ties. Products
// and sums are rounded apart (no FMA), as Pallas and the plain version
// round them.
__device__ int first_subtile(const WalkArgs& A, int qtile, int n) {
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int r = threadIdx.x; r < A.qt; r += 32) {
    const float4 q = A.q4[(size_t)qtile * A.qt + r];
    lo[0] = fminf(lo[0], q.x), lo[1] = fminf(lo[1], q.y), lo[2] = fminf(lo[2], q.z);
    hi[0] = fmaxf(hi[0], q.x), hi[1] = fmaxf(hi[1], q.y), hi[2] = fmaxf(hi[2], q.z);
  }
  for (int a = 0; a < 3; ++a) lo[a] = warp_min(lo[a]), hi[a] = warp_max(hi[a]);
  float best = INFINITY;
  int arg = 0;
  for (int s = threadIdx.x; s < n; s += 32) {
    const int nb = A.rt / min(CHUNK, A.rt);
    const float* bb = A.rbb + 8 * s * nb;
    float blo[3] = {bb[0], bb[1], bb[2]}, bhi[3] = {bb[3], bb[4], bb[5]};
    for (int b = 1; b < nb; ++b)
      for (int a = 0; a < 3; ++a)
        blo[a] = fminf(blo[a], bb[8 * b + a]), bhi[a] = fmaxf(bhi[a], bb[8 * b + 3 + a]);
    float lb = 0.0f;
    for (int a = 0; a < 3; ++a) {
      const float gap = fmaxf(fmaxf(lo[a] - bhi[a], blo[a] - hi[a]), 0.0f);
      lb = __fadd_rn(lb, __fmul_rn(gap, gap));
    }
    if (lb < best) best = lb, arg = s;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oa = __shfl_xor_sync(FULL, arg, o);
    if (ob < best || (ob == best && oa < arg)) best = ob, arg = oa;
  }
  return arg;
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
// tile, one warp) walks its share `split` of `splits` of the tile's list.
template <int K>
__device__ void walk_item(const WalkArgs& A, float4 (*stage)[CHUNK], int item, const List& L,
                          int group, int split, int splits) {
  const int lane = threadIdx.x;
  const int row0 = group * 32 * QPT + lane;

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

  const int nk = n_entries<K>(L.n, split, splits);
  const int ch = min(CHUNK, A.rt), n_ch = A.rt / ch;
  auto tile_of = [&](int k) { return tile_at<K>(A, L, position<K>(k, split, splits)); };
  // From chunk c of entry k's tile t on, the first chunk the bound admits:
  // this tile's, else the first of the next admitted tile (k = nk: none).
  auto next_visit = [&](int& k, int& t, int& c) {
    c = k < nk ? next_chunk<K>(A, t, c, n_ch, lo, hi, wb) : 0;
    while (k < nk && c == n_ch) {
      k = next_needed<K>(A, L, split, splits, nk, k + 1, n_ch, lo, hi, wb);
      t = k < nk ? tile_of(k) : -1;
      c = k < nk ? next_chunk<K>(A, t, 0, n_ch, lo, hi, wb) : 0;
    }
  };
  // Chunks staged, scored, and scored again (32-bit counts: the kernel is
  // at its register cap).
  int staged = 0, scored = 0, repeated = 0;
  int k = next_needed<K>(A, L, split, splits, nk, 0, n_ch, lo, hi, wb);
  int t = k < nk ? tile_of(k) : -1, c = 0, buf = 0;
  next_visit(k, t, c);
  if (k < nk) stage_chunk(A, stage[buf], t, c, ch), ++staged;
  while (k < nk) {
    // Choose and start the next chunk.
    int k2 = k, t2 = t, c2 = c + 1;
    next_visit(k2, t2, c2);
    const bool more = k2 < nk;
    if (more) {
      stage_chunk(A, stage[buf ^ 1], t2, c2, ch), ++staged;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    // Score the chunk if the bound still admits it.
    if (chunk_admitted<K>(A, t, c, n_ch, lo, hi, wb)) {
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
              idx[i] = base + r, pos[i] = position<K>(k, split, splits);
              break;
            }
        }
        wb = worst_best();
      }
      ++scored;
      // Every share of a resident list walks position 0, so the shares past
      // the first score its pairs again.
      repeated += K == kResident && k == 0 && split > 0;
    }
    __syncwarp();  // the buffer is read before it is staged again
    k = k2, c = c2, t = t2, buf ^= 1;
  }

  if (A.visits && lane == 0) {
    const long long per_chunk = (long long)ch * 32 * QPT;
    A.visits[3 * item] = (long long)staged * ch, A.visits[3 * item + 1] = scored * per_chunk;
    A.visits[3 * item + 2] = repeated * per_chunk;
  }
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
      A.out_i[row] = tile_at<K>(A, L, p) * A.rt + rank % A.rt;
    }
  }
}

// Persistent blocks of one warp take work items from a queue (an atomic
// counter): item j is share j % max_splits of the (j / max_splits)-th query
// group in order (query tiles by `order`, longest list first, a tile's
// groups side by side). A share past its group's count is skipped. So the
// heaviest work starts first, the rest fills in, and nothing is sized on
// the host.
template <int K>
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
    List L{qtile, list_len<K>(A, qtile), 0};
    const int splits = min(A.max_splits, max(1, (L.n + A.split_min - 1) / A.split_min));
    if (share >= splits) continue;
    const int group = qtile * gpt + g % gpt;
    if (group * 32 * QPT >= A.nq) {
      // No valid query (a map view longer than the map, when the map
      // queries the frame): share 0 writes the seeds, nothing is walked.
      if (share == 0)
        for (int i = 0; i < QPT; ++i) {
          const int row = group * 32 * QPT + 32 * i + threadIdx.x;
          A.out_s[row] = A.s0 ? A.s0[row] : NEG_BIAS, A.out_i[row] = A.i0 ? A.i0[row] : 0;
        }
      continue;
    }
    if (K == kResident) L.first = first_subtile(A, qtile, L.n);
    walk_item<K>(A, stage, item, L, group, share, splits);
  }
}

// Counts on the device (a map whose size the host does not know, as in a
// replayed CUDA graph): the Pallas kernels' scalar-prefetch nq and nr, read
// once per block. Each kernel has a second entry, `_dc`, that reads them;
// the host-count entry compiles as before (the two live counts cost the
// device-count one registers at the 64-register cap).
template <int K>
__device__ void walk_device_counts(const WalkArgs& args) {
  WalkArgs A = args;
  A.nq = __ldg(args.counts), A.nr = __ldg(args.counts + 1);
  walk<K>(A);
}

// Dense: every valid ref tile, newest first (a sequential map's best
// matches live in its latest appends, which then set a tight bound early).
__global__ void __launch_bounds__(32, 32) knn_dense_kernel(WalkArgs A) { walk<kDense>(A); }
__global__ void __launch_bounds__(32, 32) knn_dense_kernel_dc(WalkArgs A) {
  walk_device_counts<kDense>(A);
}

// Candidate table: only the ref tiles listed for this query tile, in table
// order (best first); entries past cnt are not visited.
__global__ void __launch_bounds__(32, 32) knn_cand_kernel(WalkArgs A) { walk<kCand>(A); }
__global__ void __launch_bounds__(32, 32) knn_cand_kernel_dc(WalkArgs A) {
  walk_device_counts<kCand>(A);
}

// Resident: the valid sub-tiles, the query tile's best one first, then the
// others ascending.
__global__ void __launch_bounds__(32, 32) knn_resident_kernel(WalkArgs A) {
  walk<kResident>(A);
}
__global__ void __launch_bounds__(32, 32) knn_resident_kernel_dc(WalkArgs A) {
  walk_device_counts<kResident>(A);
}

// ---------------------------------------------------------------------------
// plain C entry points, loaded with ctypes
// ---------------------------------------------------------------------------
// Each launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = launched). knn_walk_config gives the kernels'
// compile-time shape (QPT, CHUNK, GROUP), from which the caller sizes its
// buffers. A launch starts persistent one-warp blocks, as many as fit on
// the SMs, over n_groups * max_splits work items, where
// n_groups = n_qt * qt / (32 * QPT). It needs qt a multiple of 32 * QPT,
// rt a multiple of min(CHUNK, rt) and of GROUP, and (nrt + 1) * rt below
// 2^32 (else cudaErrorInvalidValue, nothing launched); `merged` [n_qt * qt]
// and `work` [n_groups + 1] are zero-filled (int64 and int32 scratch: the
// packed maxima of split groups, then per group its finished shares and,
// last, the queue head); `visits` is null or int64 [n_groups * max_splits,
// 3], per work item the ref rows it staged, the pairs it scored, and of
// those the pairs another share of its list scores too (the resident
// list's position 0 in every share past the first; 0 in the other kernels).
// The pairs a call needs are the second column's sum less the third's.
// `counts` is null (the valid counts are the host's nq and nr) or an int32
// [2] device buffer holding them: the kernel's `_dc` entry reads them there,
// so a launch captured in a CUDA graph follows a count that changes between
// replays.
// Then nq and nr are upper bounds only; work items whose queries all lie
// past the device nq write their seeds and walk nothing.

extern "C" int knn_walk_config(int* out) {
  out[0] = QPT, out[1] = CHUNK, out[2] = GROUP;
  return 0;
}

// Enough persistent one-warp blocks to fill every SM (at most `items`).
template <int K, bool DC>
static int walk_launch_as(const WalkArgs& A, void* stream) {
  const int ch = min(CHUNK, A.rt);
  if (A.qt % (32 * QPT) || A.rt % GROUP || A.rt % ch ||
      (long long)(A.nrt + 1) * A.rt >= 0xffffffffLL)
    return (int)cudaErrorInvalidValue;
  auto kernel = K == kDense  ? (DC ? knn_dense_kernel_dc : knn_dense_kernel)
                : K == kCand ? (DC ? knn_cand_kernel_dc : knn_cand_kernel)
                             : (DC ? knn_resident_kernel_dc : knn_resident_kernel);
  static int per_sm = -1, n_sm = 0;
  if (per_sm < 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = max(1, min(A.n_groups * A.max_splits, per_sm * n_sm));
  kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

template <int K>
static int walk_launch(const WalkArgs& A, void* stream) {
  return A.counts ? walk_launch_as<K, true>(A, stream) : walk_launch_as<K, false>(A, stream);
}

extern "C" int knn_dense_launch(const void* q4, const void* r4, const void* rbb,
                                const void* s0, const void* i0, int n_qt, int qt, int nq,
                                int nr, int nrt, int rt, int split_min, int max_splits,
                                void* out_s, void* out_i, void* merged, void* work,
                                void* visits, const void* counts, void* stream) {
  const WalkArgs A{(const float4*)q4, (const float4*)r4, (const float*)rbb,
                   (const float*)s0, (const int*)i0, nullptr, nullptr, nullptr, 0, qt, nq,
                   nr, nrt, rt, n_qt * (qt / (32 * QPT)), split_min, max_splits,
                   (float*)out_s, (int*)out_i, (unsigned long long*)merged, (int*)work,
                   (long long*)visits, (const int*)counts};
  return walk_launch<kDense>(A, stream);
}

extern "C" int knn_cand_launch(const void* q4, const void* r4, const void* rbb,
                               const void* s0, const void* i0, const void* cand,
                               const void* cnt, const void* order, int mc, int n_qt, int qt,
                               int nq, int nr, int nrt, int rt, int split_min, int max_splits,
                               void* out_s, void* out_i, void* merged, void* work,
                               void* visits, const void* counts, void* stream) {
  const WalkArgs A{(const float4*)q4, (const float4*)r4, (const float*)rbb,
                   (const float*)s0, (const int*)i0, (const int*)cand, (const int*)cnt,
                   (const int*)order, mc, qt, nq, nr, nrt, rt, n_qt * (qt / (32 * QPT)),
                   split_min, max_splits, (float*)out_s, (int*)out_i,
                   (unsigned long long*)merged, (int*)work, (long long*)visits,
                   (const int*)counts};
  return walk_launch<kCand>(A, stream);
}

// `rbb` holds one box per chunk of min(CHUNK, rt) rows of the sub-tiles.
extern "C" int knn_resident_launch(const void* q4, const void* r4, const void* rbb,
                                   const void* s0, const void* i0, int n_qt, int qt, int nq,
                                   int nr, int nrt, int rt, int split_min, int max_splits,
                                   void* out_s, void* out_i, void* merged, void* work,
                                   void* visits, const void* counts, void* stream) {
  const WalkArgs A{(const float4*)q4, (const float4*)r4, (const float*)rbb,
                   (const float*)s0, (const int*)i0, nullptr, nullptr, nullptr, 0, qt, nq,
                   nr, nrt, rt, n_qt * (qt / (32 * QPT)), split_min, max_splits,
                   (float*)out_s, (int*)out_i, (unsigned long long*)merged, (int*)work,
                   (long long*)visits, (const int*)counts};
  return walk_launch<kResident>(A, stream);
}
