// Scatter PointFusion's map-sized pass for Hopper (sm_90a): each valid map
// row associated with a live frame, and each pixel's winner fused with the
// pixel, in place in the packed map buffer.
//
// Replaces no Pallas kernel: the JAX package runs this pass as XLA scatters
// over the whole buffer (e2eslam_tpu/slam/fusion.py: pointfusion_step,
// _associate). The port's plain version is slam/fusion.py::_merge_plain.
//
// What it computes, for the map rows [lo, hi) (the valid rows, or those of
// the active window) and a live frame of H x W pixels:
//   pointfusion_associate_kernel, one thread per row: project the row's
//     point into the live camera (inverse pose, pinhole, round half to
//     even); a row is similar to the pixel it lands on when it lies in the
//     frame in front of the camera, the pixel's live mask is set, its
//     distance to the pixel's live vertex is below dist_th and its normal
//     within the angle gate of the live normal. A similar row does one
//     64-bit atomicMin of key[pix] = (float bits of dist << 32) | row. For
//     non-negative floats the bit order is the value order, so the minimum
//     is the closest row, then the lowest row of equal distances: the plain
//     version's two scatter-mins, exactly, in whatever order the atomics run.
//   pointfusion_merge_kernel, one thread per pixel: where key[p] names a
//     row (and `active`, if given, is true), that row takes the confidence-
//     weighted mean of itself and the pixel, its normal renormalised under
//     the n2 > 1e-24 guard, its confidence the sum; claimed[p] says whether
//     a row won the pixel. Rows no pixel wins keep their bytes.
//
// The arithmetic follows the plain version's in its order: every product,
// sum and quotient is an explicitly rounded intrinsic (__fmul_rn and kin,
// which the compiler never contracts into an FMA), so a winner's fused
// bytes are those of PyTorch's separate elementwise kernels. The camera
// transform is the one FMA chain per coordinate of the plain version's
// [N, 3] x [3, 3] matrix product (cuBLAS's order: equal bits on the H100).
//
// What bounds it: bytes. A valid row is read once (its first 32-byte
// sector: point and normal); the live frame's vertex, normal and mask
// (HW-sized) stay in L2; a winner's row is read and written once. At 3M
// valid rows that is ~0.1 GB, ~30 us at 3.35 TB/s, against the plain
// version's dozens of passes over the whole buffer and its scatters onto
// one pixel of the rows past the count. Rows past the count cost nothing:
// the association walks [lo, hi) read on the device, with a grid-stride
// loop over enough blocks to fill the card.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 16;  // floats per packed map row (slam/pointclouds.py: ROW)
constexpr unsigned long long kEmpty = ~0ull;

struct FusionArgs {
  float* data;               // [N, 16] map rows, fused in place
  const long long* count;    // device count, or null: `hi` is the count
  const long long* start;    // device window start, or null: `lo` is the start
  long long lo, hi, window;  // rows [start, min(count, start + window))
  const float* params;       // [16]: inverse pose rows 0-2 (12 floats), fx, fy, cx, cy
  const float* live_pts;     // [HW, 3] world-frame live vertices
  const float* live_nrm;     // [HW, 3]
  const float* live_clr;     // [HW, 3]
  const float* live_mask;    // [HW] float validity
  const float* alpha;        // [HW] per-pixel confidence (already masked)
  const bool* active;        // 0-d, or null: active
  unsigned long long* key;   // [HW] scratch, all ones on entry
  bool* claimed;             // [HW] out
  int H, W;
  float dist_th, cos_th;
  int use_angle;
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// (p @ R^T)_i + t_i for row i of the inverse pose: the matrix product's FMA
// chain over k, then the translation's separate add.
__device__ __forceinline__ float cam(const float* P, int i, float x, float y, float z) {
  return fadd(fmaf(z, P[4 * i + 2], fmaf(y, P[4 * i + 1], fmul(x, P[4 * i]))), P[4 * i + 3]);
}

// A 3-wide sum of already rounded terms as PyTorch's CUDA reductions take
// the plain version's norms and dot products over a row: two threads share
// the row, (a + c) and b, then combine. (Checked on the H100 against
// torch.linalg.norm and .sum(dim=-1) of 4M rows: equal bits.)
__device__ __forceinline__ float sum3(float a, float b, float c) { return fadd(fadd(a, c), b); }

__global__ void __launch_bounds__(kThreads) pointfusion_associate_kernel(FusionArgs A) {
  if (A.active && !*A.active) return;
  const long long lo = A.start ? *A.start : A.lo;
  long long hi = A.count ? *A.count : A.hi;
  hi = min(hi, lo + A.window);
  __shared__ float P[16];
  if (threadIdx.x < 16) P[threadIdx.x] = A.params[threadIdx.x];
  __syncthreads();
  const float fx = P[12], fy = P[13], cx = P[14], cy = P[15];
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long row = lo + (long long)blockIdx.x * kThreads + threadIdx.x; row < hi;
       row += stride) {
    const float4* src = reinterpret_cast<const float4*>(A.data + row * kRow);
    const float4 a = __ldg(src), b = __ldg(src + 1);  // x y z nx | ny nz r g
    const float px = cam(P, 0, a.x, a.y, a.z);
    const float py = cam(P, 1, a.x, a.y, a.z);
    const float pz = cam(P, 2, a.x, a.y, a.z);
    if (!(pz > 0.0f)) continue;
    const float sz = fabsf(pz) > 1e-8f ? pz : 1e-8f;
    const float u = rintf(fadd(fdiv(fmul(fx, px), sz), cx));
    const float v = rintf(fadd(fdiv(fmul(fy, py), sz), cy));
    if (!(u >= 0.0f && u < (float)A.W && v >= 0.0f && v < (float)A.H)) continue;
    const int pix = (int)v * A.W + (int)u;
    if (!(A.live_mask[pix] > 0.0f)) continue;
    const float* lv = A.live_pts + 3 * pix;
    const float dx = fsub(a.x, lv[0]), dy = fsub(a.y, lv[1]), dz = fsub(a.z, lv[2]);
    const float dist = sqrtf(sum3(fmul(dx, dx), fmul(dy, dy), fmul(dz, dz)));
    if (!(dist < A.dist_th)) continue;
    if (A.use_angle) {
      const float* ln = A.live_nrm + 3 * pix;
      if (!(sum3(fmul(a.w, ln[0]), fmul(b.x, ln[1]), fmul(b.y, ln[2])) > A.cos_th)) continue;
    }
    atomicMin(A.key + pix,
              ((unsigned long long)__float_as_uint(dist) << 32) | (unsigned long long)row);
  }
}

// old + ((c old + a new) / wsum - old): the plain version's blend of a
// winner (its `old + wf * (fused - old)` with wf = 1).
__device__ __forceinline__ float blend(float old, float nw, float c, float a, float wsum) {
  return fadd(old, fsub(fdiv(fadd(fmul(c, old), fmul(a, nw)), wsum), old));
}

__global__ void __launch_bounds__(kThreads) pointfusion_merge_kernel(FusionArgs A, int hw) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const unsigned long long k = A.key[p];
  const bool win = k != kEmpty && !(A.active && !*A.active);
  A.claimed[p] = win;
  if (!win) return;
  float* r = A.data + (long long)(k & 0xffffffffull) * kRow;
  const float c = r[9], a = A.alpha[p];
  const float s = fadd(c, a);
  const float wsum = s < 1e-12f ? 1e-12f : s;  // clamp(min=1e-12); NaN stays NaN
  const float* lv = A.live_pts + 3 * p;
  const float* ln = A.live_nrm + 3 * p;
  const float* lc = A.live_clr + 3 * p;
  float n[3];
  for (int i = 0; i < 3; ++i) {
    r[i] = blend(r[i], lv[i], c, a, wsum);
    r[6 + i] = blend(r[6 + i], lc[i], c, a, wsum);
    n[i] = blend(r[3 + i], ln[i], c, a, wsum);
  }
  const float n2 = sum3(fmul(n[0], n[0]), fmul(n[1], n[1]), fmul(n[2], n[2]));
  const float norm = n2 > 1e-24f ? sqrtf(n2) : 1.0f;
  for (int i = 0; i < 3; ++i) r[3 + i] = n2 > 1e-24f ? fdiv(n[i], norm) : n[i];
  r[9] = s;
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C entry point, loaded with ctypes
// ---------------------------------------------------------------------------
// Launches, on the given stream, a fill of `key` (int64 [H * W] scratch) with
// all ones, the association over the rows [start, min(count, start +
// window)) of `data` (float32 [N, 16], 16-byte aligned) and the merge over
// the H * W pixels; allocates nothing and returns cudaGetLastError() (0 =
// launched). `count` and `start` are null (the host's `hi` and `lo` hold
// them) or int64 0-d device buffers read by the kernels, so a launch
// captured in a CUDA graph follows a count that changes between replays;
// `span` is the host's upper bound on the rows the association visits.
// `params` is float32 [16]: rows 0-2 of the frame's inverse pose, then fx,
// fy, cx, cy. `active` is null or a 0-d bool: where false nothing is
// written but `claimed`, all false. The buffer's rows must number below
// 2^32 (the caller checks: a key holds the row in 32 bits).
extern "C" int pointfusion_launch(void* data, const void* count, const void* start,
                                  long long lo, long long hi, long long window,
                                  long long span, const void* params, const void* live_pts,
                                  const void* live_nrm, const void* live_clr,
                                  const void* live_mask, const void* alpha,
                                  const void* active, void* key, void* claimed, int H, int W,
                                  float dist_th, float cos_th, int use_angle, void* stream) {
  const int hw = H * W;
  if (hw <= 0 || span < 0 || window < 0 || lo < 0 || ((uintptr_t)data & 15))
    return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (!n_sm) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const FusionArgs A{(float*)data, (const long long*)count, (const long long*)start, lo, hi,
                     window, (const float*)params, (const float*)live_pts,
                     (const float*)live_nrm, (const float*)live_clr, (const float*)live_mask,
                     (const float*)alpha, (const bool*)active, (unsigned long long*)key,
                     (bool*)claimed, H, W, dist_th, cos_th, use_angle};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(key, 0xff, (size_t)hw * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  // Eight blocks an SM fill it (2,048 threads); a call of fewer rows takes fewer.
  const long long want = (span + kThreads - 1) / kThreads;
  const int grid = (int)max(1LL, min(want, 8LL * n_sm));
  pointfusion_associate_kernel<<<grid, kThreads, 0, s>>>(A);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pointfusion_merge_kernel<<<(hw + kThreads - 1) / kThreads, kThreads, 0, s>>>(A, hw);
  return (int)cudaGetLastError();
}
