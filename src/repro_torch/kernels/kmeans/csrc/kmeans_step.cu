// One segmented spherical k-means step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/kmeans/kernel.py::kmeans_step_pallas
// (body _kernel). Plain twin: ../ref.py::kmeans_step_ref.
//
// What it computes, for each of S segments of n points x (n, d) and k
// centroids c (k, d): the centroids normalised to unit length
// (c * rsqrt(max(|c|^2, 1e-16))), each point's assignment
// argmax_j <x, c_j / |c_j|> (the lowest index on ties, as jnp.argmax), and
// the cluster sums (k, d) and counts (k,) of those assignments.
//
// What bounds it: f32 operations. The similarity takes 2*n*k*d flops per
// segment (2.1 GFLOP at the port's prefill segment n 8192, k 512, d 256)
// against n*d*4 bytes of points; the sums take n*d adds. Far above the
// ridge for f32 without tensor cores.
//
// What the design does about it: the TPU kernel holds a whole segment and
// its (n, k) similarity in VMEM and forms the sums as a one-hot matmul. Here
// the (n, k) similarity (16 MB per segment at the real shape) is never
// materialised. A pre-pass writes the normalised centroids into a scratch
// buffer the wrapper allocates. Then each 256-thread block takes 64 points
// of one segment, streams 64-centroid x 32-dim tiles of points and
// centroids through shared memory, keeps a 4 x 4 register tile of dot
// products per thread, and folds each finished 64 x 64 tile into a running
// argmax per point (strict >, so earlier and lower indices win ties). Dot
// products are plain f32 FMAs (no TF32), so assignments match an f32
// reference up to the order of the sums. Finally each point is added into
// its cluster's sum and count with atomicAdd into outputs the wrapper
// zeroed: the n*d adds replace the one-hot matmul's 2*n*k*d flops, and the
// sums' rounding depends on the order the atomics land in.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block (16 x 16)
constexpr int TR = 64;           // points per block
constexpr int TC = 64;           // centroids per tile
constexpr int TD = 32;           // dims per shared-memory chunk

__global__ void __launch_bounds__(NT) normalize_kernel(
    const float* __restrict__ cent, float* __restrict__ cn, int rows, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * (NT / 32) + warp;
  if (c >= rows) return;
  const float* src = cent + (size_t)c * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) ss = fmaf(src[i], src[i], ss);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = 1.0f / sqrtf(fmaxf(ss, 1e-16f));
  for (int i = lane; i < d; i += 32) cn[(size_t)c * d + i] = src[i] * inv;
}

__global__ void __launch_bounds__(NT) assign_kernel(
    const float* __restrict__ x, const float* __restrict__ cn,
    float* __restrict__ sums, float* __restrict__ counts,
    int* __restrict__ assign, int n, int k, int d) {
  __shared__ float xs[TR][TD + 1];
  __shared__ float cs[TC][TD + 1];
  const int s = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* xseg = x + (size_t)s * n * d;
  const float* cseg = cn + (size_t)s * k * d;

  float best[4];
  int best_id[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { best[i] = -INFINITY; best_id[i] = 0; }

  for (int c0 = 0; c0 < k; c0 += TC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d0 = 0; d0 < d; d0 += TD) {
      for (int e = tid; e < TR * TD; e += NT) {
        const int rr = e / TD, cc = e % TD;
        const int pr = r0 + rr, pc = c0 + rr, dd = d0 + cc;
        xs[rr][cc] = (pr < n && dd < d) ? xseg[(size_t)pr * d + dd] : 0.f;
        cs[rr][cc] = (pc < k && dd < d) ? cseg[(size_t)pc * d + dd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TD; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = cs[tx + 16 * j][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    // fold this tile into the running argmax of each of the thread's rows:
    // the best of its own 4 columns, then over the 16 threads of the row
    // (value first, then the lower index), then against the earlier tiles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = -INFINITY;
      int id = k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < k && acc[i][j] > v) { v = acc[i][j]; id = col; }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oid = __shfl_xor_sync(0xffffffffu, id, o);
        if (ov > v || (ov == v && oid < id)) { v = ov; id = oid; }
      }
      if (v > best[i]) { best[i] = v; best_id[i] = id; }
    }
  }

  // write the assignments, then add each point into its cluster's sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pr = r0 + ty + 16 * i;
    if (pr >= n) continue;
    const int a = best_id[i];
    if (tx == 0) {
      assign[(size_t)s * n + pr] = a;
      atomicAdd(counts + (size_t)s * k + a, 1.0f);
    }
    const float* xr = xseg + (size_t)pr * d;
    float* sr = sums + ((size_t)s * k + a) * d;
    for (int c = tx; c < d; c += 16) atomicAdd(sr + c, xr[c]);
  }
}

}  // namespace

// C entry point (loaded with ctypes). cn is a (S, k, d) f32 scratch buffer;
// sums and counts must be zeroed by the caller.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int kmeans_step(const void* x, const void* cent, void* cn,
                           void* sums, void* counts, void* assign, int S,
                           int n, int k, int d, void* stream) {
  if (S <= 0 || n <= 0) return 0;
  if (k <= 0 || d <= 0 || S > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = S * k;
  normalize_kernel<<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      static_cast<const float*>(cent), static_cast<float*>(cn), rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  assign_kernel<<<dim3((n + TR - 1) / TR, S), NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(cn),
      static_cast<float*>(sums), static_cast<float*>(counts),
      static_cast<int*>(assign), n, k, d);
  return cudaGetLastError();
}
