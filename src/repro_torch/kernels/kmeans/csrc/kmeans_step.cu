// One segmented spherical k-means step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/kmeans/kernel.py::kmeans_step_pallas
// (body _kernel). Plain twin: ../ref.py::kmeans_step_ref; the update's
// order: ../ref.py::ordered_update_ref.
//
// What it computes, for each of S segments of n points x (n, d) and k
// centroids c (k, d): the centroids normalised to unit length
// (c * rsqrt(max(|c|^2, 1e-16))), each point's assignment
// argmax_j <x, c_j / |c_j|> (the lowest index on ties, as jnp.argmax), and
// the cluster sums (k, d) and counts (k,) of those assignments.
//
// What bounds it: the similarity, 2*n*k*d flops per segment (2.1 GFLOP at
// the port's prefill segment n 8192, k 512, d 256) against n*d*4 bytes of
// points. In f32 on the CUDA cores that is 0.26 ms for 8 segments; the
// kernel runs it on the tensor cores in 3xTF32, 3 x 2*n*k*d TF32 flops,
// 0.10 ms at the 495 TFLOP/s TF32 peak. The sums are n*d adds: a pass
// over x.
//
// What the design does about it, in four launches:
// 1. normalize_kernel writes the unit centroids, split into TF32 hi and lo
//    halves, into a scratch buffer the wrapper allocates: for each 256 x 32
//    tile (zero past k and d) the hi then the lo tile, laid out as the
//    similarity's shared memory holds them (128-byte rows in the 128-byte
//    swizzle that wgmma reads through a descriptor).
// 2. assign_kernel: one block per 128 points of a segment walks every
//    256-centroid tile in 32-dim stages through a two-stage ring of
//    mbarriers. A producer warpgroup (its registers handed to the
//    consumers with setmaxnreg) moves each stage's 64 KB of centroid tiles
//    with one bulk asynchronous copy and the points' rows with cp.async
//    (zero past n and d). Two consumer warpgroups, 64 points
//    each, load their A fragments from shared memory and split them in
//    registers, x = x_hi + x_lo (cvt.rna.tf32), then per 8-dim step issue
//    three wgmma.m64n256k8 TF32 products into one f32 accumulator,
//    x_lo*c_hi + x_hi*c_lo + x_hi*c_hi: ~12 u |x| of error per dot product
//    (u = 2^-24), far inside the check's 4 d u |x|. A warpgroup waits on
//    its own three products only, so the other keeps the tensor cores
//    busy; A stays in registers (ptxas holds this 384-thread kernel to 168
//    registers, so one 8-dim step's fragments at a time): from shared
//    memory, wgmma's reads of A next to those of B would fill the
//    shared-memory port. Each finished tile folds into a running (value,
//    lowest index) per point in registers (strict >, columns in increasing
//    order), so the (n, k) similarity never reaches memory.
// 3. order_kernel sorts the point ids into cluster order, ascending within
//    each cluster, with no float atomics, one block per part of at least
//    1024 points of a segment: integer histograms in shared memory (the
//    segment's totals, the points before the part, each warp's share of
//    it), their prefix over clusters, parts and warps (the cluster offsets
//    and the exact counts), then each warp places its points 32 at a time,
//    ranked through shared memory. Clusters go in ranges of 1024 so any k
//    fits the shared counters.
// 4. sums_kernel: one block per (cluster, segment) adds its members' rows
//    in ascending point order into registers and writes the sum once. The
//    sums are therefore the same bits on every run and equal, bit for bit,
//    to ordered_update_ref over the same assignments.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- assign: tile shape and the mbarrier ring ------------------------------
constexpr int BM = 128;              // points per block: 2 warpgroups x 64
constexpr int BN = 256;              // centroids per tile, the wgmma's N
constexpr int BK = 32;               // dims per stage: one 128-byte row
constexpr int STAGES = 2;
constexpr int NT_ASSIGN = 384;       // a producer and 2 consumer warpgroups
constexpr int TILE_FLOATS = BN * BK;
constexpr int A_LDS = BK + 4;        // padded point row, floats
constexpr int B_BYTES = BN * BK * 4;                 // one hi or lo tile
constexpr int A_BYTES = (BM * A_LDS * 4 + 1023) / 1024 * 1024;
constexpr int STAGE_BYTES = 2 * B_BYTES + A_BYTES;   // 1024-byte aligned
constexpr int ASSIGN_SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment

// ---- order / sums -----------------------------------------------------------
constexpr int NT_ORDER = 1024;       // 32 warps
constexpr int KC = 1024;             // clusters per pass of order_kernel
constexpr int OB = 8;                // assignments a lane loads at once
constexpr int NT_SUMS = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of the given parity to complete; a wait of seconds can
// only be a broken protocol: trap (a launch error) rather than hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t b = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// bulk asynchronous copy global -> shared, completing on an mbarrier
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// round to TF32 (nearest, ties away), kept in an f32 container
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32, the remainder below 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// shared-memory matrix descriptor of a K-major tile whose rows are 128
// bytes, stored with the 128-byte swizzle (16-byte chunk q of row r at
// chunk q ^ (r % 8)), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
__device__ __forceinline__ void pin(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// (v, id) beats (bv, bid): larger value, or the same value at a lower index
__device__ __forceinline__ bool beats(float v, int id, float bv, int bid) {
  return v > bv || (v == bv && id < bid);
}

// cn holds, for each segment, 256-centroid tile and 32-dim chunk, a 64 KB
// block: the (256, 32) hi tile of the unit centroids' TF32 halves, then the
// lo tile, each laid out as assign_kernel's shared memory holds it (128-byte
// rows, 16-byte chunk q of row r at chunk q ^ (r % 8)), so one bulk copy
// moves both. Zero past k and d.
__global__ void __launch_bounds__(256) normalize_kernel(
    const float* __restrict__ cent, float* __restrict__ cn, int S, int k,
    int d, int kp, int dp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + warp;
  if (row >= (long long)S * kp) return;
  const int s = (int)(row / kp), c = (int)(row % kp);
  const int tile = c / BN, r = c % BN, KT = dp / BK;
  float* blk0 = cn + ((size_t)s * (kp / BN) + tile) * KT * (2 * TILE_FLOATS);
  const float* src = cent + ((size_t)s * k + c) * d;
  float inv = 0.f;
  if (c < k) {
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) ss = fmaf(src[i], src[i], ss);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    inv = 1.0f / sqrtf(fmaxf(ss, 1e-16f));
  }
  for (int i = lane; i < dp; i += 32) {
    uint32_t h = 0, l = 0;
    if (c < k && i < d) split_tf32(src[i] * inv, h, l);
    const int q = (i % BK) >> 2;
    float* blk = blk0 + (size_t)(i / BK) * (2 * TILE_FLOATS) + r * BK +
                 ((q ^ (r & 7)) << 2) + (i & 3);
    blk[0] = __uint_as_float(h);
    blk[TILE_FLOATS] = __uint_as_float(l);
  }
}

// VEC: x is 16-byte aligned and d % 4 == 0 (16-byte copies), else 4-byte
template <bool VEC>
__global__ void __launch_bounds__(NT_ASSIGN, 1) assign_kernel(
    const float* __restrict__ x, const float* __restrict__ cn,
    int* __restrict__ assign, int n, int k, int d, int kp, int dp) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const int s = blockIdx.y, m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* xs = x + (size_t)s * n * d;
  const int KT = dp / BK, T = (kp / BN) * KT;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1 + 128);
      mbar_init(&empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // producer warpgroup: its registers go to the consumers. Stage `step`
    // holds centroid tile step / KT, dims (step % KT) * BK ... + BK: the hi
    // and lo tiles in one bulk copy by thread 0, the block's points' rows
    // beside them in cp.async copies by all 128 threads (zero past n and d)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const float* cseg = cn + (size_t)s * T * (2 * TILE_FLOATS);
    for (int step = 0; step < T; ++step) {
      const int slot = step % STAGES;
      mbar_wait(&empty[slot], ((step / STAGES) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(&full[slot], 2 * B_BYTES);
        bulk_g2s(base + slot * STAGE_BYTES,
                 cseg + (size_t)step * (2 * TILE_FLOATS), 2 * B_BYTES,
                 &full[slot]);
      }
      float* As = reinterpret_cast<float*>(sbase + slot * STAGE_BYTES +
                                           2 * B_BYTES);
      const int d0 = (step % KT) * BK;
      if (VEC) {
        for (int e = tid; e < BM * (BK / 4); e += 128) {
          const int row = e >> 3, q = (e & 7) * 4;
          const bool ok = m0 + row < n && d0 + q < d;
          cp_async16(smem_u32(As + row * A_LDS + q),
                     ok ? xs + (size_t)(m0 + row) * d + d0 + q : xs, ok);
        }
      } else {
        for (int e = tid; e < BM * BK; e += 128) {
          const int row = e >> 5, q = e & 31;
          const bool ok = m0 + row < n && d0 + q < d;
          cp_async4(smem_u32(As + row * A_LDS + q),
                    ok ? xs + (size_t)(m0 + row) * d + d0 + q : xs, ok);
        }
      }
      asm volatile(
          "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
              smem_u32(&full[slot]))
          : "memory");
    }
    return;
  }

  // consumers: warpgroup wg computes rows wg*64 ... + 64 against each tile;
  // this thread holds rows r0 = wg*64 + w*16 + g and r0 + 8, columns
  // 8j + 2t + {0, 1} (acc[4j + {0, 1}] for r0, acc[4j + {2, 3}] for r0 + 8)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = (warp >> 2) - 1, w = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float bv[2] = {-INFINITY, -INFINITY};
  int bi[2] = {0x7fffffff, 0x7fffffff};
  for (int step = 0; step < T; ++step) {
    const int slot = step % STAGES;
    mbar_wait(&full[slot], (step / STAGES) & 1);
    const float* ap = reinterpret_cast<const float*>(
        sbase + slot * STAGE_BYTES + 2 * B_BYTES) +
        (wg * 64 + w * 16 + g) * A_LDS + t;
    const uint32_t bh = base + slot * STAGE_BYTES, bl = bh + B_BYTES;
    const int fresh = step % KT == 0;            // first chunk of a tile
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      // one 8-dim step at a time: its A fragments live in registers only
      // until its three products are done (a warpgroup waits on its own
      // products; the other warpgroup's keep the tensor cores busy)
      uint32_t ah[4], al[4];
      const float* p = ap + kk * 8;
      split_tf32(p[0], ah[0], al[0]);
      split_tf32(p[8 * A_LDS], ah[1], al[1]);
      split_tf32(p[4], ah[2], al[2]);
      split_tf32(p[8 * A_LDS + 4], ah[3], al[3]);
      const uint64_t dh = sw128_desc(bh + kk * 32);
      const uint64_t dl = sw128_desc(bl + kk * 32);
      pin(acc);
      wgmma_fence();
      wgmma_tf32(acc, al, dh, !(fresh && kk == 0));
      wgmma_tf32(acc, ah, dl, 1);
      wgmma_tf32(acc, ah, dh, 1);
      wgmma_commit();
      wgmma_wait0();
      pin(acc);
    }
    if ((tid & 127) == 0) mbar_arrive(&empty[slot]);
    if (step % KT == KT - 1) {
      // fold the finished tile: columns in increasing order per row
      const int c0 = (step / KT) * BN + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + j * 8 + e;
            const float v = acc[4 * j + 2 * h + e];
            if (col < k && v > bv[h]) {
              bv[h] = v;
              bi[h] = col;
            }
          }
    }
  }

  // across the 4 lanes of a row's quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = bv[h];
    int id = bi[h];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oid = __shfl_xor_sync(0xffffffffu, id, o);
      if (beats(ov, oid, v, id)) { v = ov; id = oid; }
    }
    const int row = m0 + wg * 64 + w * 16 + h * 8 + g;
    if (t == 0 && row < n) assign[(size_t)s * n + row] = id < k ? id : 0;
  }
}

// the point ids in cluster order (ascending within each cluster), the
// cluster offsets and the exact counts. Block (part, s) places the points
// [part * plen, part * plen + plen) of segment s; it counts the whole
// segment itself (the clusters' totals, and how many of each come before
// its part), so the parts need no second pass. Part 0 writes the offsets
// and counts.
__global__ void __launch_bounds__(NT_ORDER) order_kernel(
    const int* __restrict__ assign, int* __restrict__ order,
    int* __restrict__ offs, float* __restrict__ counts, int n, int k,
    int plen) {
  extern __shared__ int sm[];               // cnt [32][kc], total, before
  __shared__ int wsum[32];
  __shared__ int lanes[32][32];             // a warp's batch of ids
  const int part = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int* a = assign + (size_t)s * n;
  int* ord = order + (size_t)s * n;
  int* off = offs + (size_t)s * (k + 1);
  const int plo = min(n, part * plen), phi = min(n, plo + plen);
  const int per = (plen + 31) / 32;         // warp w: [lo, hi) of the part
  const int lo = min(phi, plo + w * per), hi = min(phi, lo + per);
  int running = 0;                          // ids of earlier cluster ranges
  for (int c0 = 0; c0 < k; c0 += KC) {
    const int kc = min(KC, k - c0);
    int* cnt = sm;
    int* total = sm + 32 * kc;
    int* before = total + kc;
    for (int e = tid; e < 34 * kc; e += NT_ORDER) sm[e] = 0;
    __syncthreads();
    for (int p0 = 0; p0 < n; p0 += NT_ORDER * OB) {
      int c[OB];
#pragma unroll
      for (int u = 0; u < OB; ++u) {        // OB loads in flight at once
        const int p = p0 + u * NT_ORDER + tid;
        c[u] = p < n ? a[p] - c0 : -1;
      }
#pragma unroll
      for (int u = 0; u < OB; ++u) {
        const int p = p0 + u * NT_ORDER + tid;
        if (c[u] < 0 || c[u] >= kc) continue;
        atomicAdd(&total[c[u]], 1);
        if (p < plo) atomicAdd(&before[c[u]], 1);
        else if (p < phi) atomicAdd(&cnt[((p - plo) / per) * kc + c[u]], 1);
      }
    }
    __syncthreads();
    // cnt[v][c] <- first position of warp v's points of cluster c0 + c:
    // the cluster's offset (an exclusive scan of the totals), the points
    // of earlier parts, then those of earlier warps of this part
    for (int cb = 0; cb < kc; cb += NT_ORDER) {
      const int c = cb + tid;
      const int tot = c < kc ? total[c] : 0;
      int incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) wsum[w] = incl;
      __syncthreads();
      if (w == 0) {
        int ws = wsum[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, ws, o);
          if (lane >= o) ws += y;
        }
        wsum[lane] = ws;
      }
      __syncthreads();
      const int excl = running + (w ? wsum[w - 1] : 0) + incl - tot;
      if (c < kc) {
        int at = excl + before[c];
        for (int v = 0; v < 32; ++v) {
          const int m = cnt[v * kc + c];
          cnt[v * kc + c] = at;
          at += m;
        }
        if (part == 0) {
          off[c0 + c] = excl;
          counts[(size_t)s * k + c0 + c] = (float)tot;
        }
      }
      running += wsum[31];
      __syncthreads();
    }
    // each warp places its points, 32 at a time, in point order
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const int p = p0 + lane;
      const int c = p < hi ? a[p] - c0 : -1;
      const bool in = c >= 0 && c < kc;
      // rank among the batch's earlier points of the same cluster, and the
      // batch's count of it, from the warp's ids in shared memory
      lanes[w][lane] = in ? c : -1 - lane;
      __syncwarp();
      int rank = 0, same = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const bool eq = lanes[w][j] == c;
        same += eq;
        rank += eq && j < lane;
      }
      const int pos = in ? cnt[w * kc + c] + rank : 0;
      __syncwarp();
      if (in) {
        ord[pos] = p;
        if (rank == 0) cnt[w * kc + c] = pos + same;
      }
      __syncwarp();
    }
    __syncthreads();
  }
  if (part == 0 && tid == 0) off[k] = running;
}

// one block per (cluster, segment): the members' rows added in point order
template <bool VEC>
__global__ void __launch_bounds__(NT_SUMS) sums_kernel(
    const float* __restrict__ x, const int* __restrict__ order,
    const int* __restrict__ offs, float* __restrict__ sums, int n, int k,
    int d) {
  const int c = blockIdx.x, s = blockIdx.y;
  const int start = offs[(size_t)s * (k + 1) + c];
  const int end = offs[(size_t)s * (k + 1) + c + 1];
  const int* ord = order + (size_t)s * n;
  const float* xs = x + (size_t)s * n * d;
  float* out = sums + ((size_t)s * k + c) * d;
  if (VEC) {
    const int d4 = d / 4;
    for (int e = threadIdx.x; e < d4; e += NT_SUMS) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      int j = start;
      for (; j + 4 <= end; j += 4) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = __ldg(reinterpret_cast<const float4*>(
                           xs + (size_t)ord[j + u] * d) + e);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc.x += v[u].x; acc.y += v[u].y; acc.z += v[u].z; acc.w += v[u].w;
        }
      }
      for (; j < end; ++j) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
                                   xs + (size_t)ord[j] * d) + e);
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      reinterpret_cast<float4*>(out)[e] = acc;
    }
  } else {
    for (int e = threadIdx.x; e < d; e += NT_SUMS) {
      float acc = 0.f;
      int j = start;
      for (; j + 4 <= end; j += 4) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = __ldg(xs + (size_t)ord[j + u] * d + e);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc += v[u];
      }
      for (; j < end; ++j) acc += __ldg(xs + (size_t)ord[j] * d + e);
      out[e] = acc;
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes). Scratch the caller allocates: cn
// of 2 * S * kp * dp f32 with kp >= k a multiple of 256 and dp >= d a
// multiple of 32; order (S, max(n, 1)) int32; offs (S, k + 1) int32. Every
// output is written in full (sums, counts, assign need no zeroing).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int kmeans_step(const void* x, const void* cent, void* cn,
                           void* order, void* offs, void* sums, void* counts,
                           void* assign, int S, int n, int k, int d, int kp,
                           int dp, void* stream) {
  if (S <= 0) return 0;
  if (n < 0 || k <= 0 || d <= 0 || S > 65535 || kp < k || kp % BN != 0 ||
      dp < d || dp % BK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err;
  if (n > 0) {
    const long long rows = (long long)S * kp;
    normalize_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
        static_cast<const float*>(cent), static_cast<float*>(cn), S, k, d, kp,
        dp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 grid((n + BM - 1) / BM, S);
    if (vec) {
      cudaFuncSetAttribute(assign_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ASSIGN_SMEM);
      assign_kernel<true><<<grid, NT_ASSIGN, ASSIGN_SMEM, st>>>(
          xf, static_cast<const float*>(cn), static_cast<int*>(assign), n, k,
          d, kp, dp);
    } else {
      cudaFuncSetAttribute(assign_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ASSIGN_SMEM);
      assign_kernel<false><<<grid, NT_ASSIGN, ASSIGN_SMEM, st>>>(
          xf, static_cast<const float*>(cn), static_cast<int*>(assign), n, k,
          d, kp, dp);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // parts of at least 1024 points, at most 64 of them a segment
  const int plen = n > 64 * NT_ORDER ? (n + 63) / 64 : NT_ORDER;
  const int parts = n > 0 ? (n + plen - 1) / plen : 1;
  const int order_smem = 34 * (k < KC ? k : KC) * (int)sizeof(int);
  cudaFuncSetAttribute(order_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       order_smem);
  order_kernel<<<dim3(parts, S), NT_ORDER, order_smem, st>>>(
      static_cast<const int*>(assign), static_cast<int*>(order),
      static_cast<int*>(offs), static_cast<float*>(counts), n, k, plen);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 sgrid(k, S);
  if (vec)
    sums_kernel<true><<<sgrid, NT_SUMS, 0, st>>>(
        xf, static_cast<const int*>(order), static_cast<const int*>(offs),
        static_cast<float*>(sums), n, k, d);
  else
    sums_kernel<false><<<sgrid, NT_SUMS, 0, st>>>(
        xf, static_cast<const int*>(order), static_cast<const int*>(offs),
        static_cast<float*>(sums), n, k, d);
  return cudaGetLastError();
}
