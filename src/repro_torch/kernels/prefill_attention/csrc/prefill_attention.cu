// Causal prompt attention of blocking admission for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this attention in plain
// jnp (src/repro/models/layers.py::flash_attention_jnp), chunked over key
// blocks in f32, and so did the port until this kernel. It was added
// because that plain body, on the card, was most of a long prompt's
// admission: f32 einsums on the CUDA cores against every key block, masked
// blocks above the diagonal included, with a (B, H, T, 1024) f32 score
// tensor and its elementwise passes in device memory for each block. Plain
// twin: ../ref.py::prefill_attention_ref (that body, unchanged).
//
// What it computes: for q (B, Tq, Hq, 128), k, v (B, Tk, Hkv, 128), all
// bf16, G = Hq / Hkv query heads per kv head, query t at absolute position
// p = q_offset + t and key j valid where j <= p (and, with a sliding
// window W > 0, j > p - W: the W positions ending at p):
//   out[b, t, h] = sum_j softmax_j(<q, k_j> / sqrt(128)) v_j
// in f32, written in f32 or rounded once to bf16.
//
// What bounds it: 4 T^2 H d flops at causal (2 T^2 H d for q k^T and p v
// each, half the square): 7e13 for a 14k prompt over mistral's 32 layers
// and 32 heads, against a few hundred MB of q, k, v and out a layer. It is
// bound by operations; at the 989 TFLOP/s bf16 tensor-core peak the p v
// product split three ways (below) makes it 2 x 2 T^2 H d tensor-core flops.
//
// What the design does about it:
// * A block owns 128 rows of one kv head: the flattened (position, q head)
//   pairs t * G + g of its G query heads, so each K/V tile it loads serves
//   all G heads (GQA by indexing, no repeated K/V) and any G fits. Eight
//   warps take 16 rows each. A block walks only the 64-key tiles at or below
//   its last row's position: tiles wholly above the diagonal are never
//   loaded (half the work at causal); the tiles that cross it, and the
//   ragged last tile (zero-filled past Tk), are masked per element.
// * K/V tiles move with 16-byte cp.async into a two-stage ring in shared
//   memory (rows in a 16-byte-chunk XOR swizzle, so ldmatrix reads are free
//   of bank conflicts): tile j + 1 loads while tile j is computed. q is
//   loaded once into registers.
// * Both products run on the tensor cores with mma.sync m16n8k16, bf16
//   operands and f32 accumulation. q k^T: bf16 x bf16 products are exact in
//   f32, so only the accumulation rounds; the 1/sqrt(d) scale is applied to
//   the f32 scores. p v: p is f32 and must not be rounded to bf16, so it is
//   split into three bf16 parts, p = hi + mid + lo (each the bf16 rounding
//   of what the parts before it leave), which hold its 24 significand bits;
//   each part times bf16 v is again exact, and the three products add in
//   f32. A tile's p v starts from zero and is added to the running output
//   with one f32 fma, so the tensor cores' accumulation never runs longer
//   than a tile (12 products) whatever the prompt's length.
// * Scores and probabilities stay in registers; the online softmax keeps
//   its running max, sum and rescale in f32 (expf, no fast math), with the
//   plain body's guards: m_safe = 0 while a row has seen no valid key, and
//   corr = 0 from an empty row. Only out is written to device memory.
// * A sliding window (a separate instantiation, so calls without one run
//   the same instructions as before it existed) adds the lower bound: a
//   block starts at the tile holding its first row's oldest visible key,
//   p - W + 1, so tiles wholly below every row's window are never loaded;
//   the tiles that cross its last row's lower edge are masked per element.
//   A block then walks about (W + 128 / G) / 64 tiles, whatever T is.
// * Blocks run heaviest first (the last query rows walk the most tiles), so
//   the card's last wave is short. Each sum runs in a fixed order, with no
//   atomics: a shape gives the same bits on every call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;                    // head dim, the one instantiated
constexpr int BM = 128;                    // rows (position, q head) a block
constexpr int BN = 64;                     // keys a tile
constexpr int NWARP = BM / 16;             // 16 rows a warp
constexpr int NT = NWARP * 32;             // 256 threads
constexpr int ROW_BYTES = HD * 2;          // a bf16 row: 16 chunks of 16 B
constexpr int CHUNKS = ROW_BYTES / 16;
constexpr int Q_BYTES = BM * ROW_BYTES;    // 32 KB
constexpr int TILE_BYTES = BN * ROW_BYTES; // 16 KB for K or V
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = Q_BYTES + STAGES * 2 * TILE_BYTES;   // 96 KB
constexpr int KC = HD / 16;                // 16-deep steps of q k^T
constexpr int NTS = BN / 8;                // 8-key column tiles of a score tile
constexpr int PC = BN / 16;                // 16-key steps of p v
constexpr int NTO = HD / 8;                // 8-wide column tiles of out

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r: chunks XOR-swizzled by r mod 8
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; zero-filled where !valid (src then unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) -> three bf16 pairs hi, mid, lo with x = hi + mid + lo to 24 bits:
// each part is the bf16 rounding of the f32 remainder the parts before it
// leave (the remainders are exact in f32)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m),
                                                 r1 - __high2float(m));
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(l);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The block's 128 q rows (flattened t * G + g from f0) into shared memory,
// zero past Tq: 8 chunks a thread.
__device__ __forceinline__ void issue_q(uint32_t sq, const __nv_bfloat16* q,
                                        int b, int h, int f0, int Tq, int Hq,
                                        int G) {
  for (int i = threadIdx.x; i < BM * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int f = f0 + r, t = f / G;
    const bool ok = t < Tq;
    const size_t row = ok ? ((size_t)b * Tq + t) * Hq + (size_t)h * G + f % G
                          : 0;
    cp_async16(sq + swz(r, c), q + row * HD + c * 8, ok);
  }
}

// Keys [n0, n0 + BN) of kv head h: the K and the V tile, zero past Tk.
__device__ __forceinline__ void issue_kv(uint32_t sk, uint32_t sv,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, int b, int h,
                                         int n0, int Tk, int Hkv) {
  for (int i = threadIdx.x; i < BN * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int n = n0 + r;
    const bool ok = n < Tk;
    const size_t off =
        (ok ? (((size_t)b * Tk + n) * Hkv + h) * HD : 0) + (size_t)c * 8;
    cp_async16(sk + swz(r, c), k + off, ok);
    cp_async16(sv + swz(r, c), v + off, ok);
  }
}

template <typename OutT, bool WINDOWED>
__global__ void __launch_bounds__(NT, 1)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         OutT* __restrict__ out, int Tq, int Tk, int Hq,
                         int Hkv, int q_offset, int window, float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int G = Hq / Hkv;
  const int h = blockIdx.y, b = blockIdx.z;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * BM;     // heaviest first
  const int rows = Tq * G;
  const int f_last = (f0 + BM < rows ? f0 + BM : rows) - 1;
  // keys this block can see: up to its last row's position, and Tk
  const int kmax_pos = q_offset + f_last / G + 1;
  const int kmax = kmax_pos < Tk ? kmax_pos : Tk;
  const int n_tiles = kmax > 0 ? (kmax + BN - 1) / BN : 0;
  // tiles from here on need the per-element mask: they cross the first
  // row's diagonal or run past Tk
  const int first_pos = q_offset + f0 / G;
  // windowed: the first tile holds the first row's oldest visible key;
  // tiles below the last row's oldest visible key cross its window's edge
  const int lo_first = first_pos - window + 1;
  const int j0 = WINDOWED && lo_first > 0 ? lo_first / BN : 0;
  const int lo_last = q_offset + f_last / G - window + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qi = lane % 4;

  const uint32_t sq = smem_u32(smem);
  const uint32_t skv = sq + Q_BYTES;     // stage s: K at + 2s tiles, V after

  // this thread's two rows (quad and quad + 8 of its warp's 16)
  const int ra = warp * 16 + quad;
  const int fa = f0 + ra, fb = fa + 8;
  const int pos_a = q_offset + fa / G, pos_b = q_offset + fb / G;

  float o[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  uint32_t qa[KC][4];

  if (n_tiles > j0) {
    issue_q(sq, q, b, h, f0, Tq, Hq, G);
    issue_kv(skv, skv + TILE_BYTES, k, v, b, h, j0 * BN, Tk, Hkv);
  }
  cp_async_commit();

  for (int j = j0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();      // tile j landed; every warp is done with tile j-1
    if (j == j0) {
      // q fragments of the warp's 16 rows, once
      const int m = lane / 8;
      const int r = warp * 16 + (m & 1) * 8 + lane % 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(sq + swz(r, 2 * kc + (m >> 1)), qa[kc][0], qa[kc][1],
                qa[kc][2], qa[kc][3]);
    }
    if (j + 1 < n_tiles) {
      const uint32_t nk = skv + ((j + 1 - j0) % STAGES) * 2 * TILE_BYTES;
      issue_kv(nk, nk + TILE_BYTES, k, v, b, h, (j + 1) * BN, Tk, Hkv);
    }
    cp_async_commit();
    const uint32_t sk = skv + ((j - j0) % STAGES) * 2 * TILE_BYTES;
    const uint32_t sv = sk + TILE_BYTES;

    // ---- s = q k^T over the tile's 64 keys (f32 accumulators) ----------
    float s[NTS][4];
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const int kr = nt * 8 + lane % 8;
#pragma unroll
      for (int kc = 0; kc < KC; kc += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(sk + swz(kr, 2 * kc + lane / 8), b0, b1, b2, b3);
        mma_bf16(s[nt], qa[kc], b0, b1);
        mma_bf16(s[nt], qa[kc + 1], b2, b3);
      }
    }

    // ---- scale, mask, online softmax (f32) ------------------------------
    const int n0 = j * BN;
    const bool masked = n0 + BN - 1 > first_pos || n0 + BN > Tk ||
                        (WINDOWED && n0 < lo_last);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (masked) {
          const int n = n0 + nt * 8 + qi * 2 + (e & 1);
          const int pos = e < 2 ? pos_a : pos_b;
          if (n > pos || n >= Tk || (WINDOWED && n <= pos - window))
            x = -INFINITY;
        }
        s[nt][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, d));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, d));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float ms_a = isfinite(mn_a) ? mn_a : 0.f;
    const float ms_b = isfinite(mn_b) ? mn_b : 0.f;
    const float corr_a = isfinite(m_a) ? expf(m_a - ms_a) : 0.f;
    const float corr_b = isfinite(m_b) ? expf(m_b - ms_b) : 0.f;
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
    // p as the A operand of p v, split three ways: [16-key step][part][4]
    uint32_t pa[PC][3][4];
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
      const float p0 = expf(s[nt][0] - ms_a), p1 = expf(s[nt][1] - ms_a);
      const float p2 = expf(s[nt][2] - ms_b), p3 = expf(s[nt][3] - ms_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      const int kc = nt / 2, half = (nt % 2) * 2;   // a0/a1, else a2/a3
      split3(p0, p1, pa[kc][0][half], pa[kc][1][half], pa[kc][2][half]);
      split3(p2, p3, pa[kc][0][half + 1], pa[kc][1][half + 1],
             pa[kc][2][half + 1]);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;

    // ---- o = o * corr + p v: a tile's products from zero, then one fma ----
#pragma unroll
    for (int np = 0; np < NTO / 2; ++np) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < PC; ++kc) {
        uint32_t b0, b1, b2, b3;
        const int m = lane / 8;
        ldsm_x4_trans(sv + swz(kc * 16 + (m & 1) * 8 + lane % 8,
                               2 * np + (m >> 1)),
                      b0, b1, b2, b3);
#pragma unroll
        for (int part = 2; part >= 0; --part) {      // lo, mid, hi
          mma_bf16(acc[0], pa[kc][part], b0, b1);
          mma_bf16(acc[1], pa[kc][part], b2, b3);
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int n = 2 * np + x;
        o[n][0] = fmaf(o[n][0], corr_a, acc[x][0]);
        o[n][1] = fmaf(o[n][1], corr_a, acc[x][1]);
        o[n][2] = fmaf(o[n][2], corr_b, acc[x][2]);
        o[n][3] = fmaf(o[n][3], corr_b, acc[x][3]);
      }
    }
  }
  cp_async_wait_all();

  // ---- out = o / max(l, 1e-30), the quad's partial sums added ------------
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, d);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, d);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  const int t_a = fa / G, t_b = fb / G;
  const size_t h0 = (size_t)blockIdx.y * G;
  if (t_a < Tq) {
    OutT* dst = out + (((size_t)b * Tq + t_a) * Hq + h0 + fa % G) * HD;
#pragma unroll
    for (int n = 0; n < NTO; ++n)
      store2(dst + n * 8 + qi * 2, o[n][0] / den_a, o[n][1] / den_a);
  }
  if (t_b < Tq) {
    OutT* dst = out + (((size_t)b * Tq + t_b) * Hq + h0 + fb % G) * HD;
#pragma unroll
    for (int n = 0; n < NTO; ++n)
      store2(dst + n * 8 + qi * 2, o[n][2] / den_b, o[n][3] / den_b);
  }
}

template <typename OutT, bool WINDOWED>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tq, int Tk, int Hq, int Hkv, int q_offset, int window,
           cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_attention_kernel<OutT, WINDOWED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long tiles = ((long long)Tq * (Hq / Hkv) + BM - 1) / BM;
  const dim3 grid((unsigned)tiles, Hkv, B);
  prefill_attention_kernel<OutT, WINDOWED><<<grid, NT, SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<OutT*>(out), Tq, Tk,
      Hq, Hkv, q_offset, window, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename OutT>
int launch_any(const void* q, const void* k, const void* v, void* out, int B,
               int Tq, int Tk, int Hq, int Hkv, int q_offset, int window,
               cudaStream_t st) {
  return window > 0
             ? launch<OutT, true>(q, k, v, out, B, Tq, Tk, Hq, Hkv, q_offset,
                                  window, st)
             : launch<OutT, false>(q, k, v, out, B, Tq, Tk, Hq, Hkv, q_offset,
                                   0, st);
}

}  // namespace

// q (B, Tq, Hq, hd), k and v (B, Tk, Hkv, hd), bf16, contiguous; out
// (B, Tq, Hq, hd) in f32 (out_f32) or bf16; window > 0: a sliding window
// of that many positions, 0: none. Returns a cudaError_t.
extern "C" int prefill_attention(const void* q, const void* k, const void* v,
                                 void* out, int B, int Tq, int Tk, int Hq,
                                 int Hkv, int hd, int q_offset, int window,
                                 int out_f32, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  if (hd != HD || Tk < 0 || Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0 ||
      window < 0 ||
      B > 65535 || Hkv > 65535 ||
      (long long)Tq * (Hq / Hkv) + BM > 0x7fffffffLL ||
      (long long)q_offset + Tq > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_any<float>(q, k, v, out, B, Tq, Tk, Hq, Hkv,
                                    q_offset, window, st)
                 : launch_any<__nv_bfloat16>(q, k, v, out, B, Tq, Tk, Hq, Hkv,
                                             q_offset, window, st);
}
