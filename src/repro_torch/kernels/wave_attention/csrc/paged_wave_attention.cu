// Gather-free paged wave attention (one decode step) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wave_attention/kernel.py::paged_wave_attention_pallas
// (bodies _paged_db_kernel / _paged_kernel, shared math _make_fold and
// _est_finalize). Plain twin: ../ref.py::paged_wave_attention_torch.
//
// What it computes, per flattened (batch, kv-head) row and its G query
// heads: one online softmax over the sink zone, then the local buffer, then
// the r retrieved clusters read IN PLACE from the (M, cap, hd) block store at
// idx[j] (skipped where live[j] == 0), then the estimation zone folded in at
// finalize. Output (BH, G, hd) f32.
//
// What bounds it: HBM bytes. Each row reads (sink + local + r*cap) tokens of
// K and V plus the (E, hd) f32 estimation value sums and does ~4*G flops per
// element read, far below the card's ~295 flop/byte ridge.
//
// What the design does about it: K/V are read once, in their storage dtype,
// with 16-byte vector loads by consecutive threads (one 512-byte row per
// token at hd=256 bf16), and converted to f32 in registers; tokens whose
// position is masked (empty local slots, out-of-window cluster members) and
// dead clusters are never loaded, and a tile with no valid token is
// skipped. Scores, running (m, l) and the (G, hd) accumulator stay on
// chip. This first version runs one 128-thread block per row, so at small
// batch only B*Hkv SMs work and each waits on its loads: splitting the walk
// across blocks (flash-decoding), TMA/cp.async pipelining and wgmma are
// left for later work.
//
// Semantics kept exactly from the TPU kernel: ok = pos>=0 & pos<=hi &
// pos>lo & extra_ok; masked scores are NEG=-1e30 (not -inf); m starts at
// -inf, m_safe = max(m_new, -1e20), corr = isfinite(m_prev) ?
// exp(m_prev - m_safe) : 0; p re-masked to 0; finalize with live_e =
// est_logit > NEG/2 and out = num / max(den, 1e-30). q stays f32 and every
// product accumulates in f32. Built without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int TILE = 32;         // tokens per tile
constexpr int HD_MAX = 256;
constexpr int PER_THREAD = 8;    // f32 accumulators per query head per thread
constexpr float NEG = -1e30f;

template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;    // 8 bf16 = 16 bytes
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;    // 4 f32 = 16 bytes
  __device__ static void load(const float* p, float* out) {
    float4 raw = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
  }
};

struct Params {
  const int* idx; const int* live; const int* rowb;
  const float* q;
  const void* sink_k; const void* sink_v; int Ss; int sink_len;
  const void* local_k; const void* local_v; const int* local_pos; int Lb;
  const void* k_store; const void* v_store; const int* pos_store;
  int M; int cap; int r;
  const float* est_logit; const float* cs; const float* vs; int E;
  float* out;
  int hd; float scale; float softcap; int use_softcap;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int G>
__global__ void __launch_bounds__(NT) paged_wave_attention_kernel(Params p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int MAX_NCH = PER_THREAD / VEC;   // 16-byte chunks per token row
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = p.hd;
  const int nchunk = hd / VEC;                 // chunks in one token row
  const int tpr = nchunk < 32 ? nchunk : 32;   // threads per token row
  const int nch = nchunk / tpr;                // chunks per thread (<= MAX_NCH)
  const int ngrp = NT / tpr;                   // token rows in flight
  const int grp = tid / tpr, gl = tid % tpr;

  __shared__ float s_sh[G][TILE];
  __shared__ float p_sh[G][TILE];
  __shared__ int ok_sh[TILE];
  __shared__ float m_sh[G], l_sh[G], corr_sh[G];
  __shared__ float fin_sh[G][HD_MAX];
  __shared__ float den_sh[G], mfin_sh[G], cfin_sh[G];

  const int lo = p.rowb[2 * row], hi = p.rowb[2 * row + 1];

  // this thread's slice of q (f32) and of the (G, hd) accumulator
  float qr[G][PER_THREAD];
  float acc[G][PER_THREAD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < MAX_NCH; ++c) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int col = (gl + c * tpr) * VEC + v;
        qr[g][c * VEC + v] =
            c < nch ? p.q[((size_t)row * G + g) * hd + col] : 0.f;
        acc[g][c * VEC + v] = 0.f;
      }
    }
  }
  if (tid < G) { m_sh[tid] = -INFINITY; l_sh[tid] = 0.f; }
  __syncthreads();

  // One walk over the zones: segment 0 is the sink (slot t holds token t,
  // valid for t < sink_len), segment 1 the local buffer, segment 2 + j the
  // retrieved cluster idx[j]. Each is folded in tiles of TILE tokens.
  const size_t blk = (size_t)p.cap * hd;
  for (int sg = 0; sg < 2 + p.r; ++sg) {
    const T* kb;
    const T* vb;
    const int* pos;
    int n;
    if (sg == 0) {
      kb = static_cast<const T*>(p.sink_k) + (size_t)row * p.Ss * hd;
      vb = static_cast<const T*>(p.sink_v) + (size_t)row * p.Ss * hd;
      pos = nullptr;
      n = p.Ss;
    } else if (sg == 1) {
      kb = static_cast<const T*>(p.local_k) + (size_t)row * p.Lb * hd;
      vb = static_cast<const T*>(p.local_v) + (size_t)row * p.Lb * hd;
      pos = p.local_pos + (size_t)row * p.Lb;
      n = p.Lb;
    } else {
      const int j = sg - 2;
      const int c = p.idx[row * p.r + j];
      // a dead slot folds nothing; an id outside the store is never read
      if (p.live[row * p.r + j] <= 0 || c < 0 || c >= p.M) continue;
      const size_t base = (size_t)row * p.M + c;
      kb = static_cast<const T*>(p.k_store) + base * blk;
      vb = static_cast<const T*>(p.v_store) + base * blk;
      pos = p.pos_store + base * p.cap;
      n = p.cap;
    }
    for (int t0 = 0; t0 < n; t0 += TILE) {
      const int tn = min(TILE, n - t0);
      if (tid < TILE) {
        int ok = 0;
        if (tid < tn) {
          const int t = t0 + tid;
          const int ps = pos ? pos[t] : t;
          const bool extra = pos ? true : (t < p.sink_len);
          ok = (ps >= 0) && (ps <= hi) && (ps > lo) && extra;
        }
        ok_sh[tid] = ok;
      }
      // a tile with no valid token (empty local slots, a cluster outside
      // the window) folds nothing: skip it (block-uniform)
      if (!__syncthreads_or(tid < TILE && ok_sh[tid])) continue;

      // scores: one token row per thread group, reduced over the group
      for (int t = grp; t < TILE; t += ngrp) {
        const bool load = t < tn && ok_sh[t];
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = 0.f;
        if (load) {
          const T* kr = kb + (size_t)(t0 + t) * hd;
#pragma unroll
          for (int c = 0; c < MAX_NCH; ++c) {
            if (c < nch) {
              float kf[VEC];
              Vec<T>::load(kr + (gl + c * tpr) * VEC, kf);
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int v = 0; v < VEC; ++v) part[g] += qr[g][c * VEC + v] * kf[v];
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          for (int o = tpr >> 1; o > 0; o >>= 1)
            part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
        if (gl == 0) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float s = part[g] * p.scale;
            if (p.use_softcap) s = p.softcap * tanhf(s / p.softcap);
            s_sh[g][t] = load ? s : NEG;
          }
        }
      }
      __syncthreads();

      // running max / sum: one warp per query head
      for (int g = warp; g < G; g += NWARP) {
        const float s = s_sh[g][lane];
        const float m_prev = m_sh[g];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float m_safe = fmaxf(m_new, -1e20f);
        const float corr = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        const float pv = ok_sh[lane] ? expf(s - m_safe) : 0.f;
        p_sh[g][lane] = pv;
        const float psum = warp_sum(pv);
        if (lane == 0) {
          l_sh[g] = l_sh[g] * corr + psum;
          corr_sh[g] = corr;
          m_sh[g] = m_new;
        }
      }
      __syncthreads();

      // accumulator: rescale, then add p * v for this group's token rows
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float corr = corr_sh[g];
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) acc[g][i] *= corr;
      }
      for (int t = grp; t < tn; t += ngrp) {
        if (!ok_sh[t]) continue;
        const T* vr = vb + (size_t)(t0 + t) * hd;
#pragma unroll
        for (int c = 0; c < MAX_NCH; ++c) {
          if (c < nch) {
            float vf[VEC];
            Vec<T>::load(vr + (gl + c * tpr) * VEC, vf);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float pg = p_sh[g][t];
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[g][c * VEC + v] += pg * vf[v];
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // sum the per-group accumulators (fixed order: group 0, 1, ...)
  for (int gi = 0; gi < ngrp; ++gi) {
    if (grp == gi) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < MAX_NCH; ++c)
          if (c < nch)
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const int col = (gl + c * tpr) * VEC + v;
              const float prev = gi == 0 ? 0.f : fin_sh[g][col];
              fin_sh[g][col] = prev + acc[g][c * VEC + v];
            }
    }
    __syncthreads();
  }

  // estimation finalize: max, denominator, then num over E in tiles
  const int E = p.E;
  for (int g = warp; g < G; g += NWARP) {
    const float* el = p.est_logit + ((size_t)row * G + g) * E;
    float mx = -INFINITY;
    for (int e = lane; e < E; e += 32) mx = fmaxf(mx, el[e]);
    mx = warp_max(mx);
    const float m_prev = m_sh[g];
    const float m_fin = fmaxf(fmaxf(m_prev, mx), -1e20f);
    const float corr = isfinite(m_prev) ? expf(m_prev - m_fin) : 0.f;
    float wd = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float x = el[e];
      wd += x > NEG / 2 ? expf(x - m_fin) : 0.f;
    }
    wd = warp_sum(wd);
    if (lane == 0) {
      den_sh[g] = l_sh[g] * corr + wd;
      mfin_sh[g] = m_fin;
      cfin_sh[g] = corr;
    }
  }
  __syncthreads();

  constexpr int COLS = HD_MAX / NT;            // output columns per thread
  float num[G][COLS];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < COLS; ++i) num[g][i] = 0.f;
  for (int e0 = 0; e0 < E; e0 += TILE) {
    for (int i = tid; i < G * TILE; i += NT) {  // w_num of this tile -> p_sh
      const int g = i / TILE, e = e0 + i % TILE;
      float w = 0.f;
      if (e < E) {
        const size_t o = ((size_t)row * G + g) * E + e;
        if (p.est_logit[o] > NEG / 2) w = expf(p.cs[o] - mfin_sh[g]);
      }
      p_sh[g][i % TILE] = w;
    }
    __syncthreads();
    const int en = min(TILE, E - e0);
    for (int e = 0; e < en; ++e) {
      const float* vsr = p.vs + ((size_t)row * E + e0 + e) * hd;
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        const int d = tid + i * NT;
        if (d < hd) {
          const float x = vsr[d];
#pragma unroll
          for (int g = 0; g < G; ++g) num[g][i] += p_sh[g][e] * x;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const int d = tid + i * NT;
    if (d < hd) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        p.out[((size_t)row * G + g) * hd + d] =
            (fin_sh[g][d] * cfin_sh[g] + num[g][i]) / fmaxf(den_sh[g], 1e-30f);
    }
  }
}

template <typename T>
cudaError_t launch_t(const Params& p, int BH, int G, cudaStream_t stream) {
  switch (G) {
    case 1: paged_wave_attention_kernel<T, 1><<<BH, NT, 0, stream>>>(p); break;
    case 2: paged_wave_attention_kernel<T, 2><<<BH, NT, 0, stream>>>(p); break;
    case 4: paged_wave_attention_kernel<T, 4><<<BH, NT, 0, stream>>>(p); break;
    case 8: paged_wave_attention_kernel<T, 8><<<BH, NT, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). Pointer arguments follow the twin's
// argument order (ref.py). store_dtype: 0 = f32, 1 = bf16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_wave_attention(
    int store_dtype, const void* idx, const void* rowb, const void* live,
    const void* q, const void* sink_k, const void* sink_v,
    const void* local_k, const void* local_v, const void* local_pos,
    const void* k_store, const void* v_store, const void* pos_store,
    const void* est_logit, const void* cs, const void* vs, void* out,
    int BH, int G, int hd, int Ss, int sink_len, int Lb, int M, int cap,
    int r, int E, float scale, float softcap, int use_softcap,
    void* stream) {
  if (BH <= 0) return 0;
  if (hd <= 0 || hd > HD_MAX || hd % 8 != 0 || ((hd / 8) & (hd / 8 - 1)) != 0)
    return cudaErrorInvalidValue;
  Params p;
  p.idx = static_cast<const int*>(idx);
  p.live = static_cast<const int*>(live);
  p.rowb = static_cast<const int*>(rowb);
  p.q = static_cast<const float*>(q);
  p.sink_k = sink_k; p.sink_v = sink_v; p.Ss = Ss; p.sink_len = sink_len;
  p.local_k = local_k; p.local_v = local_v;
  p.local_pos = static_cast<const int*>(local_pos); p.Lb = Lb;
  p.k_store = k_store; p.v_store = v_store;
  p.pos_store = static_cast<const int*>(pos_store);
  p.M = M; p.cap = cap; p.r = r;
  p.est_logit = static_cast<const float*>(est_logit);
  p.cs = static_cast<const float*>(cs);
  p.vs = static_cast<const float*>(vs); p.E = E;
  p.out = static_cast<float*>(out);
  p.hd = hd; p.scale = scale;
  p.softcap = softcap; p.use_softcap = use_softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_dtype == 1) return launch_t<__nv_bfloat16>(p, BH, G, s);
  if (store_dtype == 0) return launch_t<float>(p, BH, G, s);
  return cudaErrorInvalidValue;
}
