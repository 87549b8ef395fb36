// The online-softmax fold shared by the wave-attention kernels
// (paged_wave_attention.cu and wave_attention.cu), for Hopper (sm_90a).
//
// One 128-thread block folds the G query heads of one flattened (batch,
// kv-head) row over tiles of TILE tokens, then folds in the estimation zone
// and writes the (G, hd) f32 output. The kernels differ only in where a
// tile's K/V rows come from and which of its tokens are valid: each fills
// FoldSmem::ok for a tile, skips the tile when no token is valid
// (any_valid), and hands the rest to Fold::tile. Fold::finish ends the row.
//
// Semantics kept exactly from the TPU kernels (kernel.py: _kernel,
// _make_fold, _est_finalize): masked scores are NEG=-1e30 (not -inf); m
// starts at -inf, m_safe = max(m_new, -1e20), corr = isfinite(m_prev) ?
// exp(m_prev - m_safe) : 0; p re-masked to 0 after the exp; finalize with
// live_e = est_logit > NEG/2 and out = num / max(den, 1e-30). q stays f32,
// K/V are read in their storage dtype (bf16 or f32) with 16-byte loads and
// converted in registers, and every product accumulates in f32. Skipping a
// fully masked tile is exact: it would leave l and acc where the next
// correction puts them. Built without --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wave {

constexpr int NT = 128;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int TILE = 32;         // tokens per tile
constexpr int HD_MAX = 256;
constexpr int PER_THREAD = 8;    // f32 accumulators per query head per thread
constexpr float NEG = -1e30f;

template <typename KV> struct Vec;

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

// Shared memory of one block's fold.
template <int G> struct FoldSmem {
  float s[G][TILE];
  float p[G][TILE];
  int ok[TILE];                  // the current tile's valid tokens
  float m[G], l[G], corr[G];
  float fin[G][HD_MAX];
  float den[G], mfin[G], cfin[G];
};

// After every thread with tid < TILE has set sm.ok[tid]: whether any token
// of the tile is valid (block-uniform; also the barrier for sm.ok).
template <int G>
__device__ __forceinline__ bool any_valid(const FoldSmem<G>& sm, int tid) {
  return __syncthreads_or(tid < TILE && sm.ok[tid]);
}

template <typename KV, int G> struct Fold {
  static constexpr int VEC = Vec<KV>::N;
  static constexpr int MAX_NCH = PER_THREAD / VEC;   // 16-byte chunks per row
  FoldSmem<G>& sm;
  const int tid, lane, warp, hd;
  const int tpr;                 // threads per token row
  const int nch;                 // chunks per thread (<= MAX_NCH)
  const int ngrp;                // token rows in flight
  const int grp, gl;
  const float scale, softcap;
  const int use_softcap;
  // this thread's slice of q (f32) and of the (G, hd) accumulator
  float qr[G][PER_THREAD];
  float acc[G][PER_THREAD];

  // q: this row's (G, hd) f32 query. Ends with a barrier.
  __device__ __forceinline__ Fold(FoldSmem<G>& sm_, const float* q, int hd_,
                                  float scale_, float softcap_,
                                  int use_softcap_)
      : sm(sm_), tid(threadIdx.x), lane(threadIdx.x & 31),
        warp(threadIdx.x >> 5), hd(hd_),
        tpr(hd_ / VEC < 32 ? hd_ / VEC : 32), nch(hd_ / VEC / tpr),
        ngrp(NT / tpr), grp(threadIdx.x / tpr), gl(threadIdx.x % tpr),
        scale(scale_), softcap(softcap_), use_softcap(use_softcap_) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int c = 0; c < MAX_NCH; ++c) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int col = (gl + c * tpr) * VEC + v;
          qr[g][c * VEC + v] = c < nch ? q[(size_t)g * hd + col] : 0.f;
          acc[g][c * VEC + v] = 0.f;
        }
      }
    }
    if (tid < G) { sm.m[tid] = -INFINITY; sm.l[tid] = 0.f; }
    __syncthreads();
  }

  // Fold tokens [0, tn) of a tile whose K/V rows start at kb/vb, where
  // any_valid has just returned true for sm.ok. Ends with a barrier.
  __device__ __forceinline__ void tile(const KV* kb, const KV* vb, int tn) {
    // scores: one token row per thread group, reduced over the group
    for (int t = grp; t < TILE; t += ngrp) {
      const bool load = t < tn && sm.ok[t];
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (load) {
        const KV* kr = kb + (size_t)t * hd;
#pragma unroll
        for (int c = 0; c < MAX_NCH; ++c) {
          if (c < nch) {
            float kf[VEC];
            Vec<KV>::load(kr + (gl + c * tpr) * VEC, kf);
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
          float s = part[g] * scale;
          if (use_softcap) s = softcap * tanhf(s / softcap);
          sm.s[g][t] = load ? s : NEG;
        }
      }
    }
    __syncthreads();

    // running max / sum: one warp per query head
    for (int g = warp; g < G; g += NWARP) {
      const float s = sm.s[g][lane];
      const float m_prev = sm.m[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float m_safe = fmaxf(m_new, -1e20f);
      const float corr = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      const float pv = sm.ok[lane] ? expf(s - m_safe) : 0.f;
      sm.p[g][lane] = pv;
      const float psum = warp_sum(pv);
      if (lane == 0) {
        sm.l[g] = sm.l[g] * corr + psum;
        sm.corr[g] = corr;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    // accumulator: rescale, then add p * v for this group's token rows
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float corr = sm.corr[g];
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) acc[g][i] *= corr;
    }
    for (int t = grp; t < tn; t += ngrp) {
      if (!sm.ok[t]) continue;
      const KV* vr = vb + (size_t)t * hd;
#pragma unroll
      for (int c = 0; c < MAX_NCH; ++c) {
        if (c < nch) {
          float vf[VEC];
          Vec<KV>::load(vr + (gl + c * tpr) * VEC, vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pg = sm.p[g][t];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[g][c * VEC + v] += pg * vf[v];
          }
        }
      }
    }
    __syncthreads();
  }

  // Sum the groups' accumulators, fold in the estimation zone (est_logit,
  // cs: this row's (G, E); vs: its (E, hd)) and write (G, hd) f32 to out.
  __device__ __forceinline__ void finish(const float* est_logit,
                                         const float* cs, const float* vs,
                                         int E, float* out) {
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
                const float prev = gi == 0 ? 0.f : sm.fin[g][col];
                sm.fin[g][col] = prev + acc[g][c * VEC + v];
              }
      }
      __syncthreads();
    }

    // estimation finalize: max, denominator, then num over E in tiles
    for (int g = warp; g < G; g += NWARP) {
      const float* el = est_logit + (size_t)g * E;
      float mx = -INFINITY;
      for (int e = lane; e < E; e += 32) mx = fmaxf(mx, el[e]);
      mx = warp_max(mx);
      const float m_prev = sm.m[g];
      const float m_fin = fmaxf(fmaxf(m_prev, mx), -1e20f);
      const float corr = isfinite(m_prev) ? expf(m_prev - m_fin) : 0.f;
      float wd = 0.f;
      for (int e = lane; e < E; e += 32) {
        const float x = el[e];
        wd += x > NEG / 2 ? expf(x - m_fin) : 0.f;
      }
      wd = warp_sum(wd);
      if (lane == 0) {
        sm.den[g] = sm.l[g] * corr + wd;
        sm.mfin[g] = m_fin;
        sm.cfin[g] = corr;
      }
    }
    __syncthreads();

    constexpr int COLS = HD_MAX / NT;          // output columns per thread
    float num[G][COLS];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < COLS; ++i) num[g][i] = 0.f;
    for (int e0 = 0; e0 < E; e0 += TILE) {
      for (int i = tid; i < G * TILE; i += NT) {  // w_num of this tile -> p
        const int g = i / TILE, e = e0 + i % TILE;
        float w = 0.f;
        if (e < E) {
          const size_t o = (size_t)g * E + e;
          if (est_logit[o] > NEG / 2) w = expf(cs[o] - sm.mfin[g]);
        }
        sm.p[g][i % TILE] = w;
      }
      __syncthreads();
      const int en = min(TILE, E - e0);
      for (int e = 0; e < en; ++e) {
        const float* vsr = vs + (size_t)(e0 + e) * hd;
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
          const int d = tid + i * NT;
          if (d < hd) {
            const float x = vsr[d];
#pragma unroll
            for (int g = 0; g < G; ++g) num[g][i] += sm.p[g][e] * x;
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
          out[(size_t)g * hd + d] =
              (sm.fin[g][d] * sm.cfin[g] + num[g][i]) / fmaxf(sm.den[g], 1e-30f);
      }
    }
  }
};

}  // namespace wave
