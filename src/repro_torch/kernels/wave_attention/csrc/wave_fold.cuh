// The split-and-combine machinery shared by the wave-attention kernels
// (paged_wave_attention.cu and wave_attention.cu), for Hopper (sm_90a).
//
// A decode step's attention for one flattened (batch, kv-head) row and its
// G query heads is a walk over tiles of TILE tokens (the kernels differ only
// in where a tile's K/V rows come from and which of its tokens are valid:
// each supplies a tile source, `Src`), then the estimation zone's E entries.
// One kernel launch cuts both into splits and folds each split in its own
// block; a second launch combines the splits' partials by log-sum-exp:
//
//   split_kernel   grid (splits, rows), NT threads. An attention split takes
//                  `tps` consecutive tiles of the walk: it first reads its
//                  tiles' ids and positions and forms each tile's valid-token
//                  mask (the TPU kernel's scalar prefetch), then issues the
//                  K/V rows of every valid token with 16-byte cp.async into a
//                  shared-memory ring of NSTAGE tiles, and only then folds
//                  them (online softmax, all in f32). Tiles with no valid
//                  token are never loaded. An estimation split takes `tps`
//                  tiles of E entries and folds them the same way with the
//                  given weights. Every split writes a partial (m, l, acc)
//                  to the workspace, an empty one (-inf, 0, 0) included.
//   combine_kernel grid (rows * G, hd / CC), CT threads:
//                  m = max(-1e20, all m_s); w_s = exp(m_s - m), 0 where
//                  m_s = -inf;
//                  out = sum w_s acc_s / max(sum w_s l_s, 1e-30).
//
// Semantics kept exactly from the TPU kernels (kernel.py: _kernel,
// _make_fold, _est_finalize): masked scores are NEG = -1e30 (not -inf); m
// starts at -inf, m_safe = max(m_new, -1e20), corr = isfinite(m_prev) ?
// exp(m_prev - m_safe) : 0; p re-masked to 0 after the exp; estimation
// entries are live where est_logit > NEG/2. An attention partial's m is the
// m_safe its l and acc are relative to (-inf if it folded nothing). An
// estimation partial is (m_e = max est_logit, den_e = sum_live
// exp(est_logit - m_e), num_e = sum_live exp(cs - m_e) vs), which cannot
// overflow since cs <= est_logit on live entries; folding it at the combine
// weight exp(m_e - m) gives the reference's exp(. - m_fin) terms. q stays
// f32, K/V are read in their storage dtype (bf16 or f32) and converted in
// registers, every product accumulates in f32, and every sum runs in a
// fixed order (no atomics), so a shape's result is bit-identical from run to
// run. Built without --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wave {

constexpr int NT = 128;          // threads per split block
constexpr int NWARP = NT / 32;
constexpr int TILE = 32;         // tokens (estimation entries) per tile
constexpr int HD_MAX = 256;
constexpr int MAX_G = 8;         // query heads per KV head, at most
constexpr int PER_THREAD = 8;    // f32 accumulators per query head per thread
constexpr int MAX_TPS = 8;       // tiles per split, at most
constexpr int NSTAGE = 2;        // depth of the cp.async ring
constexpr int CT = 256;          // threads per combine block
constexpr int CC = 64;           // output columns per combine block
constexpr float NEG = -1e30f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int pad4(int a) { return (a + 3) & ~3; }

// How a row's walk (n_tiles tiles) and estimation zone (e_tiles tiles) are
// cut: tps tiles per split; attention splits first, then estimation ones.
struct Split {
  int n_tiles, e_tiles, tps;
  __host__ __device__ int att_splits() const { return cdiv(n_tiles, tps); }
  __host__ __device__ int splits() const {
    return att_splits() + cdiv(e_tiles, tps);
  }
};

// What both kernels share: the query, the estimation zone, the workspace.
struct Common {
  const float* q;                // (BH, G, hd)
  const float* est_logit;        // (BH, G, E)
  const float* cs;               // (BH, G, E)
  const float* vs;               // (BH, E, hd)
  float* ws;                     // acc (BH, S, G, hd) | m (BH, S, G) | l (BH, S, G)
  float* out;                    // (BH, G, hd)
  int BH, E, hd;
  float scale, softcap;
  int use_softcap;
  Split sp;
};

// floats of workspace a launch needs
inline size_t workspace_floats(int BH, int G, int hd, const Split& sp) {
  return (size_t)BH * sp.splits() * G * (hd + 2);
}

// One tile of a split: where its rows start and which rows are valid.
struct TileRef {
  const void* k;                 // first K row (estimation: first vs row)
  const void* v;                 // first V row (estimation: unused)
  unsigned mask;                 // bit t: row t is valid, loaded and folded
};

template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;    // 8 bf16 = 16 bytes
  __device__ static void lds(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;    // 4 f32 = 16 bytes
  __device__ static void lds(const float* p, float* out) {
    const float4 raw = *reinterpret_cast<const float4*>(p);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1));
}

// Copy the valid rows (mask) of a TILE x hd tile from global to shared
// memory, 16 bytes a thread, consecutive threads on consecutive addresses.
template <typename T>
__device__ __forceinline__ void issue_rows(T* dst, const T* src, unsigned mask,
                                           int hd) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = hd / V;                           // chunks per row
  for (int i = threadIdx.x; i < TILE * cpr; i += NT) {
    const int t = i / cpr;
    if ((mask >> t) & 1u) cp_async16(dst + (size_t)i * V, src + (size_t)i * V);
  }
}

// Shared memory of a split block (besides the dynamic ring).
template <int G> struct SplitSmem {
  TileRef tiles[MAX_TPS];        // the split's tiles, in walk order
  float s[G][TILE];
  float p[G][TILE];
  float m[G], l[G], corr[G];
  float w[G][MAX_TPS * TILE];    // estimation split: exp(cs - m_e) per entry
  float fin[G][HD_MAX];
};

// A thread's slice of the (G, hd) accumulator over rows of element type T:
// tpr threads share a row (16 bytes each, nch chunks), ngrp rows at a time.
template <typename T, int G> struct Acc {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int MAX_NCH = PER_THREAD / VEC;
  const int hd, tpr, nch, ngrp, grp, gl;
  float a[G][PER_THREAD];

  __device__ __forceinline__ explicit Acc(int hd_)
      : hd(hd_), tpr(hd_ / VEC < 32 ? hd_ / VEC : 32), nch(hd_ / VEC / tpr),
        ngrp(NT / tpr), grp(threadIdx.x / tpr), gl(threadIdx.x % tpr) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) a[g][i] = 0.f;
  }

  __device__ __forceinline__ int col(int c, int v) const {
    return (gl + c * tpr) * VEC + v;
  }

  __device__ __forceinline__ void scale(const float* corr) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) a[g][i] *= corr[g];
  }

  // a[g] += p[g * pstride + t] * rows[t] over the valid rows t of a shared
  // memory tile (invalid rows were never loaded and are never read).
  __device__ __forceinline__ void add(const T* rows, const float* p,
                                      int pstride, unsigned mask) {
    for (int t = grp; t < TILE; t += ngrp) {
      if (!((mask >> t) & 1u)) continue;
      const T* vr = rows + (size_t)t * hd;
#pragma unroll
      for (int c = 0; c < MAX_NCH; ++c) {
        if (c < nch) {
          float vf[VEC];
          Vec<T>::lds(vr + col(c, 0), vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pg = p[g * pstride + t];
#pragma unroll
            for (int v = 0; v < VEC; ++v) a[g][c * VEC + v] += pg * vf[v];
          }
        }
      }
    }
  }

  // Sum the row groups' slices into fin (fixed order: group 0, 1, ...).
  // Starts and ends with a barrier.
  __device__ __forceinline__ void reduce(float (*fin)[HD_MAX]) {
    __syncthreads();
    for (int gi = 0; gi < ngrp; ++gi) {
      if (grp == gi) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int c = 0; c < MAX_NCH; ++c)
            if (c < nch)
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                const float prev = gi == 0 ? 0.f : fin[g][col(c, v)];
                fin[g][col(c, v)] = prev + a[g][c * VEC + v];
              }
      }
      __syncthreads();
    }
  }
};

// Fold one attention tile (K rows at ks, V rows at vs in shared memory) into
// the running (m, l) in sm and the accumulator. Ends with a barrier.
template <typename KV, int G>
__device__ __forceinline__ void fold_tile(SplitSmem<G>& sm, Acc<KV, G>& acc,
                                          const float (&qr)[G][PER_THREAD],
                                          const KV* ks, const KV* vs,
                                          unsigned mask, const Common& c) {
  constexpr int VEC = Vec<KV>::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // scores: one token row per thread group, reduced over the group
  for (int t = acc.grp; t < TILE; t += acc.ngrp) {
    const bool ok = (mask >> t) & 1u;
    float part[G];
#pragma unroll
    for (int g = 0; g < G; ++g) part[g] = 0.f;
    if (ok) {
      const KV* kr = ks + (size_t)t * c.hd;
#pragma unroll
      for (int ch = 0; ch < Acc<KV, G>::MAX_NCH; ++ch) {
        if (ch < acc.nch) {
          float kf[VEC];
          Vec<KV>::lds(kr + acc.col(ch, 0), kf);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int v = 0; v < VEC; ++v) part[g] += qr[g][ch * VEC + v] * kf[v];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int o = acc.tpr >> 1; o > 0; o >>= 1)
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
    if (acc.gl == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = part[g] * c.scale;
        if (c.use_softcap) s = c.softcap * tanhf(s / c.softcap);
        sm.s[g][t] = ok ? s : NEG;
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
    const float pv = ((mask >> lane) & 1u) ? expf(s - m_safe) : 0.f;
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
  acc.scale(sm.corr);
  acc.add(vs, &sm.p[0][0], TILE, mask);
  __syncthreads();
}

// Walk a split's n live tiles (sm.tiles) through the cp.async ring: the
// first NSTAGE tiles are requested at once, and each later one as soon as
// its stage is free. fold(i, stage) folds tile i from its stage.
template <typename Issue, typename Fold>
__device__ __forceinline__ void ring_walk(int n, int nst, Issue issue, Fold fold) {
#pragma unroll
  for (int k = 0; k < NSTAGE; ++k) {
    if (k < n) issue(k, k % nst);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait_ring();
    __syncthreads();
    fold(i, i % nst);
    __syncthreads();
    if (i + NSTAGE < n) issue(i + NSTAGE, (i + NSTAGE) % nst);
    cp_async_commit();
  }
}

// Bit i: tile i of the split has a valid token (the tiles the ring walks).
template <int G>
__device__ __forceinline__ unsigned live_tiles(const SplitSmem<G>& sm, int nt) {
  unsigned live = 0;
  for (int i = 0; i < nt; ++i)
    if (sm.tiles[i].mask) live |= 1u << i;
  return live;
}

// The index of the k-th (from 0) set bit of x.
__device__ __forceinline__ int nth_bit(unsigned x, int k) {
  for (int j = 0; j < k; ++j) x &= x - 1;
  return __ffs(x) - 1;
}

template <int G>
__device__ __forceinline__ void write_partial(const SplitSmem<G>& sm,
                                              const Common& c, int row, int s,
                                              bool attention) {
  const int S = c.sp.splits();
  const size_t slot = (size_t)row * S + s;
  float* acc = c.ws + slot * G * c.hd;
  float* m = c.ws + (size_t)c.BH * S * G * c.hd + slot * G;
  float* l = m + (size_t)c.BH * S * G;
  for (int i = threadIdx.x; i < G * c.hd; i += NT) acc[i] = sm.fin[i / c.hd][i % c.hd];
  if (threadIdx.x < G) {
    const float mg = sm.m[threadIdx.x];
    // attention: the m_safe that l and acc are relative to
    m[threadIdx.x] = !attention ? mg : isfinite(mg) ? fmaxf(mg, -1e20f) : -INFINITY;
    l[threadIdx.x] = sm.l[threadIdx.x];
  }
}

// Src: a tile source with
//   __device__ bool token(int row, int tile, int t, TileRef& tr) const
// (called by a whole warp, lane t; sets tr.k / tr.v, returns whether token
// t of the tile is valid).
template <class Src, typename KV, int G>
__global__ void __launch_bounds__(NT) split_kernel(Src src, Common c) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ SplitSmem<G> sm;
  const int s = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = c.hd, tps = c.sp.tps;
  const int nst = tps < NSTAGE ? tps : NSTAGE;
  const bool attention = s < c.sp.att_splits();

  if (attention) {
    if (tid < G) { sm.m[tid] = -INFINITY; sm.l[tid] = 0.f; }
    // 1. ids and positions of the split's tiles -> valid-token masks
    const int t_begin = s * tps;
    const int nt = min(tps, c.sp.n_tiles - t_begin);
    for (int i = warp; i < nt; i += NWARP) {
      TileRef tr;
      const bool ok = src.token(row, t_begin + i, lane, tr);
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) { tr.mask = mask; sm.tiles[i] = tr; }
    }
    Acc<KV, G> acc(hd);
    float qr[G][PER_THREAD];
    const float* q = c.q + (size_t)row * G * hd;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int ch = 0; ch < Acc<KV, G>::MAX_NCH; ++ch)
#pragma unroll
        for (int v = 0; v < Acc<KV, G>::VEC; ++v)
          qr[g][ch * Acc<KV, G>::VEC + v] =
              ch < acc.nch ? q[(size_t)g * hd + acc.col(ch, v)] : 0.f;
    __syncthreads();
    const unsigned live = live_tiles(sm, nt);
    const int n = __popc(live);

    // 2. all K/V loads in flight, then 3. fold each tile as it lands
    const size_t stage_elems = (size_t)2 * TILE * hd;
    KV* kv_ring = reinterpret_cast<KV*>(ring);
    auto issue = [&](int k, int st) {
      const TileRef& tr = sm.tiles[nth_bit(live, k)];
      KV* ks = kv_ring + st * stage_elems;
      issue_rows<KV>(ks, static_cast<const KV*>(tr.k), tr.mask, hd);
      issue_rows<KV>(ks + (size_t)TILE * hd, static_cast<const KV*>(tr.v),
                     tr.mask, hd);
    };
    auto fold = [&](int k, int st) {
      const KV* ks = kv_ring + st * stage_elems;
      fold_tile<KV, G>(sm, acc, qr, ks, ks + (size_t)TILE * hd,
                       sm.tiles[nth_bit(live, k)].mask, c);
    };
    ring_walk(n, nst, issue, fold);
    acc.reduce(sm.fin);
  } else {
    // estimation entries [e0, e0 + ne) of this row
    const int e0 = (s - c.sp.att_splits()) * tps * TILE;
    const int ne = min(tps * TILE, c.E - e0);
    // 1. weights: m_e, den_e and exp(cs - m_e) per live entry
    for (int g = warp; g < G; g += NWARP) {
      const float* el = c.est_logit + ((size_t)row * G + g) * c.E + e0;
      const float* csr = c.cs + ((size_t)row * G + g) * c.E + e0;
      float mx = -INFINITY;
      for (int e = lane; e < ne; e += 32) mx = fmaxf(mx, el[e]);
      mx = warp_max(mx);
      float den = 0.f;
      for (int e = lane; e < tps * TILE; e += 32) {
        float w = 0.f;
        if (e < ne) {
          const float x = el[e];
          if (x > NEG / 2) {
            den += expf(x - mx);
            w = expf(csr[e] - mx);
          }
        }
        sm.w[g][e] = w;
      }
      den = warp_sum(den);
      if (lane == 0) { sm.m[g] = mx; sm.l[g] = den; }
    }
    __syncthreads();
    const int nt = cdiv(ne, TILE);
    for (int i = warp; i < nt; i += NWARP) {
      bool ok = false;
#pragma unroll
      for (int g = 0; g < G; ++g) ok |= sm.w[g][i * TILE + lane] != 0.f;
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (lane == 0)
        sm.tiles[i] = TileRef{c.vs + ((size_t)row * c.E + e0 + i * TILE) * hd,
                              nullptr, mask};
    }
    __syncthreads();
    const unsigned live = live_tiles(sm, nt);
    const int n = __popc(live);

    // 2. vs rows of the live entries in flight, 3. num_e += w * vs
    Acc<float, G> acc(hd);
    const size_t stage_elems = (size_t)TILE * hd;
    float* vs_ring = reinterpret_cast<float*>(ring);
    auto issue = [&](int k, int st) {
      const TileRef& tr = sm.tiles[nth_bit(live, k)];
      issue_rows<float>(vs_ring + st * stage_elems,
                        static_cast<const float*>(tr.k), tr.mask, hd);
    };
    auto fold = [&](int k, int st) {
      const int i = nth_bit(live, k);
      acc.add(vs_ring + st * stage_elems, &sm.w[0][i * TILE], MAX_TPS * TILE,
              sm.tiles[i].mask);
    };
    ring_walk(n, nst, issue, fold);
    acc.reduce(sm.fin);
  }
  write_partial<G>(sm, c, row, s, attention);
}

// Combine a row's partials for one query head and CC of its columns
// (block = (row * G + g, column chunk)).
template <class Src>
__global__ void __launch_bounds__(CT) combine_kernel(const float* ws, int BH,
                                                     int S, int G, int hd,
                                                     float* out) {
  // S weights (padded to 4), then CT * 4 column partial sums
  extern __shared__ __align__(16) float cw[];
  __shared__ float red[CT / 32];
  __shared__ float mtot, dtot;
  const int row = blockIdx.x / G, g = blockIdx.x % G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* acc = ws;
  const float* m = ws + (size_t)BH * S * G * hd;
  const float* l = m + (size_t)BH * S * G;
  const size_t base = (size_t)row * S;

  float mx = -1e20f;
  for (int s = tid; s < S; s += CT) mx = fmaxf(mx, m[(base + s) * G + g]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float v = red[0];
    for (int i = 1; i < CT / 32; ++i) v = fmaxf(v, red[i]);
    mtot = v;
  }
  __syncthreads();
  const float mt = mtot;
  float d = 0.f;
  for (int s = tid; s < S; s += CT) {
    const float ms = m[(base + s) * G + g];
    const float w = ms == -INFINITY ? 0.f : expf(ms - mt);
    cw[s] = w;
    d += w * l[(base + s) * G + g];
  }
  d = warp_sum(d);
  __syncthreads();               // red reused; cw complete
  if (lane == 0) red[warp] = d;
  __syncthreads();
  if (tid == 0) {
    float v = 0.f;
    for (int i = 0; i < CT / 32; ++i) v += red[i];
    dtot = v;
  }

  // this block's cc columns: ct threads per row (4 columns each), ngr row
  // groups; every partial was written (an empty one as zeros), so the
  // loads need no branch and many are in flight at once
  const int cc = hd < CC ? hd : CC;
  const int ct = cc / 4, ngr = CT / ct;
  const int grp = tid / ct, c4 = (tid % ct) * 4;
  const int col = blockIdx.y * cc + c4;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = grp; s < S; s += ngr) {
    const float w = cw[s];
    const float4 x = *reinterpret_cast<const float4*>(
        acc + ((base + s) * G + g) * hd + col);
    a.x += w * x.x; a.y += w * x.y; a.z += w * x.z; a.w += w * x.w;
  }
  float* part = cw + pad4(S);
  *reinterpret_cast<float4*>(part + (size_t)grp * cc + c4) = a;
  __syncthreads();
  if (tid < ct) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int gi = 0; gi < ngr; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(part + (size_t)gi * cc + c4);
      sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
    }
    const float den = fmaxf(dtot, 1e-30f);
    float* o = out + ((size_t)row * G + g) * hd + col;
    o[0] = sum.x / den; o[1] = sum.y / den; o[2] = sum.z / den; o[3] = sum.w / den;
  }
}

// Set a kernel's dynamic shared memory limit to at least `bytes` (once per
// kernel and size). `allowed` is the limit last set on that kernel, so it
// must be kept per kernel: a smaller request must never lower a limit that
// another caller of the same kernel relies on.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// The limit set on combine_kernel<Src>, which every (KV, G) of a Src shares.
template <class Src>
size_t& combine_allowed() {
  static size_t allowed = 0;
  return allowed;
}

// The two launches of one decode step's attention, on `stream`.
template <class Src, typename KV, int G>
cudaError_t run(const Src& src, const Common& c, cudaStream_t stream) {
  static size_t split_allowed = 0;     // split_kernel<Src, KV, G>'s limit
  const int S = c.sp.splits();
  if (S > 0) {
    const int nst = c.sp.tps < NSTAGE ? c.sp.tps : NSTAGE;
    const size_t kv = (size_t)2 * TILE * c.hd * sizeof(KV);
    const size_t est = (size_t)TILE * c.hd * sizeof(float);
    const size_t dyn = nst * (kv > est ? kv : est);
    cudaError_t e = allow_smem(split_kernel<Src, KV, G>, dyn, split_allowed);
    if (e != cudaSuccess) return e;
    split_kernel<Src, KV, G><<<dim3(S, c.BH), NT, dyn, stream>>>(src, c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const size_t cdyn = ((size_t)pad4(S) + 4 * CT) * sizeof(float);
  cudaError_t e = allow_smem(combine_kernel<Src>, cdyn,
                             combine_allowed<Src>());
  if (e != cudaSuccess) return e;
  const dim3 cgrid(c.BH * G, cdiv(c.hd, CC));
  combine_kernel<Src><<<cgrid, CT, cdyn, stream>>>(c.ws, c.BH, S, G, c.hd,
                                                   c.out);
  return cudaGetLastError();
}

// Check the shared arguments of a C entry point and fill `c`.
inline cudaError_t make_common(Common& c, const void* q, const void* est_logit,
                               const void* cs, const void* vs, void* out,
                               void* ws, long long ws_floats, int BH, int G,
                               int hd, int E, int n_tiles, int tps, float scale,
                               float softcap, int use_softcap) {
  if (hd <= 0 || hd > HD_MAX || hd % 8 != 0 || ((hd / 8) & (hd / 8 - 1)) != 0)
    return cudaErrorInvalidValue;
  if (G < 1 || G > MAX_G) return cudaErrorInvalidValue;
  if (E < 0 || n_tiles < 0 || tps < 1 || tps > MAX_TPS)
    return cudaErrorInvalidValue;
  c.q = static_cast<const float*>(q);
  c.est_logit = static_cast<const float*>(est_logit);
  c.cs = static_cast<const float*>(cs);
  c.vs = static_cast<const float*>(vs);
  c.ws = static_cast<float*>(ws);
  c.out = static_cast<float*>(out);
  c.BH = BH; c.E = E; c.hd = hd;
  c.scale = scale; c.softcap = softcap; c.use_softcap = use_softcap;
  c.sp = Split{n_tiles, cdiv(E, TILE), tps};
  if (ws_floats < 0 || (size_t)ws_floats < workspace_floats(BH, G, hd, c.sp))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Dispatch on the storage dtype (0 = f32, 1 = bf16) and G in 1..MAX_G. Every
// piece is generic in G: the per-warp head loops stride by NWARP, the combine
// grid is rows * G, and the static shared memory grows linearly (G 8: 18 KB).
template <template <typename> class Src, typename Make>
cudaError_t dispatch(int store_dtype, int G, const Common& c, Make make,
                     cudaStream_t stream) {
#define WAVE_G(KV)                                                         \
  switch (G) {                                                             \
    case 1: return run<Src<KV>, KV, 1>(make(KV()), c, stream);             \
    case 2: return run<Src<KV>, KV, 2>(make(KV()), c, stream);             \
    case 3: return run<Src<KV>, KV, 3>(make(KV()), c, stream);             \
    case 4: return run<Src<KV>, KV, 4>(make(KV()), c, stream);             \
    case 5: return run<Src<KV>, KV, 5>(make(KV()), c, stream);             \
    case 6: return run<Src<KV>, KV, 6>(make(KV()), c, stream);             \
    case 7: return run<Src<KV>, KV, 7>(make(KV()), c, stream);             \
    case 8: return run<Src<KV>, KV, 8>(make(KV()), c, stream);             \
    default: return cudaErrorInvalidValue;                                 \
  }
  if (store_dtype == 1) { WAVE_G(__nv_bfloat16) }
  if (store_dtype == 0) { WAVE_G(float) }
#undef WAVE_G
  return cudaErrorInvalidValue;
}

}  // namespace wave
