// Gathered-buffer wave attention (one decode step) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wave_attention/kernel.py::wave_attention_pallas
// (body _kernel). Plain twin: ../ref.py::wave_attention_ref.
//
// What it computes, per flattened (batch, kv-head) row and its G query
// heads: one online softmax over a contiguous execution buffer of T tokens
// (sink, local buffer and the retrieved clusters, already gathered and
// concatenated by the caller), masked by valid[t], then the estimation zone
// folded in at finalize. Output (BH, G, hd) f32.
//
// What bounds it: HBM bytes. Each row reads the T tokens of K and V that
// pass the mask plus the (E, hd) f32 estimation value sums, and does ~4*G
// flops per element read, far below the card's ~295 flop/byte ridge.
//
// What the design does about it: the TPU's sequential grid axis over T
// tiles becomes a loop inside one 128-thread block per row. K/V are read
// once, in their storage dtype (bf16 or f32), with 16-byte vector loads by
// consecutive threads, and converted to f32 in registers: the same values
// the reference wrapper's f32 upcast gives, without an f32 copy of the
// buffer. Masked tokens are never loaded and a tile with no valid token is
// skipped. Scores, the running (m, l) and the (G, hd) accumulator stay on
// chip. One block per row leaves most of the 132 SMs idle at small batch;
// since T is contiguous, splitting it across blocks (flash-decoding) with an
// LSE combine is the next redesign.
//
// The fold itself (scores, online softmax, accumulator, estimation
// finalize, and the TPU kernel's exact masking semantics) is shared with the
// paged kernel: wave_fold.cuh. Tiles are 32 tokens (the TPU's 512), so only
// the order of the f32 sums differs. Built without --use_fast_math.
#include "wave_fold.cuh"

namespace {

using wave::NT;
using wave::TILE;

struct Params {
  const float* q;
  const void* k; const void* v; const unsigned char* valid; int T;
  const float* est_logit; const float* cs; const float* vs; int E;
  float* out;
  int hd; float scale; float softcap; int use_softcap;
};

template <typename KV, int G>
__global__ void __launch_bounds__(NT) wave_attention_kernel(Params p) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x, hd = p.hd;
  __shared__ wave::FoldSmem<G> sm;
  wave::Fold<KV, G> fold(sm, p.q + (size_t)row * G * hd, hd, p.scale,
                         p.softcap, p.use_softcap);
  const KV* kb = static_cast<const KV*>(p.k) + (size_t)row * p.T * hd;
  const KV* vb = static_cast<const KV*>(p.v) + (size_t)row * p.T * hd;
  const unsigned char* okr = p.valid + (size_t)row * p.T;
  for (int t0 = 0; t0 < p.T; t0 += TILE) {
    const int tn = min(TILE, p.T - t0);
    if (tid < TILE) sm.ok[tid] = tid < tn && okr[t0 + tid] != 0;
    // a tile with no valid token folds nothing: skip it
    if (!wave::any_valid(sm, tid)) continue;
    fold.tile(kb + (size_t)t0 * hd, vb + (size_t)t0 * hd, tn);
  }
  fold.finish(p.est_logit + (size_t)row * G * p.E, p.cs + (size_t)row * G * p.E,
              p.vs + (size_t)row * p.E * hd, p.E, p.out + (size_t)row * G * hd);
}

template <typename KV>
cudaError_t launch_t(const Params& p, int BH, int G, cudaStream_t stream) {
  switch (G) {
    case 1: wave_attention_kernel<KV, 1><<<BH, NT, 0, stream>>>(p); break;
    case 2: wave_attention_kernel<KV, 2><<<BH, NT, 0, stream>>>(p); break;
    case 4: wave_attention_kernel<KV, 4><<<BH, NT, 0, stream>>>(p); break;
    case 8: wave_attention_kernel<KV, 8><<<BH, NT, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). Pointer arguments follow the twin's
// argument order (ref.py::wave_attention_ref); valid is one byte per token
// (torch.bool). store_dtype (of k and v): 0 = f32, 1 = bf16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int wave_attention_merge(
    int store_dtype, const void* q, const void* k, const void* v,
    const void* valid, const void* est_logit, const void* cs, const void* vs,
    void* out, int BH, int G, int hd, int T, int E, float scale,
    float softcap, int use_softcap, void* stream) {
  if (BH <= 0) return 0;
  if (hd <= 0 || hd > wave::HD_MAX || hd % 8 != 0 || ((hd / 8) & (hd / 8 - 1)) != 0)
    return cudaErrorInvalidValue;
  if (T <= 0 || E <= 0) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = k; p.v = v;
  p.valid = static_cast<const unsigned char*>(valid); p.T = T;
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
