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
// folded in. Output (BH, G, hd) f32.
//
// What bounds it: HBM bytes. Each row reads the T tokens of K and V that
// pass the mask plus the (E, hd) f32 estimation value sums, and does ~4*G
// flops per element read, far below the card's ~295 flop/byte ridge, so
// tensor cores would not help. At decode batch the time goes to memory
// latency unless many loads are in flight on many SMs.
//
// What the design does about it (wave_fold.cuh): the TPU's sequential grid
// axis over T becomes splits of a few 32-token tiles of the contiguous T
// (and of the estimation zone), one block each, so at B = 2 some 500 blocks
// share the 132 SMs instead of B*Hkv = 8. A block reads its tiles' valid
// bytes first, then puts the K/V rows of all its valid tokens in flight at
// once with 16-byte cp.async into shared memory, and only then folds; masked
// tokens are never loaded. Each split writes its (m, l, acc) partial; a
// second launch from the same entry point combines the partials by
// log-sum-exp. K/V are read in their storage dtype (bf16 or f32) and
// converted in registers: the same values the reference wrapper's f32 upcast
// gives, without an f32 copy of the buffer. Only the order of the f32 sums
// differs from the TPU kernel (its tiles are 512 tokens).
#include "wave_fold.cuh"

namespace {

using wave::TILE;
using wave::TileRef;

// The contiguous execution buffer of one row.
template <typename KV> struct MergeSrc {
  const KV* k; const KV* v; const unsigned char* valid; int T, hd;

  __device__ bool token(int row, int ti, int t, TileRef& tr) const {
    const int tt = ti * TILE + t;
    const size_t base = (size_t)row * T + ti * TILE;
    tr.k = k + base * hd;
    tr.v = v + base * hd;
    return tt < T && valid[(size_t)row * T + tt] != 0;
  }
};

}  // namespace

// C entry point (loaded with ctypes). Pointer arguments follow the twin's
// argument order (ref.py::wave_attention_ref); valid is one byte per token
// (torch.bool); ws is the f32 workspace of the split partials (ws_floats
// long, at least BH * splits * G * (hd + 2)); tps is the number of tiles per
// split (ops.py: split_plan). store_dtype (of k and v): 0 = f32, 1 = bf16.
// Launches the split kernel and then the combine kernel on `stream`.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int wave_attention_merge(
    int store_dtype, const void* q, const void* k, const void* v,
    const void* valid, const void* est_logit, const void* cs, const void* vs,
    void* out, void* ws, long long ws_floats, int BH, int G, int hd, int T,
    int E, int tps, float scale, float softcap, int use_softcap,
    void* stream) {
  if (BH <= 0) return 0;
  if (T <= 0 || E <= 0) return cudaErrorInvalidValue;
  wave::Common c;
  const cudaError_t e = wave::make_common(
      c, q, est_logit, cs, vs, out, ws, ws_floats, BH, G, hd, E,
      wave::cdiv(T, TILE), tps, scale, softcap, use_softcap);
  if (e != cudaSuccess) return e;
  auto make = [&](auto tag) {
    using KV = decltype(tag);
    return MergeSrc<KV>{static_cast<const KV*>(k), static_cast<const KV*>(v),
                        static_cast<const unsigned char*>(valid), T, hd};
  };
  return wave::dispatch<MergeSrc>(store_dtype, G, c, make,
                                  static_cast<cudaStream_t>(stream));
}
