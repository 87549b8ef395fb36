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
// idx[j] (skipped where live[j] == 0), then the estimation zone folded in.
// Output (BH, G, hd) f32.
//
// What bounds it: HBM bytes. Each row reads (sink + local + r*cap) tokens of
// K and V plus the (E, hd) f32 estimation value sums and does ~4*G flops per
// element read, far below the card's ~295 flop/byte ridge, so tensor cores
// would not help. At decode batch the bytes are few (~5 MB at B = 2) and the
// time goes to memory latency unless many loads are in flight on many SMs.
//
// What the design does about it (wave_fold.cuh): the walk -- sink tiles,
// local-buffer tiles, then cap/32 tiles per retrieved cluster, 32 tokens each
// -- and the estimation zone are cut into splits of a few tiles, one block
// each, so at B = 2 some 500 blocks share the 132 SMs instead of B*Hkv = 8. A
// block reads its tiles' ids and positions first (idx, live, pos_store, or
// local_pos: the TPU kernel's scalar prefetch), then puts the K/V rows of all
// its valid tokens in flight at once with 16-byte cp.async into shared
// memory, and only then folds. Masked tokens (empty local slots,
// out-of-window cluster members) and dead clusters are never loaded. Each
// split writes its (m, l, acc) partial; a second launch from the same entry
// point combines the partials by log-sum-exp. K/V are read once, in their
// storage dtype, and converted to f32 in registers.
#include "wave_fold.cuh"

namespace {

using wave::TILE;
using wave::TileRef;

// The paged walk of one row: tile index -> sink, local buffer or cluster.
template <typename KV> struct PagedSrc {
  const int* idx; const int* live; const int* rowb;
  const KV* sink_k; const KV* sink_v; int Ss; int sink_len;
  const KV* local_k; const KV* local_v; const int* local_pos; int Lb;
  const KV* k_store; const KV* v_store; const int* pos_store;
  int M, cap, r, hd;
  int nts, ntl, ntc;             // tiles: sink, local buffer, per cluster

  __device__ bool token(int row, int ti, int t, TileRef& tr) const {
    const int lo = rowb[2 * row], hi = rowb[2 * row + 1];
    int pos = -1;
    if (ti < nts) {                                   // sink: slot t = token t
      const int tt = ti * TILE + t;
      const size_t base = (size_t)row * Ss + ti * TILE;
      tr.k = sink_k + base * hd;
      tr.v = sink_v + base * hd;
      if (tt < Ss && tt < sink_len) pos = tt;
    } else if (ti < nts + ntl) {                      // local buffer
      const int t0 = (ti - nts) * TILE, tt = t0 + t;
      const size_t base = (size_t)row * Lb + t0;
      tr.k = local_k + base * hd;
      tr.v = local_v + base * hd;
      if (tt < Lb) pos = local_pos[(size_t)row * Lb + tt];
    } else {                                          // retrieved cluster j
      const int u = ti - nts - ntl, j = u / ntc, t0 = (u % ntc) * TILE;
      const int c = idx[row * r + j];
      tr.k = tr.v = nullptr;
      // a dead slot folds nothing; an id outside the store is never read
      if (live[row * r + j] > 0 && c >= 0 && c < M) {
        const size_t base = (size_t)row * M + c;
        tr.k = k_store + (base * cap + t0) * hd;
        tr.v = v_store + (base * cap + t0) * hd;
        if (t0 + t < cap) pos = pos_store[base * cap + t0 + t];
      }
    }
    return pos >= 0 && pos <= hi && pos > lo;
  }
};

}  // namespace

// C entry point (loaded with ctypes). Pointer arguments follow the twin's
// argument order (ref.py); ws is the f32 workspace of the split partials
// (ws_floats long, at least BH * splits * G * (hd + 2)); tps is the number of
// tiles per split (ops.py: split_plan). store_dtype: 0 = f32, 1 = bf16.
// Launches the split kernel and then the combine kernel on `stream`.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int paged_wave_attention(
    int store_dtype, const void* idx, const void* rowb, const void* live,
    const void* q, const void* sink_k, const void* sink_v,
    const void* local_k, const void* local_v, const void* local_pos,
    const void* k_store, const void* v_store, const void* pos_store,
    const void* est_logit, const void* cs, const void* vs, void* out,
    void* ws, long long ws_floats, int BH, int G, int hd, int Ss,
    int sink_len, int Lb, int M, int cap, int r, int E, int tps, float scale,
    float softcap, int use_softcap, void* stream) {
  if (BH <= 0) return 0;
  if (Ss < 0 || Lb < 0 || cap <= 0 || r < 0) return cudaErrorInvalidValue;
  const int nts = wave::cdiv(Ss, TILE), ntl = wave::cdiv(Lb, TILE);
  const int ntc = wave::cdiv(cap, TILE);
  wave::Common c;
  const cudaError_t e = wave::make_common(
      c, q, est_logit, cs, vs, out, ws, ws_floats, BH, G, hd, E,
      nts + ntl + r * ntc, tps, scale, softcap, use_softcap);
  if (e != cudaSuccess) return e;
  auto make = [&](auto tag) {
    using KV = decltype(tag);
    return PagedSrc<KV>{
        static_cast<const int*>(idx), static_cast<const int*>(live),
        static_cast<const int*>(rowb),
        static_cast<const KV*>(sink_k), static_cast<const KV*>(sink_v), Ss,
        sink_len, static_cast<const KV*>(local_k),
        static_cast<const KV*>(local_v), static_cast<const int*>(local_pos),
        Lb, static_cast<const KV*>(k_store), static_cast<const KV*>(v_store),
        static_cast<const int*>(pos_store), M, cap, r, hd, nts, ntl, ntc};
  };
  return wave::dispatch<PagedSrc>(store_dtype, G, c, make,
                                  static_cast<cudaStream_t>(stream));
}
