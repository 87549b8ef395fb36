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
// The fold itself (scores, online softmax, accumulator, estimation
// finalize, and the TPU kernel's exact masking semantics) is shared with the
// gathered-buffer kernel: wave_fold.cuh. Built without --use_fast_math.
#include "wave_fold.cuh"

namespace {

using wave::NT;
using wave::TILE;

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

template <typename T, int G>
__global__ void __launch_bounds__(NT) paged_wave_attention_kernel(Params p) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x, hd = p.hd;
  __shared__ wave::FoldSmem<G> sm;
  wave::Fold<T, G> fold(sm, p.q + (size_t)row * G * hd, hd, p.scale,
                        p.softcap, p.use_softcap);
  const int lo = p.rowb[2 * row], hi = p.rowb[2 * row + 1];

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
        sm.ok[tid] = ok;
      }
      // a tile with no valid token (empty local slots, a cluster outside
      // the window) folds nothing: skip it
      if (!wave::any_valid(sm, tid)) continue;
      fold.tile(kb + (size_t)t0 * hd, vb + (size_t)t0 * hd, tn);
    }
  }
  fold.finish(p.est_logit + (size_t)row * G * p.E, p.cs + (size_t)row * G * p.E,
              p.vs + (size_t)row * p.E * hd, p.E, p.out + (size_t)row * G * hd);
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
  if (hd <= 0 || hd > wave::HD_MAX || hd % 8 != 0 || ((hd / 8) & (hd / 8 - 1)) != 0)
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
