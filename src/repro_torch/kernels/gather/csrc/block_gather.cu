// Execution-buffer block gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gather/kernel.py::block_gather_pallas
// (body _copy_kernel). Plain twin: ../ref.py::block_gather_ref; the
// kernel's chunking: ../ref.py::block_gather_chunked.
//
// What it computes: for every flattened (batch, kv-head) row and every slot
// j < r, copies the (cap, hd) K block and V block of cluster idx[row, j]
// from the (BH, M, cap, hd) stores into slot j of the contiguous
// (BH, r, cap, hd) outputs. Repeated ids copy the same block twice. The
// copy is bit-exact and dtype-blind: it moves block_bytes bytes per block.
//
// What bounds it: HBM bytes, 2 x (read + write) of BH*r*cap*hd elements and
// no arithmetic at all: 9.4 MB at gemma2-2b's decode shape (BH 8, r 18,
// 16 KB blocks in bf16), 2.8 us at 3.35 TB/s. So little work is bound by
// how many bytes are in flight: the card wants several MB of reads issued
// at once to cover ~1 us of HBM latency.
//
// What the design does about it: every block is cut into chunks of
// chunk_bytes (8 KB by default; the last may be shorter), and one 32-thread
// CTA moves one chunk of K or V. One elected thread loads its id, issues a
// single bulk asynchronous copy (cp.async.bulk, the TMA's non-tensor form)
// global -> shared that completes on an mbarrier, then a bulk copy shared
// -> global, and waits until the store has read shared memory. No register
// holds the data, so every CTA of the grid (576 at the shape above, all
// resident at once) has its chunk in flight from its first microsecond:
// the whole 4.7 MB of reads is issued together. A chunk whose id lies
// outside [0, M) is written as zeros by the CTA's 32 threads instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(32) block_gather_kernel(
    const int* __restrict__ idx, const uint8_t* __restrict__ k_store,
    const uint8_t* __restrict__ v_store, uint8_t* __restrict__ k_out,
    uint8_t* __restrict__ v_out, int M, int r, int block_bytes,
    int chunk_bytes, int parts) {
  extern __shared__ __align__(128) uint8_t buf[];
  __shared__ __align__(8) uint64_t bar;
  // blockIdx.x = ((row * r + j) * 2 + kv) * parts + part
  const long long b = blockIdx.x;
  const int part = (int)(b % parts);
  const int kv = (int)((b / parts) & 1);
  const long long slot = b / parts / 2;
  const long long row = slot / r;
  const int c = idx[slot];
  const long long off = (long long)part * chunk_bytes;
  const int bytes =
      (int)(block_bytes - off < chunk_bytes ? block_bytes - off : chunk_bytes);
  uint8_t* dst = (kv ? v_out : k_out) + slot * block_bytes + off;
  if (c < 0 || c >= M) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x * 16; i < bytes; i += 32 * 16)
      *reinterpret_cast<uint4*>(dst + i) = zero;
    return;
  }
  if (threadIdx.x != 0) return;
  const uint8_t* src =
      (kv ? v_store : k_store) + (row * M + c) * (long long)block_bytes + off;
  const uint32_t sb = smem_u32(buf), mb = smem_u32(&bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mb)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sb),
      "l"(src), "r"(bytes), "r"(mb)
      : "memory");
  // a wait of seconds can only be a lost copy: trap rather than hang
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mb)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 33)) __trap();
  }
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(sb), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace

// C entry point (loaded with ctypes). block_bytes: bytes of one (cap, hd)
// block; chunk_bytes: bytes one CTA moves, at most 48 KB; both multiples
// of 16, every pointer 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int block_gather(const void* idx, const void* k_store,
                            const void* v_store, void* k_out, void* v_out,
                            int BH, int M, int r, int block_bytes,
                            int chunk_bytes, void* stream) {
  if (BH <= 0 || r <= 0) return 0;
  if (M <= 0 || block_bytes <= 0 || block_bytes % 16 != 0 ||
      chunk_bytes <= 0 || chunk_bytes % 16 != 0 || chunk_bytes > 48 * 1024)
    return cudaErrorInvalidValue;
  const int parts = (block_bytes + chunk_bytes - 1) / chunk_bytes;
  const long long grid = (long long)BH * r * 2 * parts;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = chunk_bytes < block_bytes ? chunk_bytes : block_bytes;
  block_gather_kernel<<<(unsigned)grid, 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const uint8_t*>(k_store),
      static_cast<const uint8_t*>(v_store), static_cast<uint8_t*>(k_out),
      static_cast<uint8_t*>(v_out), M, r, block_bytes, chunk_bytes, parts);
  return cudaGetLastError();
}
