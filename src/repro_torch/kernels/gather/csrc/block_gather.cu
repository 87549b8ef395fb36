// Execution-buffer block gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gather/kernel.py::block_gather_pallas
// (body _copy_kernel). Plain twin: ../ref.py::block_gather_ref.
//
// What it computes: for every flattened (batch, kv-head) row and every slot
// j < r, copies the (cap, hd) K block and V block of cluster idx[row, j]
// from the (BH, M, cap, hd) stores into slot j of the contiguous
// (BH, r, cap, hd) outputs. Repeated ids copy the same block twice. The
// copy is bit-exact and dtype-blind: it moves block_bytes bytes per block.
//
// What bounds it: HBM bytes, 2 x (read + write) of BH*r*cap*hd elements and
// no arithmetic at all.
//
// What the design does about it: the TPU kernel's grid step per (row, slot),
// with the scalar-prefetched id driving the BlockSpec index map, becomes one
// 256-thread block per (row, slot) that loads its own id and streams both
// blocks with 16-byte loads and stores by consecutive threads (one 16 KB
// block at gemma2-2b's cap 32, hd 256, bf16). An id outside [0, M) writes
// zeros instead of reading out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) block_gather_kernel(
    const int* __restrict__ idx, const uint4* __restrict__ k_store,
    const uint4* __restrict__ v_store, uint4* __restrict__ k_out,
    uint4* __restrict__ v_out, int M, int r, int n16) {
  const int row = blockIdx.x / r;
  const int j = blockIdx.x % r;
  const int c = idx[(size_t)row * r + j];
  const size_t dst = ((size_t)row * r + j) * n16;
  if (c < 0 || c >= M) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < n16; i += NT) {
      k_out[dst + i] = zero;
      v_out[dst + i] = zero;
    }
    return;
  }
  const size_t src = ((size_t)row * M + c) * n16;
  for (int i = threadIdx.x; i < n16; i += NT) {
    const uint4 kx = __ldg(k_store + src + i);
    const uint4 vx = __ldg(v_store + src + i);
    k_out[dst + i] = kx;
    v_out[dst + i] = vx;
  }
}

}  // namespace

// C entry point (loaded with ctypes). block_bytes: bytes of one (cap, hd)
// block, a multiple of 16; every pointer 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int block_gather(const void* idx, const void* k_store,
                            const void* v_store, void* k_out, void* v_out,
                            int BH, int M, int r, int block_bytes,
                            void* stream) {
  if (BH <= 0 || r <= 0) return 0;
  if (M <= 0 || block_bytes <= 0 || block_bytes % 16 != 0)
    return cudaErrorInvalidValue;
  block_gather_kernel<<<BH * r, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const uint4*>(k_store),
      static_cast<const uint4*>(v_store), static_cast<uint4*>(k_out),
      static_cast<uint4*>(v_out), M, r, block_bytes / 16);
  return cudaGetLastError();
}
