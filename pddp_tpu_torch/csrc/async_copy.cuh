// The horizon ring of the latency-chain kernels K1 (backward_kernel.cu) and
// K2 stages (a)-(c) (fused_rollout.cu): each warp stages its solve's
// per-step inputs in shared memory, kStages chunks of steps deep, with
// cp.async, so that no step waits on device memory.
//
// A chunk is a few steps of each input array, contiguous in the (B, N, ...)
// layout. Its copies go element by element (4 or 8 bytes): the slices of a
// (B, N, nz, nu) array at nu = 1 or nz = 5 are not 16-byte aligned, which
// cp.async.bulk and 16-byte cp.async need, and an element copy may land
// anywhere in shared memory, so a kernel can stage a step in the layout it
// computes on. Each chunk is one commit group; a warp waits for the oldest
// with cp.async.wait_group and then __syncwarp, which orders the other
// lanes' copies before its reads.
//
// A launch's plan (plan()) takes up to kMaxSolvesPerBlock warps a block,
// one per SM sub-partition, so the warps of a block never wait on each
// other for issue slots, and chunks of up to kMaxChunk steps: with two
// chunks in flight, 32 steps of cover (a few microseconds) against the
// latency of device memory. It keeps the most warps, then the longest
// chunk, that fit the shared memory of a block,
//   round16(block_elems) + warps * round16(warp_elems(chunk))
// bytes in elements of the kernel's type; the last block may be ragged.

#pragma once

#include <cuda_runtime.h>

namespace pddp {

constexpr int kStages = 3;             // chunks in the ring
constexpr int kMaxChunk = 16;          // steps a chunk at most
constexpr int kMaxSmem = 232448;       // bytes a block may use on an H100
constexpr int kMaxSolvesPerBlock = 4;  // warps a block, one per SM quarter

__host__ __device__ constexpr long round16(long nbytes) {
  return (nbytes + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ constexpr long smem_bytes(long block_elems,
                                              long warp_elems, int solves) {
  return round16(block_elems * long(sizeof(T))) +
         solves * round16(warp_elems * long(sizeof(T)));
}

struct Plan {
  int warps, chunk;  // warps a block, steps a chunk
  long bytes;        // dynamic shared memory of a block
};

// The launch of `warps` warps of n steps each; warp_elems(chunk) is one
// warp's elements. bytes > kMaxSmem: not even one step of one warp fits.
template <typename T, class WarpElems>
__host__ Plan plan(long warps, int n, long block_elems,
                   WarpElems warp_elems) {
  const auto bytes = [&](int w, int c) {
    return smem_bytes<T>(block_elems, warp_elems(c), w);
  };
  int w = warps < kMaxSolvesPerBlock ? int(warps) : kMaxSolvesPerBlock;
  int c = n < kMaxChunk ? n : kMaxChunk;
  while (w > 1 && bytes(w, c) > kMaxSmem) --w;
  while (c > 1 && bytes(w, c) > kMaxSmem) --c;
  return {w, c, bytes(w, c)};
}

// Asynchronous copy of one element from device to shared memory.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kStages - 1 of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Stages n steps of a per-step ROWS x COLS block (contiguous at src, step
// after step) into dst, step j at dst + j * step, row r at + r * ld.
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int step, int ld,
                                           const T* src, int n, int lane) {
  constexpr int per = ROWS * COLS;
  for (int e = lane; e < n * per; e += 32) {
    const int j = e / per, q = e - j * per;
    const int r = q / COLS, c = q - r * COLS;
    cp_async(dst + j * step + r * ld + c, src + e);
  }
}

// Shared memory above the default 48 KB needs the kernel's opt-in; the
// caller keeps, per kernel instance, how much it has allowed so far.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, long bytes,
                                       long& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace pddp
