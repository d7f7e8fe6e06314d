// Shared helpers of the port's CUDA kernels: dtype conversions, the error
// string export and the launch-status convention.
//
// Every C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() right after the launch, so a refused launch
// (too many threads, too much shared memory, bad arguments) reaches the
// Python wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vstab {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int clamp_i(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

__device__ __forceinline__ float clamp_f(float x, float d) {
  return fminf(fmaxf(x, -d), d);
}

// Out-of-range tap index fix: mode 0 clamps to the edge, mode 1 wraps.
// CUDA's % truncates toward zero, so the wrap adds n back for negatives.
__device__ __forceinline__ int fix_index(int i, int n, int mode) {
  return mode ? ((i % n) + n) % n : clamp_i(i, 0, n - 1);
}

// Asynchronous copies from device memory into shared memory (cp.async): the
// data bypasses the registers, and the issuing thread goes on. A thread's
// copies are complete after cp_async_wait_all() in that thread, and visible
// to the block after the next __syncthreads(). Both addresses must be
// aligned to the copy's size.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline int launch_status() { return (int)cudaGetLastError(); }

// Kernels that ask for more than 48 KB of dynamic shared memory must be
// allowed to first; returns the CUDA error code (0 on success).
template <typename K>
inline int allow_dynamic_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace vstab

// dtype codes shared with the Python wrappers.
#define VSTAB_F32 0
#define VSTAB_BF16 1

extern "C" const char* vstab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
