// Helpers shared by the flash-attention sources: tensor views, the checks
// of their C entry points, and asynchronous copies into shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct View {  // element strides of a (B, H, S, D) tensor with unit D stride
  long long sb, sh, ss;
};

// view i of a C array of (batch, head, token) stride triples
View view_at(const long long* strides, int i) {
  return View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// the kernels take D = 64 and S a multiple of their 64-token tile
bool shapes_ok(int B, int H, int S, int D) {
  return B > 0 && H > 0 && S > 0 && D == 64 && S % 64 == 0 && B <= 65535 && H <= 65535;
}

// the (B, S) mask and the (B, H, S) lse and delta, copied in 16-byte chunks
bool vectors_aligned(const void* mask, const void* lse, const void* delta) {
  return reinterpret_cast<uintptr_t>(mask) % 16 == 0 && reinterpret_cast<uintptr_t>(lse) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(delta) % 16 == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bytes [0, nbytes) of src into dst, 16 per thread, by threads first..first+nbytes/16-1
__device__ __forceinline__ void copy_bytes(void* dst, const void* src, int nbytes, int first) {
  const int c = static_cast<int>(threadIdx.x) - first;
  if (c >= 0 && 16 * c < nbytes) {
    cp_async16(static_cast<char*>(dst) + 16 * c, static_cast<const char*>(src) + 16 * c, true);
  }
}

template <int kA, int kB> __device__ __forceinline__ void zero(float (&c)[kA][kB][4]) {
#pragma unroll
  for (int m = 0; m < kA; ++m)
#pragma unroll
    for (int j = 0; j < kB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][j][e] = 0.0f;
}

}  // namespace
