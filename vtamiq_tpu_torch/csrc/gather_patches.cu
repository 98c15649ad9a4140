// Patch gather with the fused input normalization, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vtamiq_tpu/ops/gather_kernel.py::
// _vmem_gather_kernel (driven by pallas_gather_patches). For each of M
// channels-last fp32 images (H, W, C) and each of its N top-left corners
// (ti, tj), copy the P x P x C block; optionally apply (x - mean[c]) *
// inv_std[c] in fp32; store as fp32 or bf16 (round to nearest even).
// Output: (M, N, P, P, C). Corners are clamped to [0, H-P] x [0, W-P], so a
// bad corner can never read out of bounds.
//
// Bound: bytes. It reads each patch pixel once and writes it once: at the
// scorer's shapes (16 images of 384x512x3 fp32, N = 500, P = 16, bf16 out)
// at most 24.6 MB read and 12.3 MB written, about 9 us at 3.35 TB/s. The
// TPU kernel's workarounds (8-aligned row band, lane roll, fp32 upcast,
// VMEM budget) have no counterpart here.
//
// Design. A warp gathers one patch at a time, 8 warps a block, with no
// barrier across the block, so each warp's loads, staging and stores run
// as soon as its own data is there:
// - lane 0 reads the patch's corner once, clamps it and hands the source
//   offset to the warp by a shuffle;
// - the warp reads the patch lane-contiguous (a patch row is P*C contiguous
//   floats in the image and in the output; its start, j0*C floats into an
//   image row, is only 4-byte aligned), up to 768 values at a time (24
//   independent loads a lane), normalizes them in fp32 and stages them in
//   its own shared memory;
// - each lane then converts 16-byte chunks (8 bf16 or 4 fp32 values) and
//   writes each with one store, neighbouring lanes on neighbouring chunks
//   (where a patch's output is not a whole number of chunks, value by
//   value).
// P and C are template parameters: in the scorer's (16, 3) instance a patch
// is exactly one staged segment of 768 values and every index is divided by
// a constant; a generic instance takes any P and C of 1 to 4 at run time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kWarps = 8;                // a block of 8 warps, one patch each at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 768;                // values a warp stages at a time: one 16x16x3 patch

struct Norm {
  float mean[kMaxChannels];
  float inv_std[kMaxChannels];
};

// v[ch] without a dynamically indexed (local-memory) array
__device__ __forceinline__ float channel(const float (&v)[kMaxChannels], int ch) {
  return ch == 0 ? v[0] : ch == 1 ? v[1] : ch == 2 ? v[2] : v[3];
}

// 16 bytes of output from 16 / sizeof(T) staged fp32 values
__device__ __forceinline__ void store_chunk(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

// two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                                               pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// kP, kC: the patch size and channel count, or 0 for the values p_rt, c_rt
template <int kP, int kC, typename T, bool kNormalize>
__global__ void __launch_bounds__(kThreads)
gather_patches_kernel(const float* __restrict__ img, const int32_t* __restrict__ ti,
                      const int32_t* __restrict__ tj, T* __restrict__ out, int h, int w,
                      int c_rt, int n, int p_rt, long long patches, Norm norm) {
  constexpr int kVec = 16 / sizeof(T);  // output values of one 16-byte chunk
  const int p = kP ? kP : p_rt;
  const int c = kC ? kC : c_rt;
  const int row_elems = p * c;  // one patch row, contiguous in the image and the output
  const int patch_elems = p * row_elems;
  const int img_row = w * c;
  // out is 16-byte aligned, so every patch's output is when it is a whole
  // number of chunks
  const bool whole_chunks = patch_elems % kVec == 0;

  __shared__ __align__(16) float stage[kWarps][kSeg];
  const int lane = threadIdx.x & 31;
  float* st = stage[threadIdx.x >> 5];
  // with C known: a row is a whole number of pixels, so value x of a patch
  // has channel x % C, and the lane's values i * 32 + lane take the lane's
  // channels rotated by (i * 32) % C: C means and C inverse deviations in
  // registers, each picked by a constant index
  constexpr int kRot = kC > 0 ? kC : 1;
  float mean_rot[kRot], inv_rot[kRot];
#pragma unroll
  for (int j = 0; j < kRot; ++j) {
    mean_rot[j] = channel(norm.mean, (lane + j) % kRot);
    inv_rot[j] = channel(norm.inv_std, (lane + j) % kRot);
  }

  for (long long k = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       k < patches; k += static_cast<long long>(gridDim.x) * kWarps) {
    long long base = 0;  // the patch's first source value
    if (lane == 0) {
      const int i0 = min(max(ti[k], 0), h - p);
      const int j0 = min(max(tj[k], 0), w - p);
      base = (k / n * h + i0) * img_row + static_cast<long long>(j0) * c;
    }
    const float* src = img + __shfl_sync(0xffffffffu, base, 0);
    T* dst = out + k * patch_elems;

#pragma unroll
    for (int s0 = 0; s0 < patch_elems; s0 += kSeg) {  // one segment when P and C are known
      const int seg = min(kSeg, patch_elems - s0);
#pragma unroll
      for (int i = 0; i < kSeg / 32; ++i) {
        const int e = i * 32 + lane;  // within the segment
        if (e < seg) {
          const int r = (s0 + e) / row_elems;
          const int col = s0 + e - r * row_elems;  // (column, channel) within the row
          float v = src[r * img_row + col];
          if (kNormalize && kC > 0) {
            const int j = (s0 + i * 32) % kRot;
            v = (v - mean_rot[j]) * inv_rot[j];
          } else if (kNormalize) {
            const int ch = col % c;
            v = (v - channel(norm.mean, ch)) * channel(norm.inv_std, ch);
          }
          st[e] = v;
        }
      }
      __syncwarp();
      if (whole_chunks) {  // seg is then a whole number of chunks too
#pragma unroll
        for (int i = 0; i < kSeg / kVec / 32; ++i) {
          const int j = i * 32 + lane;  // the lane's chunk
          if (j * kVec < seg) store_chunk(dst + s0 + j * kVec, st + j * kVec);
        }
      } else {
        for (int e = lane; e < seg; e += 32) dst[s0 + e] = from_float<T>(st[e]);
      }
      __syncwarp();  // st is refilled next
    }
  }
}

template <int kP, int kC, typename T>
void launch_shape(int blocks, cudaStream_t stream, const float* img, const int32_t* ti,
                  const int32_t* tj, void* out, int h, int w, int c, int n, int p,
                  long long patches, bool normalize, const Norm& norm) {
  if (normalize) {
    gather_patches_kernel<kP, kC, T, true><<<blocks, kThreads, 0, stream>>>(
        img, ti, tj, static_cast<T*>(out), h, w, c, n, p, patches, norm);
  } else {
    gather_patches_kernel<kP, kC, T, false><<<blocks, kThreads, 0, stream>>>(
        img, ti, tj, static_cast<T*>(out), h, w, c, n, p, patches, norm);
  }
}

template <typename T>
void launch(const float* img, const int32_t* ti, const int32_t* tj, void* out, int m,
            int h, int w, int c, int n, int p, bool normalize, const Norm& norm,
            cudaStream_t stream) {
  const long long patches = static_cast<long long>(m) * n;
  // one patch a warp (up to 65536 blocks; the loop covers any patches past them)
  const long long need = (patches + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(need < 65536 ? need : 65536);
  if (p == 16 && c == 3) {
    launch_shape<16, 3, T>(blocks, stream, img, ti, tj, out, h, w, c, n, p, patches, normalize,
                           norm);
  } else {
    launch_shape<0, 0, T>(blocks, stream, img, ti, tj, out, h, w, c, n, p, patches, normalize,
                          norm);
  }
}

}  // namespace

// img (m, h, w, c) fp32, ti/tj (m, n) int32, out (m, n, p, p, c) fp32
// (out_bf16 = 0) or bf16 (out_bf16 = 1), all contiguous on the device, out
// 16-byte aligned. mean/inv_std: host arrays of c floats, read when
// normalize != 0. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int vtamiq_gather_patches(const void* img, const void* ti, const void* tj,
                                     void* out, int m, int h, int w, int c, int n, int p,
                                     int normalize, const float* mean,
                                     const float* inv_std, int out_bf16, void* stream) {
  if (c < 1 || c > kMaxChannels || p < 1 || h < p || w < p || m < 0 || n < 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(m) * n == 0) {
    return 0;
  }
  Norm norm = {};
  if (normalize) {
    for (int i = 0; i < c; ++i) {
      norm.mean[i] = mean[i];
      norm.inv_std[i] = inv_std[i];
    }
  }
  const float* img_f = static_cast<const float*>(img);
  const int32_t* ti_i = static_cast<const int32_t*>(ti);
  const int32_t* tj_i = static_cast<const int32_t*>(tj);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    launch<__nv_bfloat16>(img_f, ti_i, tj_i, out, m, h, w, c, n, p, normalize != 0, norm, s);
  } else {
    launch<float>(img_f, ti_i, tj_i, out, m, h, w, c, n, p, normalize != 0, norm, s);
  }
  return static_cast<int>(cudaGetLastError());
}
