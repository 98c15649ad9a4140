// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vtamiq_tpu/ops/attention.py:
//   flash_fwd_kernel       <- _flash_fwd_kernel       (driven by _flash_forward)
//   flash_bwd_kernel<kFused> <- _flash_bwd_fused_kernel (_flash_backward_fused)
//   flash_bwd_kernel<kDQ>  <- _flash_bwd_dq_kernel    (_flash_backward, fused=False)
//   flash_bwd_kernel<kDKV> <- _flash_bwd_dkv_kernel   (_flash_backward, fused=False)
//
// What they compute, per (batch row b, head h), over S tokens of head
// dimension D = 64, with a (B, S) key-validity mask and scale = 1/sqrt(D):
//   logits = (q k^T) * scale, invalid keys set to NEG_INF = -1e30
//   forward:  out = softmax(logits) v, lse = logsumexp(logits) (fp32)
//   backward: p = exp(logits - lse), dp = do v^T,
//             ds = p * (dp - delta) * scale   (delta = sum_d do*out, given)
//             dq = ds k, dk = ds^T q, dv = p^T do
// Inputs are bf16 or fp32; every product accumulates in fp32. The rounding
// points follow the TPU kernels: p is cast to the input dtype before the
// p v and p^T do products, ds before the ds k and ds^T q products, and the
// scale multiplies the fp32 dot. NEG_INF is finite, so a key block with no
// valid key gives exp(0) terms that the next valid block's correction
// factor exp(-1e30 - m) wipes out, never 0 * inf = NaN; l is clamped at 1e-30.
//
// Bound: operations. At the 5000-patch shapes (16 rows, 12 heads, S = 5056
// after padding to the 64-token tile, D = 64) the forward does 2 matmuls of
// 2*S*S*D flops per row and head (1.26 TFLOP) and S*S exps, against
// 0.12 GB of inputs and outputs: far right of the H100's ridge point.
//
// Design (the simple one; wgmma, TMA and warp specialization are later
// work): one CTA of 4 warps per (64-row block, head, batch row), looping
// over the other axis's 64-row blocks. Tiles sit in shared memory; warp w
// owns rows 16w..16w+15 of every 64x64 product. bf16 products run on the
// tensor cores through nvcuda::wmma (16x16x16, fp32 accumulate); fp32
// products run on the CUDA cores (one FMA chain per output, in order), so
// fp32 inputs keep fp32 precision. The online-softmax state m, l and the
// fp32 accumulators live in shared memory. The TPU grid's sequential axis
// (scratch carried across grid steps) becomes the loop inside the CTA.
//
// dq in the fused backward: a CTA owns one key block and walks every query
// block, so a query block's dq collects contributions from all key-block
// CTAs. The TPU kernel writes one fp32 partial per key block and sums them
// afterwards; at a 64-token key block that would be (nk, B, H, S, D) fp32,
// 20 GB at the 5000-patch shapes. Here each CTA adds its fp32 partial into
// one (B, H, S, D) fp32 buffer with atomicAdd (as FlashAttention-2 does);
// the caller zeroes it first and casts it afterwards. CTAs start their
// query walk at their own key-block index, so CTAs running at the same
// time add into different query blocks. The summation order varies from
// run to run.
//
// Tensors are (B, H, S, D) views with any batch, head and token strides and
// a contiguous D axis, so the model's (B, S, H, D) projections pass without
// a transpose copy. S must be a multiple of 64 (the caller pads and masks
// the tail); D must be 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kD = 64;          // head dimension
constexpr int kBlk = 64;        // query and key block (rows of every tile)
constexpr int kThreads = 128;   // 4 warps; warp w owns tile rows 16w..16w+15
constexpr int kSF = kBlk + 4;   // fp32 tile row stride (floats): wmma wants a multiple of 4
constexpr float kNegInf = -1e30f;
constexpr float kMinL = 1e-30f;

// row stride (elements) of an input-dtype tile: a multiple of 8 for wmma
// (bf16); 65 for fp32, so a warp reading a column hits 32 banks
template <typename T> struct TileStride;
template <> struct TileStride<__nv_bfloat16> { static constexpr int kValue = kD + 8; };
template <> struct TileStride<float> { static constexpr int kValue = kD + 1; };

struct View {  // element strides of a (B, H, S, D) tensor with unit D stride
  long long sb, sh, ss;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t round_up(size_t bytes) { return (bytes + 127) / 128 * 128; }

// carves 128-byte aligned arrays out of dynamic shared memory
struct Carver {
  unsigned char* p;
  template <typename U> __device__ U* take(int count) {
    U* r = reinterpret_cast<U*>(p);
    p += round_up(static_cast<size_t>(count) * sizeof(U));
    return r;
  }
};

// ---------------------------------------------------------------------------
// one warp's strip of a 64x64x64 product: C[16w.., :] (+)= A[16w.., :] B
// A(i, k) is A[i*lda + k] (kARow) or A[k*lda + i]; B(k, j) is B[k*ldb + j]
// (kBRow) or B[j*ldb + k]; C is fp32 with row stride kSF.
// ---------------------------------------------------------------------------

template <bool kARow, bool kBRow>
__device__ __forceinline__ void mm_strip(const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb,
                                         float* C, bool accumulate) {
  using ALayout = typename std::conditional<kARow, wmma::row_major, wmma::col_major>::type;
  using BLayout = typename std::conditional<kBRow, wmma::row_major, wmma::col_major>::type;
  const int w = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (accumulate) {
      wmma::load_matrix_sync(acc[j], C + 16 * w * kSF + 16 * j, kSF, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc[j], 0.0f);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a;
    const __nv_bfloat16* ap = kARow ? A + 16 * w * lda + 16 * kk : A + 16 * kk * lda + 16 * w;
    wmma::load_matrix_sync(a, ap, lda);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
      const __nv_bfloat16* bp = kBRow ? B + 16 * kk * ldb + 16 * j : B + 16 * j * ldb + 16 * kk;
      wmma::load_matrix_sync(bf, bp, ldb);
      wmma::mma_sync(acc[j], a, bf, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(C + 16 * w * kSF + 16 * j, acc[j], kSF, wmma::mem_row_major);
  }
}

// fp32: lane l computes columns l and l + 32 of the warp's 16 rows
template <bool kARow, bool kBRow>
__device__ __forceinline__ void mm_strip(const float* A, int lda, const float* B, int ldb,
                                         float* C, bool accumulate) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float c0[16], c1[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * w + i;
    c0[i] = accumulate ? C[r * kSF + lane] : 0.0f;
    c1[i] = accumulate ? C[r * kSF + lane + 32] : 0.0f;
  }
  for (int k = 0; k < kBlk; ++k) {
    const float b0 = kBRow ? B[k * ldb + lane] : B[lane * ldb + k];
    const float b1 = kBRow ? B[k * ldb + lane + 32] : B[(lane + 32) * ldb + k];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = 16 * w + i;
      const float a = kARow ? A[r * lda + k] : A[k * lda + r];
      c0[i] = fmaf(a, b0, c0[i]);
      c1[i] = fmaf(a, b1, c1[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * w + i;
    C[r * kSF + lane] = c0[i];
    C[r * kSF + lane + 32] = c1[i];
  }
}

// ---------------------------------------------------------------------------
// tile loads and stores (64 rows of D = 64 contiguous elements)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, const View& v, int b, int h,
                                          int row0) {
  constexpr int ST = TileStride<T>::kValue;
  const T* base = src + b * v.sb + h * v.sh + static_cast<long long>(row0) * v.ss;
  for (int e = threadIdx.x; e < kBlk * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    dst[r * ST + c] = base[static_cast<long long>(r) * v.ss + c];
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const View& v, int b, int h, int row0,
                                           const float* src, const float* row_div) {
  T* base = dst + b * v.sb + h * v.sh + static_cast<long long>(row0) * v.ss;
  for (int e = threadIdx.x; e < kBlk * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    float x = src[r * kSF + c];
    if (row_div != nullptr) x = x / row_div[r];
    base[static_cast<long long>(r) * v.ss + c] = from_f<T>(x);
  }
}

__device__ __forceinline__ void load_vec(float* dst, const float* src, int b, int h, int H, int S,
                                         int row0) {
  for (int i = threadIdx.x; i < kBlk; i += kThreads) {
    dst[i] = src[(static_cast<long long>(b) * H + h) * S + row0 + i];
  }
}

__device__ __forceinline__ void load_mask(float* dst, const uint8_t* mask, int b, int S, int row0) {
  for (int i = threadIdx.x; i < kBlk; i += kThreads) {
    dst[i] = mask[static_cast<long long>(b) * S + row0 + i] != 0 ? 1.0f : 0.0f;
  }
}

template <typename T> constexpr size_t tile_bytes() {
  return round_up(static_cast<size_t>(kBlk) * TileStride<T>::kValue * sizeof(T));
}
constexpr size_t ftile_bytes() { return round_up(static_cast<size_t>(kBlk) * kSF * sizeof(float)); }
constexpr size_t vec_bytes() { return round_up(kBlk * sizeof(float)); }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T> constexpr size_t fwd_smem_bytes() {
  return 4 * tile_bytes<T>() + 2 * ftile_bytes() + 3 * vec_bytes();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
                 View vq, View vk, View vv, View vo, int H, int S, float scale) {
  constexpr int ST = TileStride<T>::kValue;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* sQ = cv.take<T>(kBlk * ST);
  T* sK = cv.take<T>(kBlk * ST);
  T* sV = cv.take<T>(kBlk * ST);
  T* sP = cv.take<T>(kBlk * ST);
  float* sS = cv.take<float>(kBlk * kSF);
  float* sAcc = cv.take<float>(kBlk * kSF);
  float* sM = cv.take<float>(kBlk);
  float* sL = cv.take<float>(kBlk);
  float* sMask = cv.take<float>(kBlk);

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = S / kBlk;

  load_tile(sQ, q, vq, b, h, qb * kBlk);
  for (int e = threadIdx.x; e < kBlk * kSF; e += kThreads) sAcc[e] = 0.0f;
  for (int i = threadIdx.x; i < kBlk; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.0f;
  }

  for (int kb = 0; kb < nk; ++kb) {
    __syncthreads();  // the previous block's K, V and P are no longer read
    load_tile(sK, k, vk, b, h, kb * kBlk);
    load_tile(sV, v, vv, b, h, kb * kBlk);
    load_mask(sMask, mask, b, S, kb * kBlk);
    __syncthreads();
    mm_strip<true, false>(sQ, ST, sK, ST, sS, false);  // S = Q K^T
    __syncwarp();
    for (int i = 0; i < 16; ++i) {  // online softmax over the warp's rows
      const int r = 16 * w + i;
      float s0 = sMask[lane] != 0.0f ? __fmul_rn(sS[r * kSF + lane], scale) : kNegInf;
      float s1 = sMask[lane + 32] != 0.0f ? __fmul_rn(sS[r * kSF + lane + 32], scale) : kNegInf;
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p0 + p1);
      sP[r * ST + lane] = from_f<T>(p0);
      sP[r * ST + lane + 32] = from_f<T>(p1);
      sAcc[r * kSF + lane] *= corr;
      sAcc[r * kSF + lane + 32] *= corr;
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * corr + psum;
        sM[r] = m_new;
      }
    }
    __syncwarp();
    mm_strip<true, true>(sP, ST, sV, ST, sAcc, true);  // acc += P V
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlk; i += kThreads) {
    const float l = fmaxf(sL[i], kMinL);
    sL[i] = l;
    lse[(static_cast<long long>(b) * H + h) * S + qb * kBlk + i] = sM[i] + logf(l);
  }
  __syncthreads();
  store_tile(out, vo, b, h, qb * kBlk, sAcc, sL);
}

// ---------------------------------------------------------------------------
// backward: one kernel body, three arrangements
//   kFused: CTA per key block, walks query blocks; dk, dv in shared memory,
//           dq partials added atomically into an fp32 buffer (5 products)
//   kDKV:   the same walk without dq (4 products)
//   kDQ:    CTA per query block, walks key blocks; dq in shared memory
//           (3 products: logits, dp, ds k)
// ---------------------------------------------------------------------------

enum BwdMode { kFused = 0, kDQ = 1, kDKV = 2 };

template <typename T> constexpr size_t bwd_smem_bytes() {
  return 6 * tile_bytes<T>() + 4 * ftile_bytes() + 3 * vec_bytes();
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                 T* __restrict__ dq, float* __restrict__ dq_acc, T* __restrict__ dk,
                 T* __restrict__ dv, View vq, View vk, View vv, View vdo, View vdq, View vdk,
                 View vdv, int H, int S, float scale) {
  constexpr int ST = TileStride<T>::kValue;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* sQ = cv.take<T>(kBlk * ST);
  T* sK = cv.take<T>(kBlk * ST);
  T* sV = cv.take<T>(kBlk * ST);
  T* sDO = cv.take<T>(kBlk * ST);
  T* sP = cv.take<T>(kBlk * ST);    // p in the input dtype
  T* sDS = cv.take<T>(kBlk * ST);   // ds in the input dtype
  float* sS = cv.take<float>(kBlk * kSF);    // raw logits q k^T
  float* sDP = cv.take<float>(kBlk * kSF);   // dp = do v^T, then the dq partial
  float* sAccA = cv.take<float>(kBlk * kSF); // dk (kFused, kDKV) or dq (kDQ)
  float* sAccB = cv.take<float>(kBlk * kSF); // dv
  float* sLse = cv.take<float>(kBlk);
  float* sDelta = cv.take<float>(kBlk);
  float* sMask = cv.take<float>(kBlk);

  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = S / kBlk;

  for (int e = threadIdx.x; e < kBlk * kSF; e += kThreads) {
    sAccA[e] = 0.0f;
    sAccB[e] = 0.0f;
  }
  if (kMode == kDQ) {
    load_tile(sQ, q, vq, b, h, blk * kBlk);
    load_tile(sDO, dout, vdo, b, h, blk * kBlk);
    load_vec(sLse, lse, b, h, H, S, blk * kBlk);
    load_vec(sDelta, delta, b, h, H, S, blk * kBlk);
  } else {
    load_tile(sK, k, vk, b, h, blk * kBlk);
    load_tile(sV, v, vv, b, h, blk * kBlk);
    load_mask(sMask, mask, b, S, blk * kBlk);
  }

  for (int it = 0; it < nb; ++it) {
    const int other = (blk + it) % nb;  // start at the own index: spreads the dq atomics
    const int q0 = (kMode == kDQ ? blk : other) * kBlk;
    __syncthreads();  // the previous step's tiles are no longer read
    if (kMode == kDQ) {
      load_tile(sK, k, vk, b, h, other * kBlk);
      load_tile(sV, v, vv, b, h, other * kBlk);
      load_mask(sMask, mask, b, S, other * kBlk);
    } else {
      load_tile(sQ, q, vq, b, h, q0);
      load_tile(sDO, dout, vdo, b, h, q0);
      load_vec(sLse, lse, b, h, H, S, q0);
      load_vec(sDelta, delta, b, h, H, S, q0);
    }
    __syncthreads();
    mm_strip<true, false>(sQ, ST, sK, ST, sS, false);    // logits = Q K^T
    mm_strip<true, false>(sDO, ST, sV, ST, sDP, false);  // dP = dO V^T
    __syncwarp();
    for (int i = 0; i < 16; ++i) {  // p and ds over the warp's query rows
      const int r = 16 * w + i;
      const float l_se = sLse[r], dl = sDelta[r];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float logit = sMask[c] != 0.0f ? __fmul_rn(sS[r * kSF + c], scale) : kNegInf;
        const float p = expf(logit - l_se);
        const float ds = p * (sDP[r * kSF + c] - dl) * scale;
        sP[r * ST + c] = from_f<T>(p);
        sDS[r * ST + c] = from_f<T>(ds);
      }
    }
    __syncthreads();  // the k-row products below read every query row
    if (kMode != kDQ) {
      mm_strip<false, true>(sP, ST, sDO, ST, sAccB, true);   // dV += P^T dO
      mm_strip<false, true>(sDS, ST, sQ, ST, sAccA, true);   // dK += dS^T Q
    }
    if (kMode == kDQ) {
      mm_strip<true, true>(sDS, ST, sK, ST, sAccA, true);    // dQ += dS K
    } else if (kMode == kFused) {
      mm_strip<true, true>(sDS, ST, sK, ST, sDP, false);     // dQ partial = dS K
      __syncwarp();
      float* dst = dq_acc + b * vdq.sb + h * vdq.sh + static_cast<long long>(q0) * vdq.ss;
      for (int i = 0; i < 16; ++i) {
        const int r = 16 * w + i;
        atomicAdd(dst + static_cast<long long>(r) * vdq.ss + lane, sDP[r * kSF + lane]);
        atomicAdd(dst + static_cast<long long>(r) * vdq.ss + lane + 32, sDP[r * kSF + lane + 32]);
      }
    }
  }
  __syncthreads();
  if (kMode == kDQ) {
    store_tile(dq, vdq, b, h, blk * kBlk, sAccA, nullptr);
  } else {
    store_tile(dk, vdk, b, h, blk * kBlk, sAccA, nullptr);
    store_tile(dv, vdv, b, h, blk * kBlk, sAccB, nullptr);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

View view_at(const long long* strides, int i) {
  return View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

bool shapes_ok(int B, int H, int S, int D) {
  return B > 0 && H > 0 && S > 0 && D == kD && S % kBlk == 0 && B <= 65535 && H <= 65535;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
               void* lse, const long long* strides, int B, int H, int S, float scale,
               cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kBlk, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(lse),
      view_at(strides, 0), view_at(strides, 1), view_at(strides, 2), view_at(strides, 3),
      H, S, scale);
  return static_cast<int>(cudaGetLastError());
}

// strides: q, k, v, do, dq (or dq_acc), dk, dv; pointers of unused outputs may be null
template <typename T, int kMode>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* mask, void* dq, void* dk, void* dv,
               const long long* strides, int B, int H, int S, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kBlk, H, B);
  flash_bwd_kernel<T, kMode><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      kMode == kDQ ? static_cast<T*>(dq) : nullptr,
      kMode == kFused ? static_cast<float*>(dq) : nullptr,
      static_cast<T*>(dk), static_cast<T*>(dv),
      view_at(strides, 0), view_at(strides, 1), view_at(strides, 2), view_at(strides, 3),
      view_at(strides, 4), view_at(strides, 5), view_at(strides, 6), H, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int bwd_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* mask, void* dq, void* dk, void* dv,
              const long long* strides, int B, int H, int S, int D, int is_bf16,
              void* stream) {
  if (!shapes_ok(B, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_bwd<__nv_bfloat16, kMode>(q, k, v, dout, lse, delta, mask, dq, dk, dv,
                                            strides, B, H, S, scale, s);
  }
  return launch_bwd<float, kMode>(q, k, v, dout, lse, delta, mask, dq, dk, dv, strides, B, H,
                                  S, scale, s);
}

}  // namespace

// All tensors live on the device. q, k, v, do and the outputs are (B, H, S, D)
// views given by their element strides (batch, head, token; the D axis is
// contiguous), bf16 (is_bf16 = 1) or fp32; mask is (B, S) bytes (0 =
// invalid key); lse and delta are (B, H, S) contiguous fp32. S % 64 == 0 and
// D == 64. Each returns cudaGetLastError() after its launch (0 = success).

// strides: q, k, v, out (12 values)
extern "C" int vtamiq_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                                void* out, void* lse, const long long* strides, int B, int H,
                                int S, int D, int is_bf16, void* stream) {
  if (!shapes_ok(B, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_fwd<__nv_bfloat16>(q, k, v, mask, out, lse, strides, B, H, S, scale, s);
  }
  return launch_fwd<float>(q, k, v, mask, out, lse, strides, B, H, S, scale, s);
}

// dq_acc: fp32 (B, H, S, D), zeroed by the caller; dq partials are added
// into it. strides: q, k, v, do, dq_acc, dk, dv (21 values)
extern "C" int vtamiq_flash_bwd_fused(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* mask, void* dq_acc, void* dk, void* dv,
                                      const long long* strides, int B, int H, int S, int D,
                                      int is_bf16, void* stream) {
  return bwd_entry<kFused>(q, k, v, dout, lse, delta, mask, dq_acc, dk, dv, strides, B, H, S,
                           D, is_bf16, stream);
}

// strides: q, k, v, do, dq, (unused), (unused) (21 values)
extern "C" int vtamiq_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* mask, void* dq, const long long* strides, int B,
                                   int H, int S, int D, int is_bf16, void* stream) {
  return bwd_entry<kDQ>(q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr, strides, B, H,
                        S, D, is_bf16, stream);
}

// strides: q, k, v, do, (unused), dk, dv (21 values)
extern "C" int vtamiq_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* mask, void* dk, void* dv,
                                    const long long* strides, int B, int H, int S, int D,
                                    int is_bf16, void* stream) {
  return bwd_entry<kDKV>(q, k, v, dout, lse, delta, mask, nullptr, dk, dv, strides, B, H, S,
                         D, is_bf16, stream);
}
