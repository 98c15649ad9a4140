// Flash attention's forward in fp32 for Hopper (sm_90a).
//
// Replaces, for fp32 inputs, the Pallas TPU kernel of vtamiq_tpu/ops/attention.py:
//   flash_fwd_kernel  <- _flash_fwd_kernel (_flash_forward)
// bf16 inputs take flash_attention_sm90.cu; the fp32 backward is
// flash_attention_tf32x3.cu.
//
// What it computes, per (batch row b, head h), over S tokens of head
// dimension D = 64, with a (B, S) key-validity mask and scale = 1/sqrt(D):
//   logits = (q k^T) * scale, invalid keys set to NEG_INF = -1e30
//   out = softmax(logits) v, lse = logsumexp(logits) (fp32)
// NEG_INF is finite, so a key block with no valid key gives exp(0) terms
// that the next valid block's correction factor exp(-1e30 - m) wipes out,
// never 0 * inf = NaN; l is clamped at 1e-30.
//
// Bound: operations. At the 5000-patch shapes (16 rows, 12 heads, S = 5056
// after padding to the 64-token tile, D = 64) the forward does 2 matmuls of
// 2*S*S*D flops per row and head (1.26 TFLOP) and S*S exps, against
// 0.12 GB of inputs and outputs: far right of the H100's ridge point.
//
// Design (the simple one; flash_attention_sm90.cu has the register-resident
// bf16 forward): one CTA of 4 warps per (64-row query block, head, batch
// row), looping over the 64-row key blocks. Tiles sit in shared memory; warp
// w owns rows 16w..16w+15 of every 64x64 product. Products run on the CUDA
// cores (one FMA chain per output, in order), so fp32 inputs keep fp32
// precision. The online-softmax state m, l and the fp32 accumulator live in
// shared memory. The TPU grid's sequential axis (scratch carried across grid
// steps) becomes the loop inside the CTA.
//
// Tensors are (B, H, S, D) views with any batch, head and token strides and
// a contiguous D axis, so the model's (B, S, H, D) projections pass without
// a transpose copy. S must be a multiple of 64 (the caller pads and masks
// the tail); D must be 64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kD = 64;          // head dimension
constexpr int kBlk = 64;        // query and key block (rows of every tile)
constexpr int kThreads = 128;   // 4 warps; warp w owns tile rows 16w..16w+15
constexpr int kST = kD + 1;     // input tile row stride (floats): a warp reading a
                                // column hits 32 banks
constexpr int kSF = kBlk + 4;   // accumulator tile row stride (floats)
constexpr float kNegInf = -1e30f;
constexpr float kMinL = 1e-30f;

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
// (kBRow) or B[j*ldb + k]; C is fp32 with row stride kSF. Lane l computes
// columns l and l + 32 of the warp's 16 rows.
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void load_tile(float* dst, const float* src, const View& v, int b,
                                          int h, int row0) {
  const float* base = src + b * v.sb + h * v.sh + static_cast<long long>(row0) * v.ss;
  for (int e = threadIdx.x; e < kBlk * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    dst[r * kST + c] = base[static_cast<long long>(r) * v.ss + c];
  }
}

__device__ __forceinline__ void store_tile(float* dst, const View& v, int b, int h, int row0,
                                           const float* src, const float* row_div) {
  float* base = dst + b * v.sb + h * v.sh + static_cast<long long>(row0) * v.ss;
  for (int e = threadIdx.x; e < kBlk * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    float x = src[r * kSF + c];
    if (row_div != nullptr) x = x / row_div[r];
    base[static_cast<long long>(r) * v.ss + c] = x;
  }
}

__device__ __forceinline__ void load_mask(float* dst, const uint8_t* mask, int b, int S, int row0) {
  for (int i = threadIdx.x; i < kBlk; i += kThreads) {
    dst[i] = mask[static_cast<long long>(b) * S + row0 + i] != 0 ? 1.0f : 0.0f;
  }
}

constexpr size_t tile_bytes() { return round_up(static_cast<size_t>(kBlk) * kST * sizeof(float)); }
constexpr size_t ftile_bytes() { return round_up(static_cast<size_t>(kBlk) * kSF * sizeof(float)); }
constexpr size_t vec_bytes() { return round_up(kBlk * sizeof(float)); }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr size_t kFwdSmem = 4 * tile_bytes() + 2 * ftile_bytes() + 3 * vec_bytes();

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, View vq, View vk, View vv,
                 View vo, int H, int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* sQ = cv.take<float>(kBlk * kST);
  float* sK = cv.take<float>(kBlk * kST);
  float* sV = cv.take<float>(kBlk * kST);
  float* sP = cv.take<float>(kBlk * kST);
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
    mm_strip<true, false>(sQ, kST, sK, kST, sS, false);  // S = Q K^T
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
      sP[r * kST + lane] = p0;
      sP[r * kST + lane + 32] = p1;
      sAcc[r * kSF + lane] *= corr;
      sAcc[r * kSF + lane + 32] *= corr;
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * corr + psum;
        sM[r] = m_new;
      }
    }
    __syncwarp();
    mm_strip<true, true>(sP, kST, sV, kST, sAcc, true);  // acc += P V
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

}  // namespace

// All tensors live on the device. q, k, v and out are fp32 (B, H, S, D)
// views given by their element strides (batch, head, token; the D axis
// contiguous); mask is (B, S) bytes (0 = invalid key); lse is (B, H, S)
// contiguous fp32. S % 64 == 0 and D == 64. strides: q, k, v, out (12
// values). Returns cudaGetLastError() after the launch (0 = success).
extern "C" int vtamiq_flash_fwd_f32(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* lse,
                                    const long long* strides, int B, int H, int S, int D,
                                    void* stream) {
  if (!shapes_ok(B, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(flash_fwd_kernel, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kBlk, H, B);
  flash_fwd_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(lse),
      view_at(strides, 0), view_at(strides, 1), view_at(strides, 2), view_at(strides, 3), H, S,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}
