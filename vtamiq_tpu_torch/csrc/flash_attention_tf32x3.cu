// Flash attention in fp32 for Hopper (sm_90a): fp32-accurate products on the
// tensor cores as 3xTF32, on register-resident mma.sync tiles.
//
// Replaces, for fp32 inputs, the Pallas TPU kernels of vtamiq_tpu/ops/attention.py:
//   flash_fwd_tf32x3      <- _flash_fwd_kernel (_flash_forward)
//   flash_bwd_dq_tf32x3   <- _flash_bwd_dq_kernel (_flash_backward, fused=False)
//   flash_bwd_dkv_tf32x3  <- _flash_bwd_dkv_kernel (_flash_backward, fused=False)
//   both, one after the other
//                         <- _flash_bwd_fused_kernel (_flash_backward_fused)
// bf16 inputs take flash_attention_sm90.cu, whose kernels have the same roles.
//
// The function, per (batch row, head), over S tokens of D = 64 with a (B, S)
// key-validity mask and scale = 1/sqrt(D):
//   logit = fl(q . k) * scale, invalid keys at NEG_INF = -1e30
//   forward: out = softmax(logit) v, lse = logsumexp(logit), with an online
//     softmax (running maximum m, running sum l clamped at 1e-30 at the end)
//   backward, given lse and delta:
//     p = exp(logit - lse), dp = do v^T, ds = p (dp - delta) scale
//     dq = ds k, dk = ds^T q, dv = p^T do
// p and ds stay fp32 (no rounding to a storage type), as in the Pallas
// kernels and the plain versions for fp32. NEG_INF is finite: a key tile
// with no valid key gives exp(0) terms that the next valid tile's correction
// exp(-1e30 - m) wipes out, never 0 * inf = NaN; in the backward masked keys
// get p = 0 exactly, so no gradient.
//
// Bound: operations. At the 5000-patch shapes (16 rows, 12 heads, 5009 valid
// of S = 5056, D = 64) the forward is 2 products, 1.23 TFLOP, dq 3, 1.85
// TFLOP, and dk/dv 4, 2.47 TFLOP, against 0.1 to 0.2 GB of inputs and
// outputs. fp32 FMAs on the CUDA cores peak at 67 TFLOP/s; 3xTF32 on the
// tensor cores at a third of the 495 TFLOP/s TF32 rate, about 165.
//
// Design:
// - Products are mma.sync.m16n8k8 (tf32 in, fp32 accumulate). Each fp32
//   operand element x is split in registers into big = tf32_rna(x) and
//   small = tf32_rna(x - big), and each product is big.big + big.small +
//   small.big (the small.small term, about 2^-22 of the product, is
//   dropped): fp32 accuracy at a third of the TF32 rate.
// - Forward and dq: a CTA owns 128 query rows (Q, and dO for dq, resident
//   in shared memory) and streams 32-key tiles of K, V and the mask. The
//   forward takes S = Q K^T for the whole tile, the online softmax in
//   registers (row maxima over the quad's 4 lanes by shuffles; each lane
//   sums p over its own columns, and the quad's sums are added at the end),
//   then O += P V. dq: S = Q K^T, dP = dO V^T, dQ += dS K. dk/dv: a CTA
//   owns 128 keys (K, V resident) and streams 32-query tiles of Q, dO, lse
//   and delta: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, so
//   P^T and dS^T come out of the accumulators already as A operands. 4
//   warps, 32 rows each as two 16-row strips, so every B fragment feeds two
//   strips. The forward and dq take S (and dP) of a whole 32-key tile, so
//   each Q and dO fragment is split once a tile; the dk/dv kernel, whose
//   two accumulators fill half its registers, 16 queries at a time.
// - Accumulators (out, dq, or dk and dv), S, P and dP live in registers.
//   The tensor cores truncate when they add, so each 16-token chunk's share
//   of an accumulator is summed from zero and added to it in fp32: the long
//   sums round to nearest. An accumulator tile's columns 2t, 2t+1 become
//   the A operand's depth slots t, t+4 (t = lane % 4) with no shuffle: the
//   next product's B operand reads its depth rows in the same order
//   (k0 + 2t, k0 + 2t + 1).
// - Streamed tiles arrive by 16-byte cp.async, double-buffered: the copy of
//   tile t + 1 runs under the products of tile t. Shared rows are 64 floats
//   at a 68-float pitch: the fragment reads of one warp (rows g, columns t,
//   or rows 2t, 2t + 1, columns g) fall in 32 different banks. The backward
//   kernels hold 102 KB of shared memory, the forward 68 KB; registers
//   allow 2 CTAs of 4 warps an SM.
// - No atomics: every output element is written once, by one CTA, so
//   repeated launches give the same bits.
//
// Tensors are (B, H, S, D) fp32 views with any batch, head and token strides
// that are multiples of 4 elements, a contiguous D axis and 16-byte aligned
// base pointers. S must be a multiple of 64; D must be 64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kD = 64;                   // head dimension
constexpr int kT = 32;                   // tokens of one streamed tile
constexpr int kPitch = kD + 4;           // shared row pitch in floats (272 bytes)
constexpr int kChunks = kD * 4 / 16;     // 16-byte chunks of one row
constexpr int kTileElems = kT * kPitch;
constexpr float kNegInf = -1e30f;
constexpr float kMinL = 1e-30f;         // floor of the softmax's row sum

constexpr int kWarps = 4;                // a CTA of 4 warps ...
constexpr int kM = 2;                    // ... of two 16-row strips each
constexpr int kRows = 16 * kM * kWarps;  // rows a CTA owns (queries, or keys)
constexpr int kThreads = 32 * kWarps;
constexpr int kResidentElems = kRows * kPitch;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small + (a remainder of about 2^-22 |x|), both tf32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c (16 x 8, fp32) += a (16 x 8, tf32) b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// split operands and the 3xTF32 product
//
// With g = lane / 4 and t = lane % 4, an accumulator tile c (16 x 8) holds
// row g in c[0], c[1] and row g + 8 in c[2], c[3], at columns 2t, 2t + 1. An
// A operand (16 x 8) holds rows g, g + 8 at depth slots t and t + 4; a B
// operand (8 x 8) column g at depth slots t and t + 4.
// ---------------------------------------------------------------------------

struct FragA {  // an A operand as big and small tf32 parts
  uint32_t big[4], small[4];
};

struct FragB {  // a B operand as big and small tf32 parts
  uint32_t big[2], small[2];
};

// c += a b in 3xTF32; the small terms first, which they lose least to
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// A from rows row0.. of a shared tile (row = output row, column = depth),
// depth k0..k0+7 in order: slot t is column k0 + t
__device__ __forceinline__ FragA load_a(const float* tile, int row0, int k0, int lane) {
  const float* p = tile + (row0 + (lane >> 2)) * kPitch + k0 + (lane & 3);
  FragA a;
  split(p[0], a.big[0], a.small[0]);
  split(p[8 * kPitch], a.big[1], a.small[1]);
  split(p[4], a.big[2], a.small[2]);
  split(p[8 * kPitch + 4], a.big[3], a.small[3]);
  return a;
}

// B with column n of the product from row n0 + n of a shared tile, depth
// along the row, in order (the product's right factor is the tile transposed)
__device__ __forceinline__ FragB load_b_rows(const float* tile, int n0, int k0, int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * kPitch + k0 + (lane & 3);
  FragB b;
  split(p[0], b.big[0], b.small[0]);
  split(p[4], b.big[1], b.small[1]);
  return b;
}

// B with depth from rows k0.. of a shared tile and column n of the product
// from column n0 + n, depth slots t, t + 4 at rows k0 + 2t, k0 + 2t + 1 (the
// order of an accumulator's columns, see to_a)
__device__ __forceinline__ FragB load_b_cols(const float* tile, int k0, int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * kPitch + n0 + (lane >> 2);
  FragB b;
  split(p[0], b.big[0], b.small[0]);
  split(p[kPitch], b.big[1], b.small[1]);
  return b;
}

// an accumulator tile as an A operand of depth 8: columns 2t, 2t + 1 go to
// slots t, t + 4
__device__ __forceinline__ FragA to_a(const float (&c)[4]) {
  FragA a;
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
  return a;
}

// c[m] (16 rows x 8 kN tokens: tokens tok0 + 8 n + ...) += the strips'
// rows of `rows` (a resident tile) times the tokens' rows of `tile`,
// transposed: a 64-deep product over D
template <int kN>
__device__ __forceinline__ void mma_nt(float (&c)[kM][kN][4], const float* rows, int row0,
                                       const float* tile, int tok0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    FragB b[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) b[n] = load_b_rows(tile, tok0 + 8 * n, 8 * kk, lane);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const FragA a = load_a(rows, row0 + 16 * m, 8 * kk, lane);
#pragma unroll
      for (int n = 0; n < kN; ++n) mma3(c[m][n], a, b[n]);
    }
  }
}

// acc[m] (16 x D) += p[m] (16 x 16 tokens: the 8-token tiles n0, n0 + 1 of
// p) times the tokens' rows of `tile` (tokens tok0 ..): two 8-deep steps.
// The tensor cores add into their accumulator with truncation, which over
// the ~1900 mma.sync of a 5000-token walk would pull the result toward zero
// by about 5e-5 of its size; so each 16 x 8 block of the chunk's product is
// summed from zero in the tensor cores and added to acc in fp32 (round to
// nearest).
template <int kN>
__device__ __forceinline__ void mma_nn16(float (&acc)[kM][8][4], const float (&p)[kM][kN][4],
                                         int n0, const float* tile, int tok0, int lane) {
  FragA a[kM][2];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) a[m][n] = to_a(p[m][n0 + n]);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    FragB b[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) b[n] = load_b_cols(tile, tok0 + 8 * n, 8 * j, lane);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma3(part, a[m][0], b[0]);
      mma3(part, a[m][1], b[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] += part[e];
    }
  }
}

// one accumulator strip (rows row0 + g, row0 + g + 8) as fp32 rows of a
// (token, D) matrix; rows at or past S are skipped
__device__ __forceinline__ void store_strip(float* base, long long ss, int row0, int S,
                                            const float (&c)[8][4], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= S) continue;
    float* dst = base + row * ss + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(c[j][2 * r], c[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// asynchronous copies into shared memory
// ---------------------------------------------------------------------------

// rows row0..row0+kN-1 of a (token, D) fp32 matrix into a shared tile; rows
// at or past S are zero-filled
template <int kN>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, long long ss, int row0,
                                          int S) {
  static_assert(kN * kChunks % kThreads == 0, "chunks must split evenly over the threads");
#pragma unroll
  for (int i = 0; i < kN * kChunks / kThreads; ++i) {
    const int c = i * kThreads + threadIdx.x;
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * kPitch + ch * 4, src + (ok ? row0 + r : 0) * ss + ch * 4, ok);
  }
}

// ---------------------------------------------------------------------------
// forward: a CTA owns 128 query rows and walks the key tiles, 32 keys a step
// ---------------------------------------------------------------------------

constexpr size_t kFwdSmem = (kResidentElems + 4 * kTileElems) * sizeof(float) + 2 * kT;

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, View vq, View vk, View vv,
                 View vo, int H, int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kResidentElems;  // [2][kT][kPitch]
  float* sV = sK + 2 * kTileElems;  // [2][kT][kPitch]
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sV + 2 * kTileElems);  // [2][kT]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row0 = w * kM * 16;  // the warp's first row within the CTA's
  const int nk = S / kT;
  const float* kp = k + b * vk.sb + h * vk.sh;
  const float* vp = v + b * vv.sb + h * vv.sh;
  const uint8_t* mp = mask + static_cast<long long>(b) * S;

  auto load_kv = [&](int kt, int buf) {
    copy_rows<kT>(sK + buf * kTileElems, kp, vk.ss, kt * kT, S);
    copy_rows<kT>(sV + buf * kTileElems, vp, vv.ss, kt * kT, S);
    copy_bytes(sMask + buf * kT, mp + kt * kT, kT, 0);
  };
  copy_rows<kRows>(sQ, q + b * vq.sb + h * vq.sh, vq.ss, q0, S);
  load_kv(0, 0);
  cp_async_commit();

  // the online softmax of the thread's rows g and g + 8 of each strip: the
  // row's running maximum of the logits (the same in the quad's 4 lanes),
  // and the sum of exp(logit - m) over the lane's own columns
  float mrow[kM][2], lsum[kM][2];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mrow[m][r] = kNegInf;
      lsum[m][r] = 0.0f;
    }
  }
  float acc[kM][8][4];
  zero(acc);

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) have landed
    __syncthreads();
    const float* tk = sK + buf * kTileElems;
    const float* tv = sV + buf * kTileElems;
    const uint8_t* mk = sMask + buf * kT;

    float s[kM][kT / 8][4];  // S of the whole tile, so each Q fragment is split once a tile
    zero(s);
    mma_nt(s, sQ, row0, tk, 0, lane);  // S = Q K^T
    bool valid[kT / 8][2];
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      const int col = 8 * n + 2 * (lane & 3);
      valid[n][0] = mk[col] != 0;
      valid[n][1] = mk[col + 1] != 0;
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float mx[2] = {mrow[m][0], mrow[m][1]};
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = valid[n][e & 1] ? __fmul_rn(s[m][n][e], scale) : kNegInf;
          s[m][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the row's maximum over the quad's columns
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = expf(mrow[m][r] - mx[r]);
        mrow[m][r] = mx[r];
        lsum[m][r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[m][n][e] - mx[e >> 1]);
          s[m][n][e] = p;  // P, unrounded fp32
          lsum[m][e >> 1] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] *= corr[e >> 1];
      }
    }
#pragma unroll
    for (int c = 0; c < kT / 16; ++c) mma_nn16(acc, s, 2 * c, tv, 16 * c, lane);  // O += P V
    __syncthreads();  // buffer buf is refilled in the next step
  }

  // out = O / l and lse = m + log l, with l (the quad's 4 sums) clamped at 1e-30
  const long long vec = (static_cast<long long>(b) * H + h) * S;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = lsum[m][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, kMinL);
      const int row = q0 + row0 + 16 * m + (lane >> 2) + 8 * r;
      if ((lane & 3) == 0 && row < S) lse[vec + row] = mrow[m][r] + logf(l);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[m][j][2 * r] /= l;
        acc[m][j][2 * r + 1] /= l;
      }
    }
    store_strip(out + b * vo.sb + h * vo.sh, vo.ss, q0 + row0 + 16 * m, S, acc[m], lane);
  }
}

// ---------------------------------------------------------------------------
// dq: a CTA owns 128 query rows and walks the key tiles, 32 keys a step
// ---------------------------------------------------------------------------

constexpr size_t kDqSmem = (2 * kResidentElems + 4 * kTileElems) * sizeof(float) + 2 * kT;

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, float* __restrict__ dq, View vq, View vk,
                    View vv, View vdo, View vdq, int H, int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + kResidentElems;
  float* sK = sDO + kResidentElems;  // [2][kT][kPitch]
  float* sV = sK + 2 * kTileElems;   // [2][kT][kPitch]
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sV + 2 * kTileElems);  // [2][kT]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row0 = w * kM * 16;  // the warp's first row within the CTA's
  const int nk = S / kT;
  const float* kp = k + b * vk.sb + h * vk.sh;
  const float* vp = v + b * vv.sb + h * vv.sh;
  const uint8_t* mp = mask + static_cast<long long>(b) * S;

  auto load_kv = [&](int kt, int buf) {
    copy_rows<kT>(sK + buf * kTileElems, kp, vk.ss, kt * kT, S);
    copy_rows<kT>(sV + buf * kTileElems, vp, vv.ss, kt * kT, S);
    copy_bytes(sMask + buf * kT, mp + kt * kT, kT, 0);
  };
  copy_rows<kRows>(sQ, q + b * vq.sb + h * vq.sh, vq.ss, q0, S);
  copy_rows<kRows>(sDO, dout + b * vdo.sb + h * vdo.sh, vdo.ss, q0, S);
  load_kv(0, 0);
  cp_async_commit();

  // lse and delta of the thread's rows g and g + 8 of each strip
  const long long vec = (static_cast<long long>(b) * H + h) * S;
  float ls[kM][2], dl[kM][2];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 16 * m + (lane >> 2) + 8 * r;
      ls[m][r] = row < S ? lse[vec + row] : 0.0f;
      dl[m][r] = row < S ? delta[vec + row] : 0.0f;
    }
  }

  float acc[kM][8][4];
  zero(acc);

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q, dO) have landed
    __syncthreads();
    const float* tk = sK + buf * kTileElems;
    const float* tv = sV + buf * kTileElems;
    const uint8_t* mk = sMask + buf * kT;

    // S and dP of the whole tile, so each Q and dO fragment is split once a tile
    float s[kM][kT / 8][4], dp[kM][kT / 8][4];
    zero(s);
    zero(dp);
    mma_nt(s, sQ, row0, tk, 0, lane);    // S = Q K^T
    mma_nt(dp, sDO, row0, tv, 0, lane);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      const int col = 8 * n + 2 * (lane & 3);
      const bool v0 = mk[col] != 0, v1 = mk[col + 1] != 0;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float x = ((e & 1) ? v1 : v0) ? __fmul_rn(s[m][n][e], scale) : kNegInf;
          const float p = expf(x - ls[m][r]);
          s[m][n][e] = p * (dp[m][n][e] - dl[m][r]) * scale;  // dS
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kT / 16; ++c) mma_nn16(acc, s, 2 * c, tk, 16 * c, lane);  // dQ += dS K
    __syncthreads();  // buffer buf is refilled in the next step
  }

#pragma unroll
  for (int m = 0; m < kM; ++m) {
    store_strip(dq + b * vdq.sb + h * vdq.sh, vdq.ss, q0 + row0 + 16 * m, S, acc[m], lane);
  }
}

// ---------------------------------------------------------------------------
// dk and dv: a CTA owns 128 keys and walks the query tiles, 16 queries a step
// ---------------------------------------------------------------------------

constexpr size_t kDkvSmem =
    (2 * kResidentElems + 4 * kTileElems) * sizeof(float) + 4 * kT * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const uint8_t* __restrict__ mask, float* __restrict__ dk,
                     float* __restrict__ dv, View vq, View vk, View vv, View vdo, View vdk,
                     View vdv, int H, int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + kResidentElems;
  float* sQ = sV + kResidentElems;   // [2][kT][kPitch]
  float* sDO = sQ + 2 * kTileElems;  // [2][kT][kPitch]
  float* sLse = sDO + 2 * kTileElems;  // [2][kT]
  float* sDelta = sLse + 2 * kT;       // [2][kT]

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row0 = w * kM * 16;  // the warp's first key within the CTA's
  const int nq = S / kT;
  const float* qp = q + b * vq.sb + h * vq.sh;
  const float* dop = dout + b * vdo.sb + h * vdo.sh;
  const long long vec = (static_cast<long long>(b) * H + h) * S;
  constexpr int kVecBytes = kT * sizeof(float);

  auto load_q = [&](int qt, int buf) {
    copy_rows<kT>(sQ + buf * kTileElems, qp, vq.ss, qt * kT, S);
    copy_rows<kT>(sDO + buf * kTileElems, dop, vdo.ss, qt * kT, S);
    copy_bytes(sLse + buf * kT, lse + vec + qt * kT, kVecBytes, 0);
    copy_bytes(sDelta + buf * kT, delta + vec + qt * kT, kVecBytes, kVecBytes / 16);
  };
  copy_rows<kRows>(sK, k + b * vk.sb + h * vk.sh, vk.ss, k0, S);
  copy_rows<kRows>(sV, v + b * vv.sb + h * vv.sh, vv.ss, k0, S);
  load_q(0, 0);
  cp_async_commit();

  // validity of the thread's keys g and g + 8 of each strip (keys past S
  // count as invalid)
  bool kv[kM][2];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + row0 + 16 * m + (lane >> 2) + 8 * r;
      kv[m][r] = key < S && mask[static_cast<long long>(b) * S + key] != 0;
    }
  }

  float dka[kM][8][4], dva[kM][8][4];
  zero(dka);
  zero(dva);

  for (int qt = 0; qt < nq; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < nq) load_q(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* tq = sQ + buf * kTileElems;
    const float* tdo = sDO + buf * kTileElems;
    const float* L = sLse + buf * kT;
    const float* Dl = sDelta + buf * kT;

#pragma unroll 1
    for (int c = 0; c < kT / 16; ++c) {
      float st[kM][2][4], dpt[kM][2][4];  // keys as rows, 16 queries as columns
      zero(st);
      zero(dpt);
      mma_nt(st, sK, row0, tq, 16 * c, lane);    // S^T = K Q^T
      mma_nt(dpt, sV, row0, tdo, 16 * c, lane);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * c + 8 * n + 2 * (lane & 3);
        const float2 lq = *reinterpret_cast<const float2*>(L + col);
        const float2 dq2 = *reinterpret_cast<const float2*>(Dl + col);
        const float lc[2] = {lq.x, lq.y};
        const float dc[2] = {dq2.x, dq2.y};
#pragma unroll
        for (int m = 0; m < kM; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = kv[m][e >> 1] ? __fmul_rn(st[m][n][e], scale) : kNegInf;
            const float p = expf(x - lc[e & 1]);
            st[m][n][e] = p;                                         // P^T
            dpt[m][n][e] = p * (dpt[m][n][e] - dc[e & 1]) * scale;  // dS^T
          }
        }
      }
      mma_nn16(dva, st, 0, tdo, 16 * c, lane);  // dV += P^T dO
      mma_nn16(dka, dpt, 0, tq, 16 * c, lane);  // dK += dS^T Q
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int key0 = k0 + row0 + 16 * m;
    store_strip(dk + b * vdk.sb + h * vdk.sh, vdk.ss, key0, S, dka[m], lane);
    store_strip(dv + b * vdv.sb + h * vdv.sh, vdv.ss, key0, S, dva[m], lane);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// 16-byte rows for cp.async and 8-byte pairs for the stores
bool aligned(const void* p, const View& vw) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && vw.sb % 4 == 0 && vw.sh % 4 == 0 &&
         vw.ss % 4 == 0;
}

}  // namespace

// All tensors live on the device. q, k, v, do and the outputs are fp32
// (B, H, S, D) views given by their element strides (batch, head, token;
// multiples of 4; the D axis contiguous; 16-byte aligned); mask is (B, S)
// bytes (0 = invalid key); lse and delta are (B, H, S) contiguous fp32; all
// 16-byte aligned. S % 64 == 0 and D == 64. The backward's strides: q, k, v,
// do, dq, dk, dv (21 values); an entry reads only the slots of the outputs
// it writes. Each returns cudaGetLastError() after its launches (0 =
// success).

// the forward: flash_fwd_tf32x3. lse is written, not read; strides: q, k,
// v, out (12 values)
extern "C" int vtamiq_flash_fwd_f32(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* lse,
                                    const long long* strides, int B, int H, int S, int D,
                                    void* stream) {
  const View vq = view_at(strides, 0), vk = view_at(strides, 1), vv = view_at(strides, 2),
             vo = view_at(strides, 3);
  if (!shapes_ok(B, H, S, D) || !aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) ||
      !aligned(out, vo) || !vectors_aligned(mask, lse, lse)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(flash_fwd_tf32x3, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_tf32x3<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(lse), vq,
      vk, vv, vo, H, S, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// the split backward's dq pass: flash_bwd_dq_tf32x3
extern "C" int vtamiq_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* mask, void* dq, const long long* strides,
                                       int B, int H, int S, int D, void* stream) {
  const View vq = view_at(strides, 0), vk = view_at(strides, 1), vv = view_at(strides, 2),
             vdo = view_at(strides, 3), vdq = view_at(strides, 4);
  if (!shapes_ok(B, H, S, D) || !aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) ||
      !aligned(dout, vdo) || !aligned(dq, vdq) || !vectors_aligned(mask, lse, delta)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(flash_bwd_dq_tf32x3, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_bwd_dq_tf32x3<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dq), vq, vk, vv, vdo, vdq, H, S, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// the split backward's dk/dv pass: flash_bwd_dkv_tf32x3
extern "C" int vtamiq_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* mask, void* dk, void* dv,
                                        const long long* strides, int B, int H, int S, int D,
                                        void* stream) {
  const View vq = view_at(strides, 0), vk = view_at(strides, 1), vv = view_at(strides, 2),
             vdo = view_at(strides, 3), vdk = view_at(strides, 5), vdv = view_at(strides, 6);
  if (!shapes_ok(B, H, S, D) || !aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) ||
      !aligned(dout, vdo) || !aligned(dk, vdk) || !aligned(dv, vdv) ||
      !vectors_aligned(mask, lse, delta)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(flash_bwd_dkv_tf32x3, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_tf32x3<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dk), static_cast<float*>(dv), vq, vk, vv, vdo, vdk, vdv, H, S,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// the fused backward: the dq pass, then the dk/dv pass, on one stream
extern "C" int vtamiq_flash_bwd_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* mask, void* dq, void* dk, void* dv,
                                    const long long* strides, int B, int H, int S, int D,
                                    void* stream) {
  const int err = vtamiq_flash_bwd_dq_f32(q, k, v, dout, lse, delta, mask, dq, strides, B, H,
                                          S, D, stream);
  if (err != 0) return err;
  return vtamiq_flash_bwd_dkv_f32(q, k, v, dout, lse, delta, mask, dk, dv, strides, B, H, S, D,
                                  stream);
}
