// Flash attention in bf16 for Hopper (sm_90a): the forward and the
// backward, on register-resident mma.sync tiles.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels of vtamiq_tpu/ops/attention.py:
//   flash_fwd_sm90      <- _flash_fwd_kernel (driven by _flash_forward)
//   flash_bwd_dq_sm90   <- _flash_bwd_dq_kernel (_flash_backward, fused=False)
//   flash_bwd_dkv_sm90  <- _flash_bwd_dkv_kernel (_flash_backward, fused=False)
//   both, one after the other
//                       <- _flash_bwd_fused_kernel (_flash_backward_fused)
// Given lse and delta, the split pair computes the fused kernel's function,
// so one pair of kernels serves both. fp32 inputs take flash_attention.cu
// (the forward) and flash_attention_tf32x3.cu (the backward).
//
// The function, per (batch row, head): logits = q k^T * scale with invalid keys at NEG_INF = -1e30,
// out = softmax(logits) v and lse = logsumexp(logits) in fp32; the backward
// p = exp(logits - lse), ds = p (do v^T - delta) scale, dq = ds k,
// dk = ds^T q, dv = p^T do. p is rounded to bf16 before p v and p^T do,
// ds before ds k and ds^T q, as in the TPU kernels.
//
// Bound: operations. At the 5000-patch shapes (16 rows, 12 heads, S = 5056,
// D = 64) the forward's two products are 1.26 TFLOP and its 4.8 G exps
// take about as long on the special-function units; the inputs and outputs
// are 0.12 GB, far right of the ridge point.
//
// Design (FlashAttention-2 on mma.sync; wgmma and TMA are later work):
// - Products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Operands
//   come from shared memory through ldmatrix, with .trans where a product
//   reads its tile along the token axis (V in P V, K in dS K, dO in P^T dO,
//   Q in dS^T Q). Accumulators stay in registers for the whole kernel.
// - Shared tiles are 64 tokens of D = 64 bf16 (128 bytes a row), padded to
//   a 144-byte pitch, so the 8 row addresses of one ldmatrix phase fall in 8
//   different groups of 4 banks. Tiles arrive by 16-byte cp.async, double
//   buffered: the copy of tile t + 1 runs under the products of tile t. Rows
//   past S are zero-filled and never stored.
// - Logits are kept in log2 units: one multiply by scale * log2(e), then
//   exp2. lse is written and read in natural-log units. NEG_INF stays
//   finite (-1e30, times log2(e) here), so a key block without a valid key
//   gives exp2(0) terms that the next valid block's correction
//   exp2(-1.44e30 - m) wipes out; l is clamped at 1e-30.
// - Every kernel: a CTA of 4 warps owns 128 rows (queries, or keys in the
//   dk/dv kernel), 32 a warp as two m16 strips, so every B fragment read
//   from shared memory feeds two products; the streamed tiles are 64 tokens.
//   2 CTAs fit on an SM (up to 255 registers a thread, 55 to 75 KB of
//   shared memory a CTA).
// - Forward: Q's fragments, S, P, O, the running max m and the per-thread
//   partial sums l live in registers; the row max is reduced over the 4
//   lanes that share a row (shfl_xor 1, 2), l once at the end. P goes from
//   the accumulator layout to the A-operand layout in registers, rounded to
//   bf16 there.
// - Backward, deterministic and without atomics: two kernels, 7 products a
//   tile where the TPU kernel does 5. The TPU kernel's per-key-block fp32
//   dq partials would be 10 to 20 GB at these shapes, and adding them with
//   atomics makes dq depend on the order CTAs finish. dq comes from a
//   query-major kernel (logits, dP, dQ += dS K; K and V tiles streamed);
//   dk and dv from a key-major kernel (logits^T, dP^T, dV += P^T dO,
//   dK += dS^T Q; Q, dO, lse and delta tiles streamed). The key-major
//   kernel computes S^T and dP^T with keys as rows, so P^T and dS^T come out
//   of the accumulators already in the A-operand layout and never go
//   through shared memory. Both walk each tile 16 tokens at a time: p and
//   ds need no row reduction, so only a 16-column slice of the logits and
//   of dP is live, which leaves the registers for 32-row strips.
//
// Tensors are (B, H, S, D) views with any batch, head and token strides that
// are multiples of 8 elements, a contiguous D axis and 16-byte aligned base
// pointers. S must be a multiple of 64; D must be 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                   // head dimension
constexpr int kTile = 64;                // tokens of one streamed tile
constexpr int kPitch = kD + 8;           // shared row pitch in elements (144 bytes)
constexpr int kChunks = kD * 2 / 16;     // 16-byte chunks of one row
constexpr int kTileElems = kTile * kPitch;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = kNegInf * kLog2e;  // an invalid key's logit, in log2 units
constexpr float kMinL = 1e-30f;

constexpr int kWarps = 4;                // every kernel: a CTA of 4 warps ...
constexpr int kM = 2;                    // ... of two 16-row strips each
constexpr int kRows = 16 * kM * kWarps;  // rows a CTA owns (queries, or keys)
constexpr int kThreads = 32 * kWarps;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error below 2^-22; subnormal
// results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair, round to nearest even; lo takes the lower column
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// fragments of one warp's 16-row strips
//
// An accumulator strip c[j][e] (j = 0..7: 8-column tiles of a 64-column
// strip) holds row g = lane / 4 in e = 0, 1 and row g + 8 in e = 2, 3, at
// columns 8j + 2 (lane % 4) + (e & 1). An A operand a[kk] (kk = 0..3:
// 16-deep steps of a 64-deep product) is the m16n8k16 A fragment.
// ---------------------------------------------------------------------------

// a[kk] of rows row0..row0+15 of a shared tile (row = output row, col = depth)
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldsm_x4(a[kk], tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + 16 * kk +
                       (lane >> 4) * 8);
  }
}

// c[m] (16 x 16 tokens: columns 16 c16 .. 16 c16 + 15 as two 8-column tiles)
// += a[m] (16 x D) t^T, t a 64-token shared tile (token x D)
template <int kS>
__device__ __forceinline__ void mma_nt16(float (&c)[kS][2][4], const uint32_t (&a)[kS][4][4],
                                         const bf16* t, int c16, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, t + (16 * c16 + (lane & 7) + (lane >> 4) * 8) * kPitch + 16 * kk +
                   ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int m = 0; m < kS; ++m) {
      mma_bf16(c[m][0], a[m][kk], b[0], b[1]);
      mma_bf16(c[m][1], a[m][kk], b[2], b[3]);
    }
  }
}

// c[m] (16 x D) += a[m] (16 x 16 tokens: 16 c16 .. 16 c16 + 15) t[16 c16 ..],
// t a 64-token shared tile (token x D)
template <int kS>
__device__ __forceinline__ void mma_nn16(float (&c)[kS][8][4], const uint32_t (&a)[kS][4],
                                         const bf16* t, int c16, int lane) {
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    uint32_t b[4];
    ldsm_x4_t(b, t + (16 * c16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + 16 * jp +
                     (lane >> 4) * 8);
#pragma unroll
    for (int m = 0; m < kS; ++m) {
      mma_bf16(c[m][2 * jp], a[m], b[0], b[1]);
      mma_bf16(c[m][2 * jp + 1], a[m], b[2], b[3]);
    }
  }
}

// two 8-column accumulator tiles as the A operand of a 16-deep step,
// rounded to bf16
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// one accumulator strip (rows row0 + g, row0 + g + 8) as bf16 rows of a
// (token, D) matrix; rows at or past S are skipped
__device__ __forceinline__ void store_strip(bf16* base, long long ss, int row0, int S,
                                            const float (&c)[8][4], const float (&div)[2],
                                            int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= S) continue;
    bf16* dst = base + row * ss + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(c[j][2 * r] / div[r], c[j][2 * r + 1] / div[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// asynchronous copies into shared memory
// ---------------------------------------------------------------------------

// rows row0..row0+kN-1 of a (token, D) bf16 matrix into a shared tile;
// rows at or past S are zero-filled
template <int kN>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long long ss, int row0,
                                          int S) {
  static_assert(kN * kChunks % kThreads == 0, "chunks must split evenly over the threads");
#pragma unroll
  for (int i = 0; i < kN * kChunks / kThreads; ++i) {
    const int c = i * kThreads + threadIdx.x;
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * kPitch + ch * 8, src + (ok ? row0 + r : 0) * ss + ch * 8, ok);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr size_t kFwdSmem = (kRows * kPitch + 4 * kTileElems) * sizeof(bf16) + 2 * kTile;

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
               bf16* __restrict__ out, float* __restrict__ lse, View vq, View vk, View vv,
               View vo, int H, int S, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * kPitch;  // [2][kTile][kPitch]
  bf16* sV = sK + 2 * kTileElems;  // [2][kTile][kPitch]
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sV + 2 * kTileElems);  // [2][kTile]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nk = S / kTile;
  const bf16* kp = k + b * vk.sb + h * vk.sh;
  const bf16* vp = v + b * vv.sb + h * vv.sh;
  const uint8_t* mp = mask + static_cast<long long>(b) * S;

  auto load_kv = [&](int kt, int buf) {
    copy_rows<kTile>(sK + buf * kTileElems, kp, vk.ss, kt * kTile, S);
    copy_rows<kTile>(sV + buf * kTileElems, vp, vv.ss, kt * kTile, S);
    copy_bytes(sMask + buf * kTile, mp + kt * kTile, kTile, 0);
  };
  copy_rows<kRows>(sQ, q + b * vq.sb + h * vq.sh, vq.ss, q0, S);
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qa[kM][4][4];
  float o[kM][8][4];
  float m[kM][2], l[kM][2];
  zero(o);
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    m[mt][0] = m[mt][1] = kMasked;
    l[mt][0] = l[mt][1] = 0.0f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) have landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) load_a(qa[mt], sQ, (w * kM + mt) * 16, lane);
    }
    const bf16* tk = sK + buf * kTileElems;
    const uint8_t* mk = sMask + buf * kTile;

    float s[kM][4][2][4];  // S = Q K^T, key columns 16c + 8n + ...
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float sc[kM][2][4];
      zero(sc);
      mma_nt16<kM>(sc, qa, tk, c, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * c + 8 * n + 2 * (lane & 3);
        const bool v0 = mk[col] != 0, v1 = mk[col + 1] != 0;
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][c][n][e] = ((e & 1) ? v1 : v0) ? sc[mt][n][e] * scale_log2 : kMasked;
          }
        }
      }
    }

    // online softmax over the thread's rows g and g + 8 of each strip
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mx = fmaxf(mx, fmaxf(s[mt][c][n][2 * r], s[mt][c][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = exp2_approx(m[mt][r] - mx);
        m[mt][r] = mx;
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              const float p = exp2_approx(s[mt][c][n][e] - mx);
              s[mt][c][n][e] = p;
              sum += p;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[mt][j][2 * r] *= corr;
          o[mt][j][2 * r + 1] *= corr;
        }
        l[mt][r] = l[mt][r] * corr + sum;
      }
    }

    const bf16* tv = sV + buf * kTileElems;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // O += P V, 16 keys a step
      uint32_t pa[kM][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) to_a(pa[mt], s[mt][c]);
      mma_nn16<kM>(o, pa, tv, c, lane);
    }
    __syncthreads();  // buffer buf is refilled in the next step
  }

  bf16* op = out + b * vo.sb + h * vo.sh;
  float* lp = lse + (static_cast<long long>(b) * H + h) * S;
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    const int row0 = q0 + (w * kM + mt) * 16;
    float lt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l[mt][r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      lt[r] = fmaxf(x, kMinL);
      const int row = row0 + (lane >> 2) + 8 * r;
      if ((lane & 3) == 0 && row < S) lp[row] = m[mt][r] * kLn2 + logf(lt[r]);
    }
    store_strip(op, vo.ss, row0, S, o[mt], lt, lane);
  }
}

// ---------------------------------------------------------------------------
// backward, dq: a CTA owns 128 query rows and walks the key tiles, 16 keys
// a step
// ---------------------------------------------------------------------------

constexpr size_t kDqSmem = (2 * kRows * kPitch + 4 * kTileElems) * sizeof(bf16) + 2 * kTile;

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const uint8_t* __restrict__ mask, bf16* __restrict__ dq, View vq, View vk,
                  View vv, View vdo, View vdq, int H, int S, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + kRows * kPitch;
  bf16* sK = sDO + kRows * kPitch;  // [2][kTile][kPitch]
  bf16* sV = sK + 2 * kTileElems;   // [2][kTile][kPitch]
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sV + 2 * kTileElems);  // [2][kTile]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nk = S / kTile;
  const bf16* kp = k + b * vk.sb + h * vk.sh;
  const bf16* vp = v + b * vv.sb + h * vv.sh;
  const uint8_t* mp = mask + static_cast<long long>(b) * S;

  auto load_kv = [&](int kt, int buf) {
    copy_rows<kTile>(sK + buf * kTileElems, kp, vk.ss, kt * kTile, S);
    copy_rows<kTile>(sV + buf * kTileElems, vp, vv.ss, kt * kTile, S);
    copy_bytes(sMask + buf * kTile, mp + kt * kTile, kTile, 0);
  };
  copy_rows<kRows>(sQ, q + b * vq.sb + h * vq.sh, vq.ss, q0, S);
  copy_rows<kRows>(sDO, dout + b * vdo.sb + h * vdo.sh, vdo.ss, q0, S);
  load_kv(0, 0);
  cp_async_commit();

  // lse (in log2 units) and delta of the thread's rows g and g + 8 of each strip
  const long long vec = (static_cast<long long>(b) * H + h) * S;
  float lse2[kM][2], dl[kM][2];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + (w * kM + mt) * 16 + (lane >> 2) + 8 * r;
      lse2[mt][r] = row < S ? lse[vec + row] * kLog2e : 0.0f;
      dl[mt][r] = row < S ? delta[vec + row] : 0.0f;
    }
  }

  uint32_t qa[kM][4][4], da[kM][4][4];
  float acc[kM][8][4];
  zero(acc);

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        load_a(qa[mt], sQ, (w * kM + mt) * 16, lane);
        load_a(da[mt], sDO, (w * kM + mt) * 16, lane);
      }
    }
    const bf16* tk = sK + buf * kTileElems;
    const bf16* tv = sV + buf * kTileElems;
    const uint8_t* mk = sMask + buf * kTile;

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s[kM][2][4], dp[kM][2][4];
      zero(s);
      zero(dp);
      mma_nt16<kM>(s, qa, tk, c, lane);   // S = Q K^T
      mma_nt16<kM>(dp, da, tv, c, lane);  // dP = dO V^T
      uint32_t sa[kM][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * c + 8 * n + 2 * (lane & 3);
        const bool v0 = mk[col] != 0, v1 = mk[col + 1] != 0;
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float x = ((e & 1) ? v1 : v0) ? s[mt][n][e] * scale_log2 : kMasked;
            const float p = exp2_approx(x - lse2[mt][r]);
            s[mt][n][e] = p * (dp[mt][n][e] - dl[mt][r]) * scale;  // dS
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) to_a(sa[mt], s[mt]);
      mma_nn16<kM>(acc, sa, tk, c, lane);  // dQ += dS K
    }
    __syncthreads();
  }

  const float one[2] = {1.0f, 1.0f};
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    store_strip(dq + b * vdq.sb + h * vdq.sh, vdq.ss, q0 + (w * kM + mt) * 16, S, acc[mt],
                one, lane);
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: a CTA owns 128 keys and walks the query tiles, 16
// queries a step
// ---------------------------------------------------------------------------

constexpr size_t kDkvSmem =
    (2 * kRows * kPitch + 4 * kTileElems) * sizeof(bf16) + 4 * kTile * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const uint8_t* __restrict__ mask, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, View vq, View vk, View vv, View vdo, View vdk,
                   View vdv, int H, int S, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * kPitch;
  bf16* sQ = sV + kRows * kPitch;   // [2][kTile][kPitch]
  bf16* sDO = sQ + 2 * kTileElems;  // [2][kTile][kPitch]
  float* sLse = reinterpret_cast<float*>(sDO + 2 * kTileElems);  // [2][kTile]
  float* sDelta = sLse + 2 * kTile;                              // [2][kTile]

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nq = S / kTile;
  const bf16* qp = q + b * vq.sb + h * vq.sh;
  const bf16* dop = dout + b * vdo.sb + h * vdo.sh;
  const long long vec = (static_cast<long long>(b) * H + h) * S;
  constexpr int kVecBytes = kTile * sizeof(float);

  auto load_q = [&](int qt, int buf) {
    copy_rows<kTile>(sQ + buf * kTileElems, qp, vq.ss, qt * kTile, S);
    copy_rows<kTile>(sDO + buf * kTileElems, dop, vdo.ss, qt * kTile, S);
    copy_bytes(sLse + buf * kTile, lse + vec + qt * kTile, kVecBytes, 0);
    copy_bytes(sDelta + buf * kTile, delta + vec + qt * kTile, kVecBytes, kVecBytes / 16);
  };
  copy_rows<kRows>(sK, k + b * vk.sb + h * vk.sh, vk.ss, k0, S);
  copy_rows<kRows>(sV, v + b * vv.sb + h * vv.sh, vv.ss, k0, S);
  load_q(0, 0);
  cp_async_commit();

  // validity of the thread's keys g and g + 8 of each strip (keys past S
  // count as invalid)
  bool kv[kM][2];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + (w * kM + mt) * 16 + (lane >> 2) + 8 * r;
      kv[mt][r] = key < S && mask[static_cast<long long>(b) * S + key] != 0;
    }
  }

  uint32_t ka[kM][4][4], va[kM][4][4];
  float dka[kM][8][4], dva[kM][8][4];
  zero(dka);
  zero(dva);

  for (int qt = 0; qt < nq; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < nq) load_q(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (qt == 0) {
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        load_a(ka[mt], sK, (w * kM + mt) * 16, lane);
        load_a(va[mt], sV, (w * kM + mt) * 16, lane);
      }
    }
    const bf16* tq = sQ + buf * kTileElems;
    const bf16* tdo = sDO + buf * kTileElems;
    const float* L = sLse + buf * kTile;
    const float* Dl = sDelta + buf * kTile;

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float st[kM][2][4], dpt[kM][2][4];  // keys as rows, 16 queries as columns
      zero(st);
      zero(dpt);
      mma_nt16<kM>(st, ka, tq, c, lane);    // S^T = K Q^T
      mma_nt16<kM>(dpt, va, tdo, c, lane);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * c + 8 * n + 2 * (lane & 3);
        const float2 lq = *reinterpret_cast<const float2*>(L + col);
        const float2 dq2 = *reinterpret_cast<const float2*>(Dl + col);
        const float l2[2] = {lq.x * kLog2e, lq.y * kLog2e};
        const float dl[2] = {dq2.x, dq2.y};
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = kv[mt][e >> 1] ? st[mt][n][e] * scale_log2 : kMasked;
            const float p = exp2_approx(x - l2[e & 1]);
            st[mt][n][e] = p;                                         // P^T
            dpt[mt][n][e] = p * (dpt[mt][n][e] - dl[e & 1]) * scale;  // dS^T
          }
        }
      }
      uint32_t pa[kM][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) to_a(pa[mt], st[mt]);
      mma_nn16<kM>(dva, pa, tdo, c, lane);  // dV += P^T dO
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) to_a(pa[mt], dpt[mt]);
      mma_nn16<kM>(dka, pa, tq, c, lane);   // dK += dS^T Q
    }
    __syncthreads();
  }

  const float one[2] = {1.0f, 1.0f};
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    const int row0 = k0 + (w * kM + mt) * 16;
    store_strip(dk + b * vdk.sb + h * vdk.sh, vdk.ss, row0, S, dka[mt], one, lane);
    store_strip(dv + b * vdv.sb + h * vdv.sh, vdv.ss, row0, S, dva[mt], one, lane);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// 16-byte rows for cp.async and 4-byte pairs for the stores
bool aligned(const void* p, const View& vw) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && vw.sb % 8 == 0 && vw.sh % 8 == 0 &&
         vw.ss % 8 == 0;
}

float log2_scale(int D) { return kLog2e / sqrtf(static_cast<float>(D)); }

}  // namespace

// All tensors live on the device. q, k, v, do and the outputs are bf16
// (B, H, S, D) views given by their element strides (batch, head, token;
// multiples of 8; the D axis contiguous; 16-byte aligned); mask is (B, S)
// bytes (0 = invalid key); lse and delta are (B, H, S) contiguous fp32.
// S % 64 == 0 and D == 64. Each returns cudaGetLastError() after its
// launches (0 = success).

// strides: q, k, v, out (12 values)
extern "C" int vtamiq_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, void* lse,
                                     const long long* strides, int B, int H, int S, int D,
                                     void* stream) {
  const View vq = view_at(strides, 0), vk = view_at(strides, 1), vv = view_at(strides, 2),
             vo = view_at(strides, 3);
  if (!shapes_ok(B, H, S, D) || !aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) ||
      !aligned(out, vo) || reinterpret_cast<uintptr_t>(mask) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(flash_fwd_sm90, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_sm90<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse), vq,
      vk, vv, vo, H, S, log2_scale(D));
  return static_cast<int>(cudaGetLastError());
}

// strides of the backward entry points: q, k, v, do, dq, dk, dv (21
// values); an entry reads only the slots of the outputs it writes.

// the split backward's dq pass: flash_bwd_dq_sm90
extern "C" int vtamiq_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* mask, void* dq, const long long* strides,
                                        int B, int H, int S, int D, void* stream) {
  const View vq = view_at(strides, 0), vk = view_at(strides, 1), vv = view_at(strides, 2),
             vdo = view_at(strides, 3), vdq = view_at(strides, 4);
  if (!shapes_ok(B, H, S, D) || !aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) ||
      !aligned(dout, vdo) || !aligned(dq, vdq) || !vectors_aligned(mask, lse, delta)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(flash_bwd_dq_sm90, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_bwd_dq_sm90<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(dq), vq, vk, vv, vdo, vdq, H, S, 1.0f / sqrtf(static_cast<float>(D)),
      log2_scale(D));
  return static_cast<int>(cudaGetLastError());
}

// the split backward's dk/dv pass: flash_bwd_dkv_sm90
extern "C" int vtamiq_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
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
  cudaError_t err = allow_smem(flash_bwd_dkv_sm90, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_sm90<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), vq, vk, vv, vdo, vdk, vdv, H, S,
      1.0f / sqrtf(static_cast<float>(D)), log2_scale(D));
  return static_cast<int>(cudaGetLastError());
}

// the fused backward: the dq pass, then the dk/dv pass, on one stream
extern "C" int vtamiq_flash_bwd_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* mask, void* dq, void* dk, void* dv,
                                     const long long* strides, int B, int H, int S, int D,
                                     void* stream) {
  const int err = vtamiq_flash_bwd_dq_bf16(q, k, v, dout, lse, delta, mask, dq, strides, B, H,
                                           S, D, stream);
  if (err != 0) return err;
  return vtamiq_flash_bwd_dkv_bf16(q, k, v, dout, lse, delta, mask, dk, dv, strides, B, H, S,
                                   D, stream);
}
