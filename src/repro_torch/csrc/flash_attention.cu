// Prefill attention with an online softmax: causal or not, an optional
// sliding window, queries aligned to the end of the valid keys.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py). Per query row i
// (position q_offset + i) and key j it computes
//   s_ij = (q_i . k_j) * D^-1/2, masked to NEG where j >= valid_lk,
//          (causal) q_offset + i < j, or (window) q_offset + i - j >= window;
//   o_i  = sum_j softmax_j(s_ij) v_j,
// with float32 sums, written back in the input type.
//
// Layout: q (B*Hq, Lq, D), k and v (B*Hkv, Lk, D), Hq = rep * Hkv: query
// head h reads kv head h / rep, so GQA never materializes repeated keys.
// The masking value is the finite NEG = -1e30 of the reference: with -inf
// a row whose first kv tile is wholly masked (a sliding window) would give
// exp(-inf - -inf) = NaN; with NEG the row's junk is scaled away by
// alpha = exp(NEG - m) = 0 once a real key arrives. Tiles masked for every
// row of a block (beyond the causal diagonal or before the window) are
// skipped, which is exact for the same reason.
//
// What bounds it on the H100: at Zamba2's prefill (B*Hq = 256, L = 512,
// D = 80, causal) the function needs ~10.8 GFLOP against ~84 MB of q, k,
// v and o: 0.025 ms at 3.35 TB/s, 0.011 ms on the bf16 tensor cores, so
// bytes bound it; at one 4,096-token prompt the products bound it
// (0.087 ms). Two designs, by input type:
//
// bf16 (the LM path): `flash_kernel_bf16`, shaped like FlashAttention-2.
// A block owns 64 query rows, each of its 4 warps 16 of them, and keeps
// its Q fragments in registers for the whole kv loop. S = Q K^T and
// O += P V run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// accumulate), K read by ldmatrix and V by ldmatrix.trans; the online
// softmax stays in registers (row max and sum over the quad of lanes that
// share a row, exp2 with log2(e) folded into the scale), and P is rounded
// to bf16 straight from the C-fragment layout into A fragments, the one
// rounding this design adds (2^-9 relative per probability, well inside
// the 2e-2 bar). K/V tiles of 64 keys are double-buffered with cp.async,
// so tile t + 1 loads while tile t computes; shared rows are D + 8
// elements, an odd number of 16-byte units, so ldmatrix's 8 row reads
// hit 8 distinct bank groups. D is zero-padded in shared memory to the
// next instantiated width (16, 32, 64, 80, 96, 128), which is exact.
// Causal q tiles launch longest first, so the short diagonal tiles fill
// the tail of the grid. Up to D 80 the kernel is held to 128 registers
// (4 blocks, 16 warps per SM; ptxas spills ~50 bytes at D 80).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: 0.084
// ms of device time per launch inside a Zamba2 prefill, 3.4x its byte
// bound; ~190 TFLOP/s at one 4,096-token prompt, 2.2x its operation
// bound. Instruction rate, not bytes or the tensor-core peak, holds it: with
// 16 rows per warp every K or V fragment loaded by ldmatrix feeds only
// two MMAs, and each 64-key tile adds a softmax step (exp2 on the MUFU,
// quad shuffles, rescaling); 32 rows per warp or wgmma is the next step.
//
// float32: `flash_kernel`, the CUDA-core design of the first port. Its
// 2e-5 bar is beyond TF32's ~1e-3, so its products stay float32 FFMA
// from shared memory (8 warps x 8 rows, a lane scoring keys lane and
// lane + 32, the key tile padded to D + 1 floats): the rate of FFMA and
// shared loads bounds it, not the card's bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

#define BQ 64
#define BK 64
#define THREADS 256
#define N_WARPS (THREADS / 32)
#define RPW (BQ / N_WARPS)  // query rows per warp
#define MAX_D 128
#define DSLOTS (MAX_D / 32)
#define NEG (-1e30f)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

static size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)BQ * d + (size_t)BK * (d + 1) + (size_t)BK * d + BQ * BK);
}

__global__ void __launch_bounds__(THREADS)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq,
                 int rep,
                 int lq, int lk, int d, int q_offset, int valid_lk,
                 int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int dk = d + 1;
  float* qs = smem;             // BQ x d
  float* ks = qs + BQ * d;      // BK x (d + 1)
  float* vs = ks + BK * dk;     // BK x d
  float* ps = vs + BK * d;      // BQ x BK probabilities
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int hkv = hq / rep;
  const size_t kvh = (size_t)(bh / hq) * hkv + (bh % hq) / rep;
  const float* qp = q + (size_t)bh * lq * d;
  const float* kp = k + kvh * lk * d;
  const float* vp = v + kvh * lk * d;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    qs[i] = q0 + r < lq ? qp[(size_t)(q0 + r) * d + c] : 0.0f;
  }

  // keys any row of this block can attend
  const int rows = min(BQ, lq - q0);
  const int qlo = q_offset + q0, qhi = qlo + rows - 1;
  int kend = valid_lk;
  if (causal) kend = min(kend, qhi + 1);
  const int kstart = window > 0 ? max(0, qlo - window + 1) : 0;

  float m[RPW], l[RPW], acc[RPW][DSLOTS];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DSLOTS; ++c) acc[r][c] = 0.0f;
  }

  for (int t0 = (kstart / BK) * BK; t0 < kend; t0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * d; i += THREADS) {
      const int r = i / d, c = i - r * d, key = t0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (key < lk) {
        kv = kp[(size_t)key * d + c];
        vv = vp[(size_t)key * d + c];
      }
      ks[r * dk + c] = kv;
      vs[r * d + c] = vv;
    }
    __syncthreads();

    float s[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.0f;
    for (int c = 0; c < d; ++c) {
      const float k0 = ks[lane * dk + c], k1 = ks[(lane + 32) * dk + c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float qv = qs[(warp * RPW + r) * d + c];
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = qlo + warp * RPW + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = t0 + lane + 32 * j;
        bool ok = kpos < valid_lk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[r][j] = ok ? s[r][j] * scale : NEG;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      ps[(warp * RPW + r) * BK + lane] = p0;
      ps[(warp * RPW + r) * BK + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < DSLOTS; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    for (int j = 0; j < BK; ++j) {
      float vv[DSLOTS];
#pragma unroll
      for (int c = 0; c < DSLOTS; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < d ? vs[j * d + col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = ps[(warp * RPW + r) * BK + j];
#pragma unroll
        for (int c = 0; c < DSLOTS; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DSLOTS; ++c) {
      const int col = lane + 32 * c;
      if (col < d)
        o[((size_t)bh * lq + row) * d + col] = acc[r][c] / denom;
    }
  }
}

// ---- bf16: tensor cores ------------------------------------------------

#define FBQ 64          // query rows per block, 16 per warp
#define FBK 64          // keys per tile
#define FTHREADS 128
#define LOG2E 1.4426950408889634f

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
static size_t smem_bytes_bf16() {
  return sizeof(__nv_bfloat16) * (size_t)(FBQ + 4 * FBK) * (DP + 8);
}

// rows [row0, row0 + 64) of a (rows, d) bf16 matrix into a 64 x DP shared
// tile of row stride DP + 8, asynchronously; rows >= n_rows and columns
// >= d are zero-filled
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n_rows, int d) {
  constexpr int CPR = DP / 8, LD = DP + 8;
  for (int i = threadIdx.x; i < 64 * CPR; i += FTHREADS) {
    const int r = i / CPR, c = (i - r * CPR) * 8;
    const bool ok = row0 + r < n_rows && c < d;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)(row0 + r) * d + c : src,
               ok ? 16 : 0);
  }
}

// up to D 80, 128 registers a thread let 4 blocks (16 warps) share an SM
template <int DP>
__global__ void __launch_bounds__(FTHREADS, DP <= 80 ? 4 : 2)
    flash_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int hq, int rep, int lq,
                      int lk, int d, int q_offset, int valid_lk, int causal,
                      int window, float scale_log2) {
  constexpr int LD = DP + 8, KS = DP / 16, NB = DP / 8;
  extern __shared__ __align__(16) unsigned char fsm[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fsm);  // FBQ x LD
  __nv_bfloat16* ks = qs + FBQ * LD;                          // 2 x FBK x LD
  __nv_bfloat16* vs = ks + 2 * FBK * LD;                      // 2 x FBK x LD
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * FBQ;
  const int hkv = hq / rep;
  const size_t kvh = (size_t)(bh / hq) * hkv + (bh % hq) / rep;
  const __nv_bfloat16* qp = q + (size_t)bh * lq * d;
  const __nv_bfloat16* kp = k + kvh * lk * d;
  const __nv_bfloat16* vp = v + kvh * lk * d;

  // keys any row of this block can attend
  const int rows = min(FBQ, lq - q0);
  const int qlo = q_offset + q0, qhi = qlo + rows - 1;
  int kend = valid_lk;
  if (causal) kend = min(kend, qhi + 1);
  const int kfirst = (window > 0 ? max(0, qlo - window + 1) : 0) / FBK * FBK;
  const int n_tiles = kend > kfirst ? (kend - kfirst + FBK - 1) / FBK : 0;

  load_tile<DP>(qs, qp, q0, lq, d);
  if (n_tiles > 0) {
    load_tile<DP>(ks, kp, kfirst, lk, d);
    load_tile<DP>(vs, vp, kfirst, lk, d);
  }
  cp_async_commit();

  // this lane's two rows: g and g + 8 of the warp's 16
  const int pos_a = qlo + warp * 16 + g, pos_b = pos_a + 8;
  uint32_t qf[KS][4];
  float acc[NB][4];
  zero_frags(acc);
  float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f;  // m in log2 units

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kfirst + it * FBK, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    if (it + 1 < n_tiles) {
      load_tile<DP>(ks + (buf ^ 1) * FBK * LD, kp, t0 + FBK, lk, d);
      load_tile<DP>(vs + (buf ^ 1) * FBK * LD, vp, t0 + FBK, lk, d);
      cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
    }
    const __nv_bfloat16* kb = ks + buf * FBK * LD;
    const __nv_bfloat16* vb = vs + buf * FBK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-blocks of 8 keys
    float s[8][4];
    zero_frags(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t b[4];
        ldsm_x4(b, kb + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[nb], qf[kk], b[0], b[1]);
        mma_bf16(s[nb + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale into log2 units and mask, unless no row or key of the block
    // is masked in this tile
    const bool full = t0 + FBK <= valid_lk &&
                      (!causal || t0 + FBK - 1 <= qlo) &&
                      (window <= 0 || qhi - t0 < window);
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (!full) {
          const int kpos = t0 + nb * 8 + 2 * tg + (e & 1);
          const int qpos = e < 2 ? pos_a : pos_b;
          bool ok = kpos < valid_lk;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          x = ok ? x : NEG;
        }
        s[nb][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nb][0], s[nb][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nb][2], s[nb][3]));
    }
    // the four lanes of a quad hold one row
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;  // this lane's part of the row sums
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      s[nb][0] = ex2(s[nb][0] - mn_a);
      s[nb][1] = ex2(s[nb][1] - mn_a);
      s[nb][2] = ex2(s[nb][2] - mn_b);
      s[nb][3] = ex2(s[nb][3] - mn_b);
      ps_a += s[nb][0] + s[nb][1];
      ps_b += s[nb][2] + s[nb][3];
    }
    l_a = al_a * l_a + ps_a;
    l_b = al_b * l_b + ps_b;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      acc[nb][0] *= al_a;
      acc[nb][1] *= al_a;
      acc[nb][2] *= al_b;
      acc[nb][3] *= al_b;
    }

    // O += P V: P's C fragments rounded to bf16 are the A fragments,
    // 16 keys per k-step; V (keys x D) read transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         nb * 8 + (lane >> 4) * 8);
        mma_bf16(acc[nb], pa, b[0], b[1]);
        mma_bf16(acc[nb + 1], pa, b[2], b[3]);
      }
    }
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int col = nb * 8 + 2 * tg;
    if (col >= d) continue;
    if (row_a < lq)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * lq + row_a) * d +
                                         col) =
          __floats2bfloat162_rn(acc[nb][0] * inv_a, acc[nb][1] * inv_a);
    if (row_b < lq)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * lq + row_b) * d +
                                         col) =
          __floats2bfloat162_rn(acc[nb][2] * inv_b, acc[nb][3] * inv_b);
  }
}

template <int DP>
static int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       int bh, int hq, int rep, int lq, int lk, int d,
                       int q_offset, int valid_lk, int causal, int window,
                       float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (lq + FBQ - 1) / FBQ);
  flash_kernel_bf16<DP><<<grid, FTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      hq, rep, lq, lk, d, q_offset, valid_lk, causal, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// ---- float32: CUDA cores -------------------------------------------------

static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      int bh, int hq, int rep, int lq, int lk, int d,
                      int q_offset, int valid_lk, int causal, int window,
                      float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (lq + BQ - 1) / BQ);
  flash_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, rep, lq, lk,
      d, q_offset, valid_lk, causal, window, scale);
  return (int)cudaGetLastError();
}

// q (bh, lq, d), k/v (bh / rep, lk, d), o like q; bf16 != 0 means
// __nv_bfloat16 operands, else float32. window <= 0 means none; scale is
// D^-1/2 as the caller rounds it. d must be a multiple of 8 and at most 128
// and, for bf16, the pointers 16-byte aligned (checked by the wrapper).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int bh, int hq, int rep, int lq,
                               int lk, int d, int q_offset, int valid_lk,
                               int causal, int window, float scale, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch_f32(q, k, v, o, bh, hq, rep, lq, lk, d, q_offset, valid_lk,
                      causal, window, scale, s);
#define FLASH_BF16(DP)                                                      \
  if (d <= DP)                                                              \
    return launch_bf16<DP>(q, k, v, o, bh, hq, rep, lq, lk, d, q_offset,    \
                           valid_lk, causal, window, scale, s);
  FLASH_BF16(16)
  FLASH_BF16(32)
  FLASH_BF16(64)
  FLASH_BF16(80)
  FLASH_BF16(96)
  FLASH_BF16(128)
#undef FLASH_BF16
  return (int)cudaErrorInvalidValue;
}
