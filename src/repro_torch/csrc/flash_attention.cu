// Prefill attention with an online softmax: causal or not, an optional
// sliding window, queries aligned to the end of the valid keys.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py). Per query row i
// (position q_offset + i) and key j it computes
//   s_ij = (q_i . k_j) * D^-1/2, masked to NEG where j >= valid_lk,
//          (causal) q_offset + i < j, or (window) q_offset + i - j >= window;
//   o_i  = sum_j softmax_j(s_ij) v_j,
// in float32 whatever the input type, written back in the input type.
//
// Layout: q (B*Hq, Lq, D), k and v (B*Hkv, Lk, D), Hq = rep * Hkv: query
// head h reads kv head h / rep, so GQA never materializes repeated keys.
//
// Design. One block per (batch-head, 64-query tile); the TPU's sequential
// kv grid axis becomes a loop inside the block over 64-key tiles, which
// carries the running max m, running sum l and the float32 accumulator in
// registers. Each of the 8 warps owns 8 query rows: a lane scores keys
// `lane` and `lane + 32` of the tile (the key tile is padded to D + 1
// floats a row, so the 32 lanes read 32 banks), row max and sum are warp
// shuffles, and for P.V a lane owns output columns lane + 32c. Tiles that
// are masked for every row of the block (beyond the causal diagonal or
// before the window) are skipped; a row's skipped tiles are ones the
// reference would discard with alpha = exp(NEG - m) = 0.
//
// The masking value is the finite NEG = -1e30 of the reference: with -inf
// a row whose first kv tile is wholly masked (a sliding window) would give
// exp(-inf - -inf) = NaN.
//
// What bounds it on the H100: at Zamba2's prefill (B*Hq = 256, L = 512,
// D = 80, causal) the function needs ~10.8 GFLOP against ~84 MB of q, k,
// v and o: 0.025 ms at 3.35 TB/s, 0.011 ms on the bf16 tensor cores, so
// bytes bound it. This simple kernel does its products on the CUDA cores
// in float32 from shared memory, so it is bound by shared-memory issue
// and FFMA throughput instead; the tensor-core version (wgmma on bf16
// tiles) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define BQ 64
#define BK 64
#define THREADS 256
#define N_WARPS (THREADS / 32)
#define RPW (BQ / N_WARPS)  // query rows per warp
#define MAX_D 128
#define DSLOTS (MAX_D / 32)
#define NEG (-1e30f)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int rep,
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
  const T* qp = q + (size_t)bh * lq * d;
  const T* kp = k + kvh * lk * d;
  const T* vp = v + kvh * lk * d;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    qs[i] = q0 + r < lq ? to_f(qp[(size_t)(q0 + r) * d + c]) : 0.0f;
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
        kv = to_f(kp[(size_t)key * d + c]);
        vv = to_f(vp[(size_t)key * d + c]);
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
        o[((size_t)bh * lq + row) * d + col] = from_f<T>(acc[r][c] / denom);
    }
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int bh, int hq, int rep, int lq, int lk, int d,
                  int q_offset, int valid_lk, int causal, int window,
                  float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (lq + BQ - 1) / BQ);
  flash_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, rep, lq, lk, d,
      q_offset, valid_lk, causal, window, scale);
  return (int)cudaGetLastError();
}

// q (bh, lq, d), k/v (bh / rep, lk, d), o like q; bf16 != 0 means
// __nv_bfloat16 operands, else float32. window <= 0 means none; scale is
// D^-1/2 as the caller rounds it. d must be a multiple of 8 and at most 128
// (checked by the wrapper).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int bh, int hq, int rep, int lq,
                               int lk, int d, int q_offset, int valid_lk,
                               int causal, int window, float scale, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, bh, hq, rep, lq, lk, d,
                                 q_offset, valid_lk, causal, window, scale,
                                 s);
  return launch<float>(q, k, v, o, bh, hq, rep, lq, lk, d, q_offset,
                       valid_lk, causal, window, scale, s);
}
