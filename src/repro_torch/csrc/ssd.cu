// Mamba2 SSD (state-space duality) scan, one (batch, head) per block.
//
// Replaces the TPU kernel `ssd_pallas` / `_ssd_kernel`
// (src/repro/kernels/ssd/ssd.py). For one head h with A_h < 0, dt >= 0,
// B and C shared across heads, it computes the output of the recurrence
//   S_t = exp(A_h dt_t) S_{t-1} + dt_t x_t (x) B_t,   y_t = C_t . S_t + D_h x_t
// in the chunked dual form. Per tile of TQ steps, with cum = cumsum(A_h dt):
//   y_intra = ((C B^T) o M) (dt x),  M_ij = exp(cum_i - cum_j) for i >= j
//             (masked BEFORE the exp: for i < j the exponent is positive);
//   y_inter = exp(cum) o (C S^T);
//   S       = exp(cum_last) S + (exp(cum_last - cum) o dt x)^T B.
// The products are float32; x, B, C and y are float32 or bf16 together.
// The in-tile cumsum is float64: at Zamba2's decays (A dt down to -48) a
// float32 cum_i - cum_j loses ~eps |cum| to cancellation, |cum| reaching
// the thousands in a tile, which moves y past the 2e-4 bar once |y| is in
// the hundreds; in float64 the exponents are exact to float32.
//
// Design. The TPU walked chunks as the innermost, sequential grid axis with
// the (P, N) state in VMEM scratch. Here one block owns one (batch, head)
// and walks the sequence in a loop over tiles of TQ = 64 steps, with the
// state in shared memory. The dual form is exact for any tile length (the
// chunk only moves rounding), and 64 rather than the TPU's 128 keeps the
// tile's B, C, dt x, the (TQ, TQ) decay-masked scores and the state in
// shared memory (84 KB at N = P = 64, 134 KB at N = 128), so that only x,
// dt, B, C and y touch device memory. Each (TQ, TQ), (TQ, P) and (P, N)
// product gives each of the 256 threads a 4 x 4 (or 4 x 8) register tile;
// rows of B, C and the state are padded to N + 1 floats so the 16 threads
// of a half-warp read 16 banks. C B^T is recomputed per head, as on the
// TPU. Steps past L (the ragged tail) are dt = 0 steps: they neither decay
// nor inject state, and their y is not written.
//
// What bounds it on the H100: at Zamba2's prefill (B = 8, L = 512, H = 80,
// P = N = 64, bf16) the kernel moves ~88 MB (x and y dominate): 0.026 ms
// at 3.35 TB/s. Its dual-form products (~2.1 MFLOP per tile and head) are
// ~11 GFLOP, 0.011 ms on the bf16 tensor cores, so bytes bound the
// function. This simple kernel runs the products in float32 on the CUDA
// cores from shared memory, with a block barrier between the phases of
// each tile, so FFMA issue and barrier latency bound it instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define TQ 64
#define THREADS 256
#define MAX_P 64
#define MAX_N 128

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

static size_t smem_bytes(int p, int n) {
  const size_t nk = n + 1;
  return sizeof(double) * TQ                     // cum
         + sizeof(float) * (2 * TQ * nk          // B, C tiles
                            + TQ * (TQ + 1)      // decay-masked C B^T
                            + (size_t)TQ * p     // dt x
                            + (size_t)p * nk     // state
                            + 3 * TQ);           // dt, exp(cum), exp(tot - cum)
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dskip,
               T* __restrict__ y, int L, int H, int P, int N) {
  extern __shared__ double sm[];
  const int nk = N + 1, gk = TQ + 1;
  double* cum = sm;             // TQ: inclusive cumsum of A_h dt
  float* bs = reinterpret_cast<float*>(cum + TQ);  // TQ x (N + 1)
  float* cs = bs + TQ * nk;     // TQ x (N + 1)
  float* g = cs + TQ * nk;      // TQ x (TQ + 1)
  float* xd = g + TQ * gk;      // TQ x P: dt * x
  float* st = xd + TQ * P;      // P x (N + 1): the carried state
  float* dts = st + P * nk;     // TQ
  float* ecum = dts + TQ;       // TQ: exp(cum)
  float* eout = ecum + TQ;      // TQ: exp(cum_last - cum)
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float ah = a[h], dh = dskip[h];
  const size_t xrow = (size_t)H * P;   // x and y stride along L
  // register-tile coordinates: 16 x 16 threads, 4 (or 8) strided items each
  const int ti = tid >> 4, tj = tid & 15;

  for (int i = tid; i < P * nk; i += THREADS) st[i] = 0.0f;

  for (int t0 = 0; t0 < L; t0 += TQ) {
    const int q = min(TQ, L - t0);
    __syncthreads();  // the previous tile is done with every buffer

    // cum = inclusive cumsum of A_h dt over the tile (two warps)
    if (tid < TQ) {
      const float d = tid < q ? dt[((size_t)b * L + t0 + tid) * H + h] : 0.0f;
      double v = ah * d;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      dts[tid] = d;
      cum[tid] = v;
    }
    for (int i = tid; i < TQ * N; i += THREADS) {
      const int j = i / N, n = i - j * N;
      const size_t off = ((size_t)b * L + t0 + j) * N + n;
      bs[j * nk + n] = j < q ? to_f(bm[off]) : 0.0f;
      cs[j * nk + n] = j < q ? to_f(cm[off]) : 0.0f;
    }
    __syncthreads();
    if (tid >= 32 && tid < TQ) cum[tid] += cum[31];
    __syncthreads();
    const double total = cum[TQ - 1];
    if (tid < TQ) {
      ecum[tid] = expf((float)cum[tid]);
      eout[tid] = expf((float)(total - cum[tid]));
    }
    for (int i = tid; i < TQ * P; i += THREADS) {
      const int j = i / P, p = i - j * P;
      xd[i] = j < q ? to_f(x[((size_t)b * L + t0 + j) * xrow + (size_t)h * P +
                             p]) *
                          dts[j]
                    : 0.0f;
    }

    // g = (C B^T) o M, lower triangle
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + 16 * r) * nk + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[(tj + 16 * c) * nk + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          g[i * gk + j] =
              i >= j ? acc[r][c] * expf((float)(cum[i] - cum[j])) : 0.0f;
        }
    }
    __syncthreads();

    // y = g (dt x) + exp(cum) o (C S^T) + D_h x, rows ti + 16r, cols tj + 16c
    {
      float yi[4][4] = {}, ys[4][4] = {};
      for (int j = 0; j < TQ; ++j) {
        float gv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = g[(ti + 16 * r) * gk + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tj + 16 * c;
          xv[c] = p < P ? xd[j * P + p] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) yi[r][c] = fmaf(gv[r], xv[c], yi[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + 16 * r) * nk + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tj + 16 * c;
          sv[c] = p < P ? st[p * nk + n] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) ys[r][c] = fmaf(cv[r], sv[c], ys[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i >= q) continue;
        const size_t row = ((size_t)b * L + t0 + i) * xrow + (size_t)h * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tj + 16 * c;
          if (p >= P) continue;
          const float out = yi[r][c] + ecum[i] * ys[r][c];
          y[row + p] = from_f<T>(out + dh * to_f(x[row + p]));
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S = exp(total) S + (exp(total - cum) o dt x)^T B; rows ti + 16r of
    // P, columns tj + 16c of N
    {
      float acc[4][8] = {};
      for (int j = 0; j < TQ; ++j) {
        float wv[4], bv[8];
        const float e = eout[j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = ti + 16 * r;
          wv[r] = p < P ? e * xd[j * P + p] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = tj + 16 * c;
          bv[c] = n < N ? bs[j * nk + n] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv[r], bv[c], acc[r][c]);
      }
      const float decay = expf((float)total);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = ti + 16 * r;
        if (p >= P) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = tj + 16 * c;
          if (n < N) st[p * nk + n] = decay * st[p * nk + n] + acc[r][c];
        }
      }
    }
  }
}

template <typename T>
static int launch(const void* x, const void* dt, const void* a,
                  const void* b, const void* c, const void* d, void* y,
                  int batch, int L, int H, int P, int N,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<batch * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<T*>(y), L, H, P, N);
  return (int)cudaGetLastError();
}

// x, y (batch, L, H, P); dt (batch, L, H) float32; a, d (H,) float32;
// b, c (batch, L, N). x, b, c, y are bf16 when bf16 != 0, else float32.
// P <= 64 and N <= 128 (checked by the wrapper).
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, const void* d, void* y,
                        int batch, int L, int H, int P, int N, int bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
  return launch<float>(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
}
