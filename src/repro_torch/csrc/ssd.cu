// Mamba2 SSD (state-space duality) scan, one (batch, head) per block.
//
// Replaces the TPU kernel `ssd_pallas` / `_ssd_kernel`
// (src/repro/kernels/ssd/ssd.py). For one head h with A_h < 0, dt >= 0,
// B and C shared across heads, it computes the output of the recurrence
//   S_t = exp(A_h dt_t) S_{t-1} + dt_t x_t (x) B_t,   y_t = C_t . S_t + D_h x_t
// in the chunked dual form. Per tile of TQ = 64 steps, with
// cum = cumsum(A_h dt):
//   y_intra = ((C B^T) o M) (dt x),  M_ij = exp(cum_i - cum_j) for i >= j
//             (masked BEFORE the exp: for i < j the exponent is positive);
//   y_inter = exp(cum) o (C S^T);
//   S       = exp(cum_last) S + (exp(cum_last - cum) o dt x)^T B.
// The in-tile cumsum is float64: at Zamba2's decays (A dt down to -48) a
// float32 cum_i - cum_j loses ~eps |cum| to cancellation, |cum| reaching
// the thousands in a tile, which moves y past the 2e-4 bar once |y| is in
// the hundreds; in float64 the exponents are exact to float32.
//
// The TPU walked chunks as the innermost, sequential grid axis with the
// (P, N) state in VMEM scratch. Here one block owns one (batch, head) and
// walks the sequence in a loop over tiles of 64 steps; the dual form is
// exact for any tile length (the chunk only moves rounding). Steps past L
// (the ragged tail) are dt = 0 steps: they neither decay nor inject
// state, and their y is not written.
//
// What bounds it on the H100: at Zamba2's prefill (B = 8, L = 512, H = 80,
// P = N = 64, bf16) the kernel moves ~88 MB (x and y dominate): 0.026 ms
// at 3.35 TB/s. Its dual-form products (~2.1 MFLOP per tile and head)
// are ~11 GFLOP, 0.011 ms on the bf16 tensor cores, so bytes bound the
// function. Two designs, by input type:
//
// bf16 (the LM path): `ssd_kernel_bf16`. The four tile products run on the
// tensor cores (mma.sync m16n8k16, float32 accumulate), each arranged so
// that one operand is an exact bf16 input:
//   C B^T          C and B exact: one pass;
//   (G o dt_j) x   G = (C B^T) o M with dt on its columns, x exact;
//   C S^T          C exact, S the float32 state;
//   x^T (w o B)    x exact, w = exp(total - cum) dt on B's rows.
// The float32 operand of the last three goes in as a hi + lo bf16 pair
// (two passes, ~2^-17 relative), so a product is as good as a float32
// one to well under a bf16 ulp of y. Each of the 4 warps owns 16 rows of
// the tile (the first three products; the causal mask skips the n-blocks
// above the diagonal) and 16 rows of the state, which stays float32 in
// its registers across the whole walk; its hi/lo bf16 copy in shared
// memory is C S^T's operand. The next tile's x, B, C and dt are fetched
// by cp.async while this tile computes; shared rows are padded by 8
// elements, an odd number of 16-byte units, so ldmatrix is free of bank
// conflicts. w o B is built in registers from B's ldmatrix.trans
// fragments, so the shared tiles are x, B, C (double-buffered) and the
// state's hi/lo copy: 75 KB at P = N = 64, 3 blocks per SM. P and N are
// zero-padded in shared memory to the next instantiated width (P 16, 32,
// 64; N 32, 64, 128), which is exact.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: 0.142
// ms of device time per launch inside a Zamba2 prefill, 5.5x its byte
// bound. What holds it there is the latency of each tile's chain — three
// block barriers, the float64 cumsum on one warp, an exp per element of
// the decay mask, the hi + lo passes — walked 8 times by each of 640
// blocks in 2 waves; at batch 1 only 80 blocks run, so a 4,096-step
// prompt takes ~0.5 ms whatever the bytes.
//
// float32: `ssd_kernel`, the CUDA-core design of the first port. Its
// 2e-4 bar against the recurrence at |y| ~ 200 is beyond TF32's ~1e-3,
// so its products stay float32 FFMA from shared memory (4 x 4 or 4 x 8
// register tiles, rows of B, C and the state padded to N + 1 floats),
// bound by the FFMA rate and the barriers between the phases of each tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

#define TQ 64
#define THREADS 256
#define MAX_P 64
#define MAX_N 128

static size_t smem_bytes(int p, int n) {
  const size_t nk = n + 1;
  return sizeof(double) * TQ                     // cum
         + sizeof(float) * (2 * TQ * nk          // B, C tiles
                            + TQ * (TQ + 1)      // decay-masked C B^T
                            + (size_t)TQ * p     // dt x
                            + (size_t)p * nk     // state
                            + 3 * TQ);           // dt, exp(cum), exp(tot - cum)
}

__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ dskip,
               float* __restrict__ y, int L, int H, int P, int N) {
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
      bs[j * nk + n] = j < q ? bm[off] : 0.0f;
      cs[j * nk + n] = j < q ? cm[off] : 0.0f;
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
      xd[i] = j < q ? x[((size_t)b * L + t0 + j) * xrow + (size_t)h * P + p] *
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
          y[row + p] = out + dh * x[row + p];
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

// ---- bf16: tensor cores ------------------------------------------------

#define STHREADS 128

template <int PP, int NP>
struct SsdSmem {
  static constexpr int LX = PP + 8, LN = NP + 8;
  static constexpr size_t cum = 0;                         // double[TQ]
  static constexpr size_t ecum = cum + 8 * TQ;             // float[TQ]
  static constexpr size_t wj = ecum + 4 * TQ;              // float[TQ]
  static constexpr size_t dts = wj + 4 * TQ;               // float[2][TQ]
  static constexpr size_t xs = dts + 8 * TQ;               // bf16[2][TQ][LX]
  static constexpr size_t bs = xs + 2 * 2 * TQ * LX;       // bf16[2][TQ][LN]
  static constexpr size_t cs = bs + 2 * 2 * TQ * LN;       // bf16[2][TQ][LN]
  static constexpr size_t st = cs + 2 * 2 * TQ * LN;       // bf16[2][PP][LN]
  static constexpr size_t bytes = st + 2 * 2 * PP * LN;
};

// tile rows [t0, t0 + TQ) of x (this head's P columns), B, C and dt into
// buffer `buf`, asynchronously; steps >= L and padded columns are zeros
template <int PP, int NP>
__device__ __forceinline__ void load_ssd_tile(
    unsigned char* sm, int buf, const __nv_bfloat16* x, const float* dt,
    const __nv_bfloat16* bm, const __nv_bfloat16* cm, int b, int h, int t0,
    int L, int H, int P, int N) {
  using S = SsdSmem<PP, NP>;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sm + S::xs) +
                      buf * TQ * S::LX;
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(sm + S::bs) +
                      buf * TQ * S::LN;
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(sm + S::cs) +
                      buf * TQ * S::LN;
  float* dts = reinterpret_cast<float*>(sm + S::dts) + buf * TQ;
  const int tid = threadIdx.x;
  constexpr int XC = PP / 8, NC = NP / 8;
  for (int i = tid; i < TQ * XC; i += STHREADS) {
    const int j = i / XC, c = (i - j * XC) * 8;
    const bool ok = t0 + j < L && c < P;
    cp_async16(xs + j * S::LX + c,
               ok ? x + (((size_t)b * L + t0 + j) * H + h) * P + c : x,
               ok ? 16 : 0);
  }
  for (int i = tid; i < TQ * NC; i += STHREADS) {
    const int j = i / NC, c = (i - j * NC) * 8;
    const bool ok = t0 + j < L && c < N;
    const size_t off = ((size_t)b * L + t0 + j) * N + c;
    cp_async16(bs + j * S::LN + c, ok ? bm + off : bm, ok ? 16 : 0);
    cp_async16(cs + j * S::LN + c, ok ? cm + off : cm, ok ? 16 : 0);
  }
  if (tid < TQ) {
    const bool ok = t0 + tid < L;
    cp_async4(dts + tid, ok ? dt + ((size_t)b * L + t0 + tid) * H + h : dt,
              ok ? 4 : 0);
  }
}

// w o B for one B fragment register (two bf16 of B, steps with weights
// w_lo, w_hi), as hi + lo bf16
__device__ __forceinline__ void scale_split(uint32_t b, float w_lo,
                                            float w_hi, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  split_bf16(v.x * w_lo, v.y * w_hi, hi, lo);
}

template <int PP, int NP>
__global__ void __launch_bounds__(STHREADS)
    ssd_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    const __nv_bfloat16* __restrict__ bm,
                    const __nv_bfloat16* __restrict__ cm,
                    const float* __restrict__ dskip,
                    __nv_bfloat16* __restrict__ y, int L, int H, int P,
                    int N) {
  using S = SsdSmem<PP, NP>;
  constexpr int LX = S::LX, LN = S::LN, PB = PP / 8, NB = NP / 8;
  extern __shared__ __align__(16) unsigned char tsm[];
  double* cum = reinterpret_cast<double*>(tsm + S::cum);
  float* ecum = reinterpret_cast<float*>(tsm + S::ecum);
  float* wj = reinterpret_cast<float*>(tsm + S::wj);
  __nv_bfloat16* sth = reinterpret_cast<__nv_bfloat16*>(tsm + S::st);
  __nv_bfloat16* stl = sth + PP * LN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float ah = a[h], dh = dskip[h];
  const int i0 = warp * 16;            // this warp's tile rows and state rows
  const bool owns_state = i0 < PP;

  for (int i = tid; i < 2 * PP * LN / 2; i += STHREADS)
    reinterpret_cast<uint32_t*>(sth)[i] = 0u;
  load_ssd_tile<PP, NP>(tsm, 0, x, dt, bm, cm, b, h, 0, L, H, P, N);
  cp_async_commit();

  // the float32 state, rows i0 + g (+ 8), columns 8 nb + 2 tg (+ 1)
  float st[NB][4];
  zero_frags(st);

  const int n_tiles = (L + TQ - 1) / TQ;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * TQ, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    if (it + 1 < n_tiles) {
      load_ssd_tile<PP, NP>(tsm, buf ^ 1, x, dt, bm, cm, b, h, t0 + TQ, L, H,
                            P, N);
      cp_async_commit();
    }
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(tsm + S::xs) + buf * TQ * LX;
    const __nv_bfloat16* bs =
        reinterpret_cast<const __nv_bfloat16*>(tsm + S::bs) + buf * TQ * LN;
    const __nv_bfloat16* cs =
        reinterpret_cast<const __nv_bfloat16*>(tsm + S::cs) + buf * TQ * LN;
    const float* dts = reinterpret_cast<const float*>(tsm + S::dts) + buf * TQ;

    // warp 0: cum = inclusive cumsum of A_h dt (float64), exp(cum) and
    // w = exp(total - cum) dt; a lane owns steps 2 lane and 2 lane + 1
    if (warp == 0) {
      const float d0 = dts[2 * lane], d1 = dts[2 * lane + 1];
      const double v0 = (double)(ah * d0), v1 = v0 + (double)(ah * d1);
      double sc = v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, sc, off);
        if (lane >= off) sc += u;
      }
      const double c0 = sc - v1 + v0, c1 = sc;
      const double total = __shfl_sync(0xffffffffu, sc, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ecum[2 * lane] = expf((float)c0);
      ecum[2 * lane + 1] = expf((float)c1);
      wj[2 * lane] = expf((float)(total - c0)) * d0;
      wj[2 * lane + 1] = expf((float)(total - c1)) * d1;
    }

    // G = C B^T for this warp's 16 rows, the n-blocks at or below the
    // diagonal (j <= i0 + 15)
    float gm[8][4];
    zero_frags(gm);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, cs + (i0 + (lane & 15)) * LN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        if (nb > 2 * warp) break;
        uint32_t bf[4];
        ldsm_x4(bf, bs + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LN +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(gm[nb], af, bf[0], bf[1]);
        mma_bf16(gm[nb + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();  // cum, exp(cum), w are in

    // y = exp(cum) o (C S^T) + (G o M o dt_j) x, 16 rows x PP per warp
    const int ia = i0 + g, ib = ia + 8;
    float yacc[PB][4];
    zero_frags(yacc);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, cs + (i0 + (lane & 15)) * LN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int pb = 0; pb < PB; pb += 2) {
        const int off = (pb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LN +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bh_[4], bl_[4];
        ldsm_x4(bh_, sth + off);
        ldsm_x4(bl_, stl + off);
        mma_bf16(yacc[pb], af, bh_[0], bh_[1]);
        mma_bf16(yacc[pb + 1], af, bh_[2], bh_[3]);
        mma_bf16(yacc[pb], af, bl_[0], bl_[1]);
        mma_bf16(yacc[pb + 1], af, bl_[2], bl_[3]);
      }
    }
    {
      const float ea = ecum[ia], eb = ecum[ib];
#pragma unroll
      for (int pb = 0; pb < PB; ++pb) {
        yacc[pb][0] *= ea;
        yacc[pb][1] *= ea;
        yacc[pb][2] *= eb;
        yacc[pb][3] *= eb;
      }
    }
    const double ca = cum[ia], cb = cum[ib];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) break;
      // G o M o dt_j over columns 16 kk .. 16 kk + 15, as hi and lo A
      // fragments (zero above the diagonal)
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb = 2 * kk + half;
        const int j = nb * 8 + 2 * tg;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = j + (e & 1), ii = e < 2 ? ia : ib;
          const double ci = e < 2 ? ca : cb;
          v[e] = jj <= ii ? gm[nb][e] * expf((float)(ci - cum[jj])) * dts[jj]
                          : 0.0f;
        }
        split_bf16(v[0], v[1], ahi[2 * half], alo[2 * half]);
        split_bf16(v[2], v[3], ahi[2 * half + 1], alo[2 * half + 1]);
      }
#pragma unroll
      for (int pb = 0; pb < PB; pb += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, xs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LX +
                          pb * 8 + (lane >> 4) * 8);
        mma_bf16(yacc[pb], ahi, bf[0], bf[1]);
        mma_bf16(yacc[pb + 1], ahi, bf[2], bf[3]);
        mma_bf16(yacc[pb], alo, bf[0], bf[1]);
        mma_bf16(yacc[pb + 1], alo, bf[2], bf[3]);
      }
    }
    // + D_h x, written for the steps < L and the columns < P
#pragma unroll
    for (int pb = 0; pb < PB; ++pb) {
      const int p = pb * 8 + 2 * tg;
      if (p >= P) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? ib : ia;
        if (t0 + i >= L) continue;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + i * LX + p));
        *reinterpret_cast<__nv_bfloat162*>(
            y + (((size_t)b * L + t0 + i) * H + h) * P + p) =
            __floats2bfloat162_rn(yacc[pb][2 * r] + dh * xv.x,
                                  yacc[pb][2 * r + 1] + dh * xv.y);
      }
    }
    __syncthreads();  // every read of the old state is done

    // S = exp(total) S + x^T (w o B): this warp's 16 state rows
    if (owns_state) {
      const float decay = expf((float)cum[TQ - 1]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        st[nb][0] *= decay;
        st[nb][1] *= decay;
        st[nb][2] *= decay;
        st[nb][3] *= decay;
      }
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4_t(af, xs + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LX +
                          i0 + ((lane >> 3) & 1) * 8);
        // B's fragments hold steps j, j + 1 (b[0]) and j + 8, j + 9 (b[1])
        const int j = kk * 16 + 2 * tg;
        const float w0 = wj[j], w1 = wj[j + 1], w8 = wj[j + 8],
                    w9 = wj[j + 9];
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          uint32_t bf[4], hi[4], lo[4];
          ldsm_x4_t(bf, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LN +
                            nb * 8 + (lane >> 4) * 8);
          scale_split(bf[0], w0, w1, hi[0], lo[0]);
          scale_split(bf[1], w8, w9, hi[1], lo[1]);
          scale_split(bf[2], w0, w1, hi[2], lo[2]);
          scale_split(bf[3], w8, w9, hi[3], lo[3]);
          mma_bf16(st[nb], af, hi[0], hi[1]);
          mma_bf16(st[nb + 1], af, hi[2], hi[3]);
          mma_bf16(st[nb], af, lo[0], lo[1]);
          mma_bf16(st[nb + 1], af, lo[2], lo[3]);
        }
      }
      // its hi/lo copy for the next tile's C S^T
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int n = nb * 8 + 2 * tg;
        uint32_t hi, lo;
        split_bf16(st[nb][0], st[nb][1], hi, lo);
        *reinterpret_cast<uint32_t*>(sth + (i0 + g) * LN + n) = hi;
        *reinterpret_cast<uint32_t*>(stl + (i0 + g) * LN + n) = lo;
        split_bf16(st[nb][2], st[nb][3], hi, lo);
        *reinterpret_cast<uint32_t*>(sth + (i0 + g + 8) * LN + n) = hi;
        *reinterpret_cast<uint32_t*>(stl + (i0 + g + 8) * LN + n) = lo;
      }
    }
  }
}

template <int PP, int NP>
static int launch_bf16(const void* x, const void* dt, const void* a,
                       const void* b, const void* c, const void* d, void* y,
                       int batch, int L, int H, int P, int N,
                       cudaStream_t stream) {
  const size_t smem = SsdSmem<PP, NP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel_bf16<PP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel_bf16<PP, NP><<<batch * H, STHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<const float*>(d),
      static_cast<__nv_bfloat16*>(y), L, H, P, N);
  return (int)cudaGetLastError();
}

template <int PP>
static int launch_bf16_n(const void* x, const void* dt, const void* a,
                         const void* b, const void* c, const void* d, void* y,
                         int batch, int L, int H, int P, int N,
                         cudaStream_t s) {
  if (N <= 32)
    return launch_bf16<PP, 32>(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
  if (N <= 64)
    return launch_bf16<PP, 64>(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
  return launch_bf16<PP, 128>(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
}

// ---- float32: CUDA cores -------------------------------------------------

static int launch_f32(const void* x, const void* dt, const void* a,
                      const void* b, const void* c, const void* d, void* y,
                      int batch, int L, int H, int P, int N,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<<<batch * H, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(d),
      static_cast<float*>(y), L, H, P, N);
  return (int)cudaGetLastError();
}

// x, y (batch, L, H, P); dt (batch, L, H) float32; a, d (H,) float32;
// b, c (batch, L, N). x, b, c, y are bf16 when bf16 != 0, else float32.
// P <= 64 and N <= 128; for bf16 also P and N multiples of 8 and the
// pointers 16-byte aligned (the wrapper pads and checks).
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, const void* d, void* y,
                        int batch, int L, int H, int P, int N, int bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch_f32(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
  if (P <= 16)
    return launch_bf16_n<16>(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
  if (P <= 32)
    return launch_bf16_n<32>(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
  return launch_bf16_n<64>(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
}
